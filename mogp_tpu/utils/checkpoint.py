"""Checkpoint / resume for emulators and long-running inference.

The reference's only persistence is ``SequentialDesign.save_design``
(``SequentialDesign.py:110-186``) and pickling-by-reinit for the GPU
class.  For a framework running long NUTS/SMC sweeps on preemptible
machines, first-class checkpointing matters (SURVEY §5): this module
provides simple, dependency-free ``.npz`` checkpoints for

* ``GaussianProcess`` / ``MultiOutputGP`` — data + configuration +
  hyperparameters; loading re-fits the cached artifacts on device.
* ``MCMCResult`` — posterior samples and diagnostics.
* SMC particle populations — ``save_smc``/``load_smc``, written after
  every anneal stage by ``smc_history_match(checkpoint_path=...)`` so a
  preempted sweep resumes mid-anneal (NUTS additionally has segment-level
  resume built into ``sample_GP_MCMC(checkpoint_path=...)``).

All files are plain ``numpy.savez`` archives (portable, inspectable).
"""

import json
import os

import numpy as np

from ..models.gp import GaussianProcess
from ..models.mogp import MultiOutputGP

__all__ = [
    "save_gp",
    "load_gp",
    "save_mogp",
    "load_mogp",
    "save_mcmc",
    "load_mcmc",
    "save_smc",
    "load_smc",
]


def atomic_savez(path, **payload):
    """Atomic ``.npz`` write: temp file + ``os.replace`` so a preemption
    mid-write never corrupts an existing checkpoint.  The single I/O
    primitive behind every checkpoint writer here and the NUTS segment
    writer (``models/inference.py``).  Matches ``np.savez``'s naming
    convention (a missing ``.npz`` extension is appended) so writers
    switched onto this helper keep their on-disk paths."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = "{}.tmp.npz".format(path)
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_tagged(path, tag, what):
    """Load a tag-guarded ``.npz`` checkpoint.

    Returns the open archive, or ``None`` when the file is absent or its
    ``tag`` does not match (a warning names the mismatch -- the run's
    configuration/data changed, so resuming would be silently wrong).
    ``tag=None`` skips the guard.
    """
    import warnings

    if not os.path.exists(str(path)):
        return None
    f = np.load(str(path), allow_pickle=False)
    if tag is not None and str(f["tag"]) != tag:
        warnings.warn(
            "{} checkpoint at {} belongs to a different run "
            "(configuration/data changed); starting fresh".format(what, path)
        )
        return None
    return f


def _gp_config(gp):
    return {
        "mean": gp._mean,
        "kernel": type(gp.kernel).__name__,
        "nugget": (
            gp._nugget_value if gp.nugget_type == "fixed" else gp.nugget_type
        ),
    }


def save_gp(gp, filename):
    """Checkpoint a single-output GP to ``.npz``.

    Note: custom priors are not serialized (defaults are rebuilt from the
    data on load); hyperparameters and the fit state are preserved.
    """
    theta = gp.theta.get_data()
    atomic_savez(
        filename,
        inputs=np.asarray(gp.inputs),
        targets=np.asarray(gp.targets),
        config=json.dumps(_gp_config(gp)),
        theta=(np.array([]) if theta is None else np.asarray(theta)),
    )


def load_gp(filename):
    """Restore a GP checkpoint; re-fits device artifacts if it was fit."""
    f = np.load(filename, allow_pickle=False)
    config = json.loads(str(f["config"]))
    nugget = config["nugget"]
    gp = GaussianProcess(
        f["inputs"],
        f["targets"],
        mean=config["mean"],
        kernel=config["kernel"],
        nugget=nugget,
    )
    theta = f["theta"]
    if theta.size > 0:
        gp.fit(theta)
    return gp


def save_mogp(mgp, filename):
    """Checkpoint a MultiOutputGP (homogeneous or heterogeneous configs)."""
    configs = [json.dumps(_gp_config(em)) for em in mgp.emulators]
    thetas = [
        (np.array([]) if em.theta.get_data() is None else np.asarray(em.theta.get_data()))
        for em in mgp.emulators
    ]
    atomic_savez(
        filename,
        inputs=np.asarray(mgp.inputs),
        targets=np.asarray(mgp.targets),
        configs=np.asarray(configs),  # fixed-width unicode
        **{"theta_{}".format(i): t for i, t in enumerate(thetas)},
    )


def load_mogp(filename):
    f = np.load(filename, allow_pickle=False)
    configs = [json.loads(str(c)) for c in f["configs"]]
    mgp = MultiOutputGP(
        f["inputs"],
        f["targets"],
        mean=[c["mean"] for c in configs],
        kernel=[c["kernel"] for c in configs],
        nugget=[c["nugget"] for c in configs],
    )
    for i, em in enumerate(mgp.emulators):
        theta = f["theta_{}".format(i)]
        if theta.size > 0:
            em.fit(theta)
    return mgp


def save_mcmc(result, filename):
    """Checkpoint an ``MCMCResult``."""
    atomic_savez(
        filename,
        samples=result.samples,
        accept_prob=result.accept_prob,
        diverging=result.diverging,
        rhat=result.rhat,
        ess=result.ess,
    )


def config_tag(settings=(), arrays=(), pytrees=(), strings=()):
    """Shared checkpoint-identity hash used by both the NUTS run tag
    (``models/inference.py``) and the SMC tag below: sampler/run
    settings (repr'd tuple), raw arrays, pytree leaves (float64-cast,
    leaf order), and identity strings.  Keeping ONE hashing convention
    means a change to it cannot silently weaken stale-checkpoint
    detection in just one consumer."""
    import hashlib

    import jax

    h = hashlib.sha1()
    h.update(repr(tuple(settings)).encode())
    for arr in arrays:
        h.update(np.ascontiguousarray(np.asarray(arr, np.float64)))
    for tree in pytrees:
        for leaf in jax.tree_util.tree_leaves(tree):
            h.update(np.ascontiguousarray(np.asarray(leaf, np.float64)))
    for s in strings:
        h.update(str(s).encode())
    return h.hexdigest()


def _smc_tag(gp, obs_mean, obs_var, bounds, threshold, n_particles,
             n_stages, n_mcmc, discrepancy, include_nugget, quantile,
             rank, seed):
    """Checkpoint identity for an SMC anneal: settings + observation +
    every emulator data leaf, so a changed posterior or configuration
    starts fresh instead of silently resuming a stale population."""
    ems = getattr(gp, "emulators", [gp])
    return config_tag(
        settings=(
            float(threshold), int(n_particles), int(n_stages), int(n_mcmc),
            float(discrepancy), bool(include_nugget), float(quantile),
            int(rank), int(seed),
        ),
        arrays=(obs_mean, obs_var, bounds),
        pytrees=[em._data for em in ems],
        strings=[
            "{}:{}".format(type(em.kernel).__name__, em.nugget_type)
            for em in ems
        ],
    )


def save_smc(filename, state, tag=""):
    """Atomically persist an SMC anneal state.

    :param state: dict with ``particles``, ``scale``, ``key``, ``stage``,
                  ``taus``, ``accs`` (numpy arrays / ints).
    """
    atomic_savez(
        filename,
        tag=np.asarray(str(tag)),
        particles=np.asarray(state["particles"]),
        scale=np.asarray(state["scale"]),
        key=np.asarray(state["key"]),
        stage=np.asarray(int(state["stage"])),
        taus=np.asarray(state["taus"], dtype=np.float64),
        accs=np.asarray(state["accs"], dtype=np.float64),
    )


def load_smc(filename, tag=None):
    """Load an SMC anneal state, or ``None`` when absent / for a
    different run (mismatched ``tag``)."""
    f = load_tagged(filename, tag, "SMC")
    if f is None:
        return None
    return {
        "particles": f["particles"],
        "scale": f["scale"],
        "key": f["key"],
        "stage": int(f["stage"]),
        "taus": f["taus"],
        "accs": f["accs"],
    }


def load_mcmc(filename):
    from ..models.inference import MCMCResult

    f = np.load(filename)
    return MCMCResult(
        samples=f["samples"],
        accept_prob=f["accept_prob"],
        diverging=f["diverging"],
        rhat=f["rhat"],
        ess=f["ess"],
    )
