"""Full Bayesian inference over GP hyperparameters: NUTS, VI, diagnostics.

The reference stops at MAP point estimates (``fitting.py:16``); this
module samples the posterior defined by the same negative log posterior
(``gp_nlp``: marginal likelihood + priors, ``GaussianProcess.py:655-685``
math) with:

* ``sample_GP_MCMC``   -- NUTS chains vmapped (and mesh-shardable) over a
  chains axis; returns samples in raw parameter space plus R-hat / ESS
  diagnostics computed cross-chain.
* ``fit_GP_VI``        -- mean-field ADVI: diagonal-Gaussian variational
  posterior over raw parameters, reparameterized ELBO maximized with
  the on-device L-BFGS-free optax Adam loop.
* ``predict_MCMC``     -- posterior-predictive moments: per-sample GP
  fit + predict vmapped over (thinned) posterior samples, then
  mixture-moment combination.
"""

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.hmc import (
    nuts_sample_segment,
    nuts_warmup_finish,
    nuts_warmup_init,
    nuts_warmup_segment,
    sample_nuts,
)
from .fitting import _OPT_LADDER
from .gp import GaussianProcess, gp_fit, gp_nlp, gp_predict

__all__ = [
    "sample_GP_MCMC",
    "sample_MOGP_MCMC",
    "fit_GP_VI",
    "predict_MCMC",
    "potential_scale_reduction",
    "effective_sample_size",
    "MCMCResult",
    "VIResult",
]


class MCMCResult(NamedTuple):
    samples: np.ndarray        # (n_chains, n_samples, P) raw parameters
    accept_prob: np.ndarray    # (n_chains, n_samples)
    diverging: np.ndarray      # (n_chains, n_samples)
    rhat: np.ndarray           # (P,)
    ess: np.ndarray            # (P,)


class VIResult(NamedTuple):
    mean: np.ndarray           # (P,) variational mean (raw space)
    log_std: np.ndarray        # (P,)
    elbo_trace: np.ndarray     # (n_steps,)


# ---------------------------------------------------------------------------
# Convergence diagnostics (cross-chain; on device)
# ---------------------------------------------------------------------------

@jax.jit
def potential_scale_reduction(samples):
    """Split R-hat (Gelman-Rubin) per parameter.

    :param samples: ``(n_chains, n_samples, P)``.
    :returns: ``(P,)`` split-R-hat values.
    """
    C, N, P = samples.shape
    half = N // 2
    split = jnp.concatenate(
        [samples[:, :half, :], samples[:, half : 2 * half, :]], axis=0
    )  # (2C, half, P)
    m = split.shape[0]
    chain_means = jnp.mean(split, axis=1)          # (m, P)
    chain_vars = jnp.var(split, axis=1, ddof=1)    # (m, P)
    W = jnp.mean(chain_vars, axis=0)
    B = half * jnp.var(chain_means, axis=0, ddof=1)
    var_plus = (half - 1) / half * W + B / half
    return jnp.sqrt(var_plus / W)


def effective_sample_size(samples):
    """Bulk effective sample size per parameter via FFT autocorrelation
    with Geyer's initial-positive-sequence truncation.

    Runs where the samples live: on an accelerator (f32) the FFT is
    supported, so large sharded chain sets are diagnosed in place --
    sharded sample arrays reduce over the chains axis with GSPMD
    collectives instead of a full gather to one host.  Only the x64-on-accelerator combination (f64
    FFT unsupported there) falls back to a CPU evaluation; that is the
    CPU-f64 parity-test configuration, where the gather is free.

    :param samples: ``(n_chains, n_samples, P)``.
    :returns: ``(P,)`` ESS estimates.
    """
    if jax.config.jax_enable_x64 and jax.default_backend() != "cpu":
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            return _effective_sample_size(
                jax.device_put(np.asarray(samples), cpu)
            )
    return _effective_sample_size(jnp.asarray(samples))


@jax.jit
def _effective_sample_size(samples):
    C, N, P = samples.shape
    x = samples - jnp.mean(samples, axis=1, keepdims=True)

    # autocovariance per chain/param via FFT
    nfft = 2 * N
    f = jnp.fft.rfft(x, n=nfft, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=1)[:, :N, :].real
    acov = acov / N

    chain_var = acov[:, 0, :]  # biased variance per chain
    mean_var = jnp.mean(chain_var, axis=0) * N / (N - 1.0)
    var_plus = mean_var * (N - 1.0) / N + jnp.var(
        jnp.mean(samples, axis=1), axis=0, ddof=1 if C > 1 else 0
    )

    rho = 1.0 - (mean_var - jnp.mean(acov, axis=0)) / var_plus  # (N, P)

    # Geyer: sum consecutive pairs while positive
    even = rho[0::2, :]
    odd = jnp.zeros_like(even).at[: rho[1::2].shape[0]].set(rho[1::2, :])
    pair = even + odd  # (N//2(+1), P)
    # monotone positive sequence: running-min then clip at first negative
    pair = jnp.minimum.accumulate(pair, axis=0)
    positive = pair > 0.0
    first_neg = jnp.argmin(positive, axis=0)
    has_neg = jnp.any(~positive, axis=0)
    cutoff = jnp.where(has_neg, first_neg, pair.shape[0])
    idx = jnp.arange(pair.shape[0])[:, None]
    tau = -1.0 + 2.0 * jnp.sum(jnp.where(idx < cutoff, pair, 0.0), axis=0)
    tau = jnp.maximum(tau, 1.0 / jnp.log10(jnp.asarray(float(N))))
    return C * N / tau


# ---------------------------------------------------------------------------
# NUTS over GP hyperparameters
# ---------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "max_depth", "target_accept",
                     "n_warmup", "n_samples"),
)
def _nuts_single_program(data, q0, keys, kernel, nugget_type, n_warmup,
                         n_samples, max_depth, target_accept):
    """(outputs x chains) chains in ONE program (small runs)."""

    def one_output(d, qs, ks):
        def potential(raw):
            return gp_nlp(raw, d, kernel, nugget_type,
                          sparse_ladder=_OPT_LADDER)

        return jax.vmap(
            lambda q, k: sample_nuts(
                potential, q, k, n_warmup=n_warmup, n_samples=n_samples,
                max_depth=max_depth, target_accept=target_accept,
            )
        )(qs, ks)

    return jax.vmap(one_output)(data, q0, keys)


@partial(jax.jit, static_argnames=("kernel", "nugget_type"))
def _nuts_init(data, q0, keys, kernel, nugget_type):
    def one(d, qs, ks):
        def potential(raw):
            return gp_nlp(raw, d, kernel, nugget_type,
                          sparse_ladder=_OPT_LADDER)

        return jax.vmap(lambda q, k: nuts_warmup_init(potential, q, k))(
            qs, ks
        )

    return jax.vmap(one)(data, q0, keys)


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "n_seg", "max_depth",
                     "target_accept"),
)
def _nuts_warmup_seg(data, carry, i0, m1, m2, kernel, nugget_type, n_seg,
                     max_depth, target_accept):
    def one(d, c):
        def potential(raw):
            return gp_nlp(raw, d, kernel, nugget_type,
                          sparse_ladder=_OPT_LADDER)

        return jax.vmap(
            lambda cc: nuts_warmup_segment(
                potential, cc, i0, n_seg, m1, m2,
                max_depth=max_depth, target_accept=target_accept,
            )
        )(c)

    return jax.vmap(one)(data, carry)


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "n_seg", "max_depth"),
)
def _nuts_sample_seg(data, carry, kernel, nugget_type, n_seg, max_depth):
    def one(d, c):
        def potential(raw):
            return gp_nlp(raw, d, kernel, nugget_type,
                          sparse_ladder=_OPT_LADDER)

        return jax.vmap(
            lambda cc: nuts_sample_segment(potential, cc, n_seg,
                                           max_depth=max_depth)
        )(c)

    return jax.vmap(one)(data, carry)


def _ckpt_save(path, tag, phase, idx, carry, samples_acc, infos_acc):
    """Atomically persist a mid-run chain state (``.npz``)."""
    from ..utils.checkpoint import atomic_savez

    payload = {
        "tag": np.asarray(tag),
        "phase": np.asarray(phase),
        "idx": np.asarray(idx),
    }
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jax.device_get(carry))):
        payload["leaf_{}".format(i)] = np.asarray(leaf)
    if samples_acc is not None:
        payload["samples"] = samples_acc
        for i, leaf in enumerate(jax.tree_util.tree_leaves(infos_acc)):
            payload["info_{}".format(i)] = np.asarray(leaf)
    atomic_savez(path, **payload)


def _ckpt_load(path, tag):
    """Load a chain checkpoint, or None when absent / for a different run."""
    from ..utils.checkpoint import load_tagged

    return load_tagged(path, tag, "NUTS")


def _run_tag(q0, n_warmup, n_samples, max_depth, target_accept,
             data=None, kernel=None, nugget_type=None):
    """Checkpoint identity for a chain run.

    Hashes the initial positions, sampler settings, AND the posterior
    itself (every ``GPData`` leaf plus the kernel/nugget config): a
    resumed run whose training data changed but whose q0 happens to be
    identical (explicit theta0 + same seed) must NOT silently resume
    stale chain state against a different posterior.  Uses the shared
    hashing convention of ``utils.checkpoint.config_tag``."""
    from ..utils.checkpoint import config_tag

    return config_tag(
        settings=(int(n_warmup), int(n_samples), int(max_depth),
                  float(target_accept)),
        arrays=(q0,),
        pytrees=() if data is None else (data,),
        strings=[
            s for s in (
                None if kernel is None else type(kernel).__name__,
                nugget_type,
            ) if s is not None
        ],
    )


def _run_nuts_chains(data, q0, chain_keys, kernel, nugget_type, n_warmup,
                     n_samples, max_depth, target_accept, segment=None,
                     checkpoint_path=None):
    """Run (outputs x chains) NUTS chains over a stacked ``GPData``: one
    program by default, or bounded segments when ``segment`` is given.

    All segment programs are module-level jits keyed on shapes and the
    (hashable) kernel/nugget statics, so repeated calls and successive
    segments reuse ONE compiled program per shape.

    With ``checkpoint_path``, the full chain state (warmup adaptation,
    key stream, accumulated samples) is persisted after every segment
    and a preempted run resumes from the last completed segment --
    first-class preemptible-slice support (SURVEY §5); the reference has
    no inference to checkpoint.  The checkpoint is tagged with the run's
    initial state so a changed configuration starts fresh, and removed
    on completion.  Each save rewrites the accumulated samples (atomic
    single-file checkpoints are worth the O(samples-so-far) host copy at
    these array sizes; ~tens of MB per save even at 64 chains x
    thousands of samples).

    :param q0: ``(G, C, P)`` initial positions.
    :returns: ``(samples (G, C, n_samples, P), NUTSInfo stacked)``.
    """
    import os

    seg_w = seg_s = segment
    if checkpoint_path is not None:
        # checkpointing needs segment boundaries to persist at
        seg_w = seg_w or max(1, n_warmup // 4)
        seg_s = seg_s or max(1, n_samples // 4)
    if seg_w is None and seg_s is None:
        return _nuts_single_program(
            data, q0, chain_keys, kernel, nugget_type, n_warmup, n_samples,
            max_depth, target_accept,
        )

    tag = (
        _run_tag(q0, n_warmup, n_samples, max_depth, target_accept,
                 data=data, kernel=kernel, nugget_type=nugget_type)
        if checkpoint_path is not None else None
    )
    ckpt = _ckpt_load(checkpoint_path, tag) if checkpoint_path else None

    i0 = 0
    sample_parts, info_parts = [], []
    done = 0
    scarry = None
    carry = None

    if ckpt is not None:
        phase = int(ckpt["phase"])
        idx = int(ckpt["idx"])
        # abstract template (zero device work) purely for the pytree
        # structure + leaf dtypes of the carry being restored
        warm_template = jax.eval_shape(
            lambda d, q, k: _nuts_init(d, q, k, kernel, nugget_type),
            data, q0, chain_keys,
        )
        if phase == 0:
            carry = _ckpt_unflatten(warm_template, ckpt)
            i0 = idx
        else:
            template = jax.eval_shape(
                jax.vmap(jax.vmap(nuts_warmup_finish)), warm_template
            )
            scarry = _ckpt_unflatten(template, ckpt)
            i0 = n_warmup
            done = idx
            if "samples" in ckpt:
                sample_parts = [np.asarray(ckpt["samples"])]
                info_leaves = []
                i = 0
                while "info_{}".format(i) in ckpt:
                    info_leaves.append(np.asarray(ckpt["info_{}".format(i)]))
                    i += 1
                from ..ops.hmc import NUTSInfo

                info_parts = [NUTSInfo(*info_leaves)]
    if carry is None and scarry is None:
        carry = _nuts_init(data, q0, chain_keys, kernel, nugget_type)

    seg_w = seg_w or n_warmup
    m1 = jnp.asarray(int(n_warmup * 0.5), jnp.int32)
    m2 = jnp.asarray(int(n_warmup * 0.9), jnp.int32)
    while i0 < n_warmup:
        n_seg = min(seg_w, n_warmup - i0)
        carry = _nuts_warmup_seg(
            data, carry, jnp.asarray(i0, jnp.int32), m1, m2, kernel,
            nugget_type, n_seg, max_depth, target_accept,
        )
        i0 += n_seg
        if checkpoint_path is not None:
            _ckpt_save(checkpoint_path, tag, 0, i0, carry, None, None)
    if scarry is None:
        scarry = jax.vmap(jax.vmap(nuts_warmup_finish))(carry)

    seg_s = seg_s or n_samples
    while done < n_samples:
        n_seg = min(seg_s, n_samples - done)
        scarry, s, info = _nuts_sample_seg(
            data, scarry, kernel, nugget_type, n_seg, max_depth
        )
        # host materialization per segment keeps at most one segment of
        # samples on device and bounds the dispatch queue
        sample_parts.append(np.asarray(s))
        info_parts.append(jax.device_get(info))
        done += n_seg
        if checkpoint_path is not None:
            samples_acc = np.concatenate(sample_parts, axis=2)
            infos_acc = jax.tree_util.tree_map(
                lambda *xs: np.concatenate(xs, axis=2), *info_parts
            )
            _ckpt_save(checkpoint_path, tag, 1, done, scarry, samples_acc,
                       infos_acc)
    samples = jnp.asarray(np.concatenate(sample_parts, axis=2))
    infos = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=2), *info_parts
    )
    if checkpoint_path is not None and os.path.exists(str(checkpoint_path)):
        os.remove(str(checkpoint_path))
    return samples, infos


def _ckpt_unflatten(template, ckpt):
    """Rebuild a carry pytree from checkpoint leaves, preserving the
    template's leaf dtypes (incl. PRNG key uint32 and counter ints)."""
    leaves = jax.tree_util.tree_leaves(template)
    loaded = [
        jnp.asarray(ckpt["leaf_{}".format(i)]).astype(leaf.dtype)
        for i, leaf in enumerate(leaves)
    ]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), loaded
    )


def sample_GP_MCMC(
    gp: GaussianProcess,
    n_samples=500,
    n_warmup=500,
    n_chains=4,
    seed=0,
    max_depth=8,
    target_accept=0.8,
    theta0=None,
    mesh=None,
    segment=None,
    checkpoint_path=None,
):
    """Sample the GP hyperparameter posterior with NUTS.

    Chains are a vmapped batch axis; with ``mesh`` provided, the chain
    axis is sharded over devices (GSPMD partitions the identical chain
    programs; no collectives are needed until diagnostics, which run as
    reductions over the gathered samples).

    Trajectory evaluations use the reduced jitter ladder (see
    ``fitting._OPT_LADDER``): with ``nugget="adaptive"`` a data-dependent
    ladder would make the target density discontinuous in raw space; the
    single fixed 1e-6*mean-diag rung is both ~3x cheaper per leapfrog
    step and a smooth, well-defined posterior.

    Each phase runs as one program; ``segment`` splits it into dispatches
    of that many iterations.  With ``checkpoint_path``, the chain state
    is persisted after every segment and a preempted run resumes from
    the last completed segment (the file is removed on completion).

    :returns: ``MCMCResult`` with raw-space samples and diagnostics.
    """
    dtype = gp._data.inputs.dtype
    kernel = gp.kernel
    nugget_type = gp.nugget_type

    key = jax.random.PRNGKey(seed)
    key_init, key_run = jax.random.split(key)

    if theta0 is not None:
        # jitter chain initializations around theta0 (identical inits make
        # R-hat meaningless when mixing is slow; standard Stan practice)
        q0 = jnp.asarray(theta0, dtype=dtype) + 0.5 * jax.random.normal(
            key_init, (n_chains, gp.n_params), dtype=dtype
        )
    else:
        # initialize chains from the priors (like optimizer restarts,
        # fitting.py:242)
        keys = jax.random.split(key_init, n_chains)
        q0 = jax.vmap(gp.priors.sample_raw)(keys).astype(dtype)

    chain_keys = jax.random.split(key_run, n_chains)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        q0 = jax.device_put(q0, NamedSharding(mesh, P(mesh.axis_names[0], None)))
        chain_keys = jax.device_put(chain_keys, NamedSharding(
            mesh, P(mesh.axis_names[0], None)))

    data1 = jax.tree_util.tree_map(lambda x: x[None], gp._data)
    samples, infos = _run_nuts_chains(
        data1, q0[None], chain_keys[None], kernel, nugget_type, n_warmup,
        n_samples, max_depth, target_accept, segment=segment,
        checkpoint_path=checkpoint_path,
    )
    samples = samples[0]
    infos = jax.tree_util.tree_map(lambda x: x[0], infos)

    rhat = potential_scale_reduction(samples)
    ess = effective_sample_size(samples)

    return MCMCResult(
        samples=np.asarray(samples),
        accept_prob=np.asarray(infos.accept_prob),
        diverging=np.asarray(infos.diverging),
        rhat=np.asarray(rhat),
        ess=np.asarray(ess),
    )


def sample_MOGP_MCMC(
    mgp,
    n_samples=500,
    n_warmup=500,
    n_chains=4,
    seed=0,
    max_depth=8,
    target_accept=0.8,
    mesh=None,
    segment=None,
    checkpoint_path=None,
):
    """NUTS posteriors for every output of a MultiOutputGP at once.

    The BASELINE target configuration ("full MultiOutputGP fit + NUTS
    hyperparameter posteriors for a tsunami-scale emulator"): the
    (outputs x chains) axes are vmapped into one program per signature
    group (heterogeneous per-output configurations dispatch per group);
    with ``mesh``, each group's outputs axis is sharded over devices.
    Requires prior MAP fits (used as jittered chain initializations).

    :returns: list of per-output ``MCMCResult``.
    """
    from .mogp import MultiOutputGP, _stack_pytrees

    assert isinstance(mgp, MultiOutputGP)
    assert mgp.get_indices_not_fit() == [], (
        "MAP-fit all outputs first (fit_GP_MAP) to initialize chains"
    )
    results = [None] * mgp.n_emulators

    # heterogeneous configurations run as one batched program per
    # signature group, matching the per-group dispatch of fitting and
    # prediction (reference per-output config lists,
    # MultiOutputGP.py:72-104)
    for g_idx, (sig, rel) in enumerate(sorted(
        mgp._groups().items(), key=lambda kv: kv[1][0]
    )):
        ems = [mgp.emulators[i] for i in rel]
        em0 = ems[0]
        dtype = em0._data.inputs.dtype
        P = em0.n_params
        kernel = em0.kernel
        nugget_type = em0.nugget_type

        data_stack = _stack_pytrees([em._data for em in ems])
        theta_map = jnp.asarray(
            np.stack([em.theta.get_data() for em in ems]), dtype=dtype
        )  # (G, P)

        key = jax.random.fold_in(jax.random.PRNGKey(seed), g_idx)
        k_init, k_run = jax.random.split(key)
        q0 = theta_map[:, None, :] + 0.5 * jax.random.normal(
            k_init, (len(ems), n_chains, P), dtype=dtype
        )
        chain_keys = jax.random.split(k_run, len(ems) * n_chains).reshape(
            len(ems), n_chains, -1
        )

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as Pspec

            ax = mesh.axis_names[0]
            n_dev = mesh.shape[ax]
            if len(ems) % n_dev == 0:
                q0 = jax.device_put(
                    q0, NamedSharding(mesh, Pspec(ax, None, None))
                )
                data_stack = jax.tree_util.tree_map(
                    lambda x: jax.device_put(
                        x,
                        NamedSharding(
                            mesh, Pspec(ax, *([None] * (x.ndim - 1)))
                        ),
                    ),
                    data_stack,
                )
            # groups not divisible by the mesh fall back to the default
            # (replicated) placement; correctness is unaffected

        ckpt_g = (
            None if checkpoint_path is None
            else "{}.group{}".format(checkpoint_path, g_idx)
        )
        samples, infos = _run_nuts_chains(
            data_stack, q0, chain_keys, kernel, nugget_type, n_warmup,
            n_samples, max_depth, target_accept, segment=segment,
            checkpoint_path=ckpt_g,
        )
        # samples: (G, n_chains, n_samples, P)

        for j, i in enumerate(rel):
            s = samples[j]
            results[i] = MCMCResult(
                samples=np.asarray(s),
                accept_prob=np.asarray(infos.accept_prob[j]),
                diverging=np.asarray(infos.diverging[j]),
                rhat=np.asarray(potential_scale_reduction(s)),
                ess=np.asarray(effective_sample_size(s)),
            )
    return results


# ---------------------------------------------------------------------------
# Mean-field VI (ADVI)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("kernel", "nugget_type", "n_steps", "n_mc",
                                   "learning_rate"))
def _vi_run(mu0, log_std0, key, data, kernel, nugget_type, n_steps, n_mc,
            learning_rate):
    """``n_steps`` Adam steps on the negative ELBO in one program (a
    module-level jit, so repeated fits of one shape compile once)."""
    import optax

    dtype = mu0.dtype
    P = mu0.shape[0]
    optimizer = optax.adam(learning_rate)

    def neg_elbo(params, key):
        mu, log_std = params
        eps = jax.random.normal(key, (n_mc, P), dtype=dtype)
        zs = mu + jnp.exp(log_std) * eps
        nlps = jax.vmap(
            lambda z: gp_nlp(z, data, kernel, nugget_type,
                             sparse_ladder=_OPT_LADDER)
        )(zs)
        # replace non-finite draws with a large penalty (failed Cholesky)
        nlps = jnp.where(jnp.isfinite(nlps), nlps, 1e10)
        entropy = jnp.sum(log_std) + 0.5 * P * (1.0 + jnp.log(2.0 * jnp.pi))
        return jnp.mean(nlps) - entropy

    params = (mu0, log_std0)
    opt_state = optimizer.init(params)

    def step(carry, _):
        params, opt_state, key = carry
        key, sub = jax.random.split(key)
        loss, grads = jax.value_and_grad(neg_elbo)(params, sub)
        updates, opt_state = optimizer.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state, key), -loss

    (params, _, _), elbo_trace = jax.lax.scan(
        step, (params, opt_state, key), None, length=n_steps,
    )
    return params, elbo_trace


def fit_GP_VI(
    gp: GaussianProcess,
    n_steps=1000,
    n_mc=8,
    learning_rate=0.05,
    seed=0,
    theta0=None,
):
    """Mean-field ADVI over the raw hyperparameters.

    Maximizes the reparameterized ELBO ``E_q[-nlp(raw)] + H(q)`` for a
    diagonal Gaussian ``q`` with Adam; fully jitted, one program.
    """
    dtype = gp._data.inputs.dtype
    P = gp.n_params
    if theta0 is None:
        theta0 = np.zeros(P)
    mu0 = jnp.asarray(theta0, dtype=dtype)
    log_std0 = jnp.full((P,), -2.0, dtype=dtype)

    (mu, log_std), elbo_trace = _vi_run(
        mu0, log_std0, jax.random.PRNGKey(seed), gp._data, gp.kernel,
        gp.nugget_type, int(n_steps), int(n_mc), float(learning_rate),
    )
    return VIResult(
        mean=np.asarray(mu),
        log_std=np.asarray(log_std),
        elbo_trace=np.asarray(elbo_trace),
    )


# ---------------------------------------------------------------------------
# Posterior-predictive
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("kernel", "nugget_type", "include_nugget"))
def _predict_samples(raws, data, testing, dmtest, kernel, nugget_type,
                     include_nugget=True):
    def one(raw):
        arts = gp_fit(raw, data, kernel, nugget_type)
        mu, var = gp_predict(
            arts, data, testing, dmtest, kernel, nugget_type,
            unc=True, include_nugget=include_nugget, full_cov=False,
        )
        return mu, var

    return jax.vmap(one)(raws)


def predict_MCMC(gp, samples, testing, thin=1, include_nugget=True):
    """Posterior-predictive mean/variance marginalized over hyperparameter
    samples (mixture moments over per-sample GP predictions).

    :param samples: ``(n_chains, n_samples, P)`` or ``(n_samples, P)``
                    raw-space samples (e.g. from ``sample_GP_MCMC``).
    :returns: ``(mean, variance)`` numpy arrays of length ``n_predict``.
    """
    samples = np.asarray(samples)
    if samples.ndim == 3:
        samples = samples.reshape(-1, samples.shape[-1])
    samples = samples[::thin]

    testing = gp._process_inputs(testing)
    dmtest = gp.get_design_matrix(testing)
    dtype = gp._data.inputs.dtype

    mus, variances = _predict_samples(
        jnp.asarray(samples, dtype=dtype),
        gp._data,
        jnp.asarray(testing, dtype=dtype),
        jnp.asarray(dmtest, dtype=dtype),
        gp.kernel,
        gp.nugget_type,
        include_nugget=include_nugget,
    )
    mus = np.asarray(mus)
    variances = np.asarray(variances)
    finite = np.isfinite(mus).all(axis=1) & np.isfinite(variances).all(axis=1)
    mus, variances = mus[finite], variances[finite]
    mean = mus.mean(axis=0)
    var = variances.mean(axis=0) + mus.var(axis=0)
    return mean, var
