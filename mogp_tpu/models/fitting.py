"""MAP hyperparameter estimation via batched on-device L-BFGS.

Re-design of ``mogp_emulator/fitting.py`` (GPU analogue
``mogp_gpu/src/fitting.hpp``): the reference runs ``n_tries`` serial
scipy L-BFGS-B restarts per emulator (``fitting.py:237-255``) and
distributes emulators over a process pool (``fitting.py:333-335``).
Here every (output, restart) pair is an element of a vmapped batch axis
minimized by ``mogp_tpu.ops.lbfgs`` inside one jitted XLA program; on a
device mesh the same program shards that axis over chips (see
``mogp_tpu.parallel``).

Failure semantics match the reference (``fitting.py:175-186,252-264``):
restarts whose objective is non-finite are dropped; emulators with no
surviving restart are left unfit (``theta = None``) and reported via
``get_indices_not_fit``; single-GP fitting raises on total failure.
"""

import os
import warnings
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.lbfgs import lbfgs_minimize
from .gp import GaussianProcess, GaussianProcessBase, gp_fit, gp_nlp
from .mogp import MultiOutputGP, _stack_pytrees

__all__ = ["fit_GP_MAP"]

_GP_KWARGS = ["mean", "kernel", "priors", "nugget", "inputdict", "use_patsy"]


# Jitter-ladder resolution used for the optimizer's TRAJECTORY with
# nugget="adaptive" (the final refit of the winning restart always uses
# the exact reference ladder): "sparse" = 3 Cholesky candidates per
# objective evaluation, "single" = 1 candidate (the 1e-6*mean-diag rung;
# fastest -- points needing a larger jitter evaluate to NaN and are
# rejected by the line search, like a skipped LinAlgError restart).
_LADDER_MODES = {"sparse": True, "single": "single", "full": False}
_OPT_LADDER = _LADDER_MODES[os.environ.get("MOGP_TPU_OPT_LADDER", "single")]


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "maxiter", "gtol", "ftol", "ladder"),
)
def _batched_fit_single(starts, data, kernel, nugget_type, maxiter, gtol, ftol,
                        ladder):
    """All restarts of one GP in a single XLA program (vmap over tries)."""

    def minimize_one(x0):
        return lbfgs_minimize(
            lambda raw: gp_nlp(raw, data, kernel, nugget_type,
                               sparse_ladder=ladder,
                               progressive_ok=False),
            x0,
            maxiter=maxiter,
            gtol=gtol,
            ftol=ftol,
        )

    return jax.vmap(minimize_one)(starts)


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "maxiter", "gtol", "ftol", "ladder"),
)
def _batched_fit_multi(starts, data, kernel, nugget_type, maxiter, gtol, ftol,
                       ladder):
    """(outputs x restarts) batched fit: the reference's process pool and
    restart loop collapsed into one doubly-vmapped program."""

    def fit_output(x0s, d):
        return jax.vmap(
            lambda x0: lbfgs_minimize(
                lambda raw: gp_nlp(raw, d, kernel, nugget_type,
                                   sparse_ladder=ladder,
                                   progressive_ok=False),
                x0,
                maxiter=maxiter,
                gtol=gtol,
                ftol=ftol,
            )
        )(x0s)

    return jax.vmap(fit_output)(starts, data)


@partial(jax.jit, static_argnames=("kernel", "nugget_type"))
def _batched_refit(raws, data, kernel, nugget_type):
    """Fit-time artifacts for every output's best raw vector in one
    vmapped program (replaces a per-emulator ``em.fit`` dispatch loop --
    one device round-trip for the whole group instead of one per output)."""
    # progressive_ok=False: a while-loop ladder under vmap runs every
    # lane to the batch-max rung count (see ops/cholesky.py)
    return jax.vmap(
        lambda r, d: gp_fit(r, d, kernel, nugget_type, progressive_ok=False)
    )(raws, data)


def _gather_starts(gp, n_tries, theta0):
    """Starting points: ``theta0`` first (if given), prior samples after
    (``fitting.py:239-242``).  Host-side numpy RNG, so seeded runs are
    deterministic; note ``GPPriors.sample_n`` draws slot-major (all tries
    of slot 0 first -- see ``priors.py``), so the draw ORDER differs from
    the reference's per-try sampling loop."""
    n_sampled = n_tries
    head = []
    if theta0 is not None:
        theta = np.array(theta0, dtype=np.float64)
        assert theta.shape == (gp.n_params,), (
            "theta0 must be a 1D array with length n_params"
        )
        head = [theta[None, :]]
        n_sampled -= 1
    sampled = np.asarray(gp.priors.sample_n(n_sampled), dtype=np.float64)
    return np.concatenate(head + [sampled], axis=0) if head else sampled


# Upper bound on concurrent (output x restart) L-BFGS lanes per compiled
# program.  Bounds compile time and device memory for very large
# MultiOutputGP fits; larger groups are processed in equal-size chunks.
# The default was tuned on the previous accelerator and is not yet
# measured on the GPU.
_MAX_LANES = int(os.environ.get("MOGP_TPU_MAX_FIT_LANES", "256"))

# Per-phase wall-clock of the LAST _fit_MOGP_MAP call, as (label, seconds)
# pairs -- read by bench.py to attach phase splits to every timed sample
# (each chunk pull syncs, so the splits are accurate).  Cost: a few
# perf_counter calls per fit.
last_phase_times = []


def _extract_opt_options(kwargs):
    maxiter = int(kwargs.pop("maxiter", 200))
    gtol = kwargs.pop("gtol", None)
    ftol = kwargs.pop("ftol", None)
    gtol = None if gtol is None else float(gtol)
    ftol = None if ftol is None else float(ftol)
    race = bool(kwargs.pop("race", True))
    ladder = kwargs.pop("opt_ladder", None)
    ladder = _OPT_LADDER if ladder is None else _LADDER_MODES[ladder]
    kwargs.pop("processes", None)  # accepted for API parity; batching replaces it
    if kwargs:
        warnings.warn(
            "ignoring unsupported optimizer options: {}".format(sorted(kwargs))
        )
    return maxiter, gtol, ftol, race, ladder


def _race_plan(n_tries, maxiter, race):
    """Multi-stage restart tournament ("race") schedule.

    The reference runs every restart to convergence and keeps the best
    (``fitting.py:237-264``); in a lockstep batch that makes every lane
    pay for the slowest restart that will mostly be thrown away.  The
    race spends a short first stage on ALL restarts, then lets only the
    top ``keep`` per output advance, possibly through further cuts.  The
    winner still satisfies the same convergence criteria on the same
    objective; restarts are random starts, so which local optimum wins
    was never deterministic to begin with.  Disable with ``race=False``
    for the strict all-restarts-full-budget schedule.

    The schedule can be overridden with ``MOGP_TPU_RACE_STAGES``, a
    comma list of ``iters:keep`` cut stages (e.g. ``"16:6,16:3"``); the
    final stage always runs the remaining budget (at least ``maxiter -
    sum(stage iters)``, floored at 12) on the survivors.

    :returns: list of ``(iters, keep)`` stages ending with a final
              ``(iters, None)`` stage, or ``None`` when racing is off /
              not worthwhile.
    """
    if not race or n_tries < 4 or maxiter < 16:
        return None
    env = os.environ.get("MOGP_TPU_RACE_STAGES")
    if env:
        stages = []
        used = 0
        for part in env.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                iters_s, keep_s = part.split(":")
                iters, keep = int(iters_s), int(keep_s)
            except ValueError:
                raise ValueError(
                    "MOGP_TPU_RACE_STAGES must be a comma list of "
                    "'iters:keep' pairs (e.g. '16:6,16:3'); got "
                    "{!r}".format(env)
                )
            if iters <= 0 or keep < 2:
                raise ValueError(
                    "MOGP_TPU_RACE_STAGES stage {!r}: iters must be "
                    "positive and keep >= 2 (a single survivor leaves "
                    "nothing to tournament)".format(part)
                )
            stages.append((iters, keep))
            used += iters
        if not stages:
            raise ValueError(
                "MOGP_TPU_RACE_STAGES is set but contains no stages: "
                "{!r}".format(env)
            )
        stages.append((max(maxiter - used, 12), None))
        return stages
    # stage length tuned on the tsunami-shape benchmark on the previous
    # accelerator, not yet measured on the GPU.  The quality gap is
    # almost entirely WRONG-WINNER selection, so WHEN the cut happens
    # matters most: a cut at 9/20 of maxiter (22 of 50) keeping the top
    # quarter matched the strict schedule's quality, where a cut at a
    # third did not.
    phase_a = max(12, (9 * maxiter) // 20)
    keep = max(2, -(-n_tries // 4))
    return [(phase_a, keep), (max(maxiter - phase_a, 12), None)]


def _check_method(method):
    if method not in ("L-BFGS-B", "L-BFGS", "lbfgs"):
        warnings.warn(
            "method '{}' is not available on device; using batched L-BFGS".format(
                method
            )
        )


def _fit_single_GP_MAP(gp, n_tries=15, theta0=None, method="L-BFGS-B", **kwargs):
    """Fit a single GP (``fitting.py:219-271``)."""
    assert isinstance(gp, GaussianProcessBase)
    n_tries = int(n_tries)
    assert n_tries > 0, "number of attempts must be positive"
    _check_method(method)
    maxiter, gtol, ftol, race, ladder = _extract_opt_options(dict(kwargs))

    starts = _gather_starts(gp, n_tries, theta0)
    dtype = gp._data.inputs.dtype
    plan = _race_plan(n_tries, maxiter, race)
    if plan is None:
        plan = [(maxiter, None)]

    def run_schedule(ladder_mode):
        cur = jnp.asarray(starts, dtype=dtype)
        for iters, keep in plan:
            res = _batched_fit_single(
                cur, gp._data, gp.kernel, gp.nugget_type, iters, gtol, ftol,
                ladder_mode,
            )
            fun = np.asarray(res.fun, dtype=np.float64)
            xs = np.asarray(res.x, dtype=np.float64)
            if keep is not None:
                top = np.argsort(
                    np.where(np.isfinite(fun), fun, np.inf)
                )[:keep]
                cur = jnp.asarray(xs, dtype=dtype)[top]
        return fun, xs

    fun, xs = run_schedule(ladder)
    if (
        not np.isfinite(fun).any()
        and gp.nugget_type == "adaptive"
        and ladder is not False
    ):
        # ladder escalation: the reduced trajectory ladder can make EVERY
        # start non-finite on problems that genuinely need large jitter
        # (near-duplicate inputs in float32); the reference's adaptive
        # loop would simply escalate (linalg/cholesky.py:269-278), so
        # retry the whole schedule with the full reference ladder before
        # declaring failure
        fun, xs = run_schedule(False)

    finite = np.isfinite(fun)
    if not finite.any():
        print("Minimization routine failed to return a value")
        gp.theta = None
    else:
        idx = int(np.nanargmin(np.where(finite, fun, np.inf)))
        gp.fit(xs[idx])
    return gp


def _run_fit_chunked(ems, starts, kernel, nugget_type, maxiter, gtol, ftol,
                     ladder, dtype, chunk=None, mesh=None):
    """Run the doubly-vmapped fit over output chunks of <= _MAX_LANES lanes.

    :param starts: (G, T, P) starting points.
    :param chunk: outputs per compiled program; default (``None``) sizes
                  chunks to fill ``_MAX_LANES`` with the given restart
                  count.  Race phase A passes an explicit shared chunk
                  quantum; phase B passes ``None`` and self-sizes to fill
                  ``_MAX_LANES`` with its ``keep``-lane outputs, costing
                  one extra compiled shape per group size (paid once via
                  the persistent cache) in exchange for full-lane
                  programs instead of ``keep``-lane slivers.
    :param mesh: optional device mesh; the outputs axis of every chunk is
                 sharded over its first axis (GSPMD partitions the SAME
                 compiled program the single-chip path runs -- the mesh
                 path is not a fork).  The per-program lane budget scales
                 with the device count, and chunk sizes are rounded up to
                 a device multiple (masked padding).
    :returns: ``(fun (G, T), xs (G, T, P))`` numpy arrays.
    """
    G, T, P = starts.shape
    n_dev = 1 if mesh is None else mesh.shape[mesh.axis_names[0]]
    if chunk is None:
        outputs_per_chunk = max(1, (_MAX_LANES * n_dev) // max(T, 1))
        n_chunks = -(-G // outputs_per_chunk)
        chunk = -(-G // n_chunks)  # equalized chunk size
    chunk = min(chunk, G)
    if mesh is not None:
        chunk = -(-chunk // n_dev) * n_dev

    fun = np.empty((G, T), dtype=np.float64)
    xs = np.empty((G, T, P), dtype=np.float64)
    # dispatch ahead of the pulls: JAX dispatch is async, so chunk k+1's
    # host-side staging (pytree stacking, input upload, dispatch RPC)
    # overlaps chunk k's device execution instead of leaving the device
    # idle during each pull.  The in-flight window is bounded at 2
    # chunks -- an unbounded queue would pin every chunk's stacked
    # input copy and result buffers in HBM simultaneously, roughly
    # doubling peak memory for large-n multi-output fits

    def _drain(item):
        sel_d, res_d = item
        fun[sel_d] = np.asarray(res_d.fun, dtype=np.float64)[
            : sel_d.stop - sel_d.start
        ]
        xs[sel_d] = np.asarray(res_d.x, dtype=np.float64)[
            : sel_d.stop - sel_d.start
        ]

    pending = []
    for c0 in range(0, G, chunk):
        sel = slice(c0, min(c0 + chunk, G))
        pad = chunk - (sel.stop - sel.start)
        idx_sel = list(range(sel.start, sel.stop)) + [sel.stop - 1] * pad
        data_c = _stack_pytrees([ems[i]._data for i in idx_sel])
        starts_c = jnp.asarray(starts[idx_sel], dtype=dtype)
        if mesh is not None:
            from ..parallel.mesh import shard_leading

            starts_c = shard_leading(starts_c, mesh)
            data_c = shard_leading(data_c, mesh)
        res = _batched_fit_multi(
            starts_c,
            data_c,
            kernel,
            nugget_type,
            maxiter,
            gtol,
            ftol,
            ladder,
        )
        if mesh is not None and jax.process_count() > 1:
            # multi-host (DCN): each process computes only its shard of
            # the outputs axis; gather the global result on every host
            # (blocking here is required -- the collective is ordered)
            from jax.experimental import multihost_utils

            res = multihost_utils.process_allgather(res, tiled=True)
        pending.append((sel, res))
        # drain down to one pending result: at any instant at most 2
        # chunks are in flight (the one completing in _drain + the one
        # just dispatched)
        if len(pending) > 1:
            _drain(pending.pop(0))
    for item in pending:
        _drain(item)
    return fun, xs


def _fit_MOGP_MAP(gp, n_tries=15, theta0=None, method="L-BFGS-B", refit=False,
                  mesh=None, **kwargs):
    """Fit all outputs of a MultiOutputGP in batched groups
    (``fitting.py:273-338``).

    With ``mesh``, the outputs axis of every batched program (both race
    phases AND the exact-ladder refit) is sharded over the mesh's first
    axis -- the mesh path is the single-chip path plus sharding
    constraints, NOT a separate implementation, so race, lane chunking,
    and the batched refit all apply on multi-chip runs, and heterogeneous
    configurations work through the same per-group dispatch
    (``MultiOutputGP.py:72-104`` per-output config lists)."""
    assert isinstance(gp, MultiOutputGP)
    n_tries = int(n_tries)
    assert n_tries > 0, "n_tries must be a positive integer"
    _check_method(method)
    maxiter, gtol, ftol, race, ladder = _extract_opt_options(dict(kwargs))
    n_dev = 1 if mesh is None else mesh.shape[mesh.axis_names[0]]

    # normalize theta0 into a per-emulator list (fitting.py:294-316)
    if theta0 is None:
        theta0 = [None] * gp.n_emulators
    elif isinstance(theta0, np.ndarray):
        if theta0.ndim == 1:
            theta0 = [theta0] * gp.n_emulators
        else:
            assert theta0.ndim == 2, "theta0 must be a 1D or 2D array"
            assert theta0.shape[0] == gp.n_emulators, (
                "bad shape for fitting starting points"
            )
            theta0 = list(theta0)
    else:
        theta0 = list(theta0)
        assert len(theta0) == gp.n_emulators, (
            "theta0 must be a list of length n_emulators"
        )

    if refit:
        indices_to_fit = list(range(gp.n_emulators))
    else:
        indices_to_fit = gp.get_indices_not_fit()

    if not indices_to_fit:
        return gp

    import time as _time

    del last_phase_times[:]
    _t_phase = _time.perf_counter()

    def _mark(label):
        nonlocal _t_phase
        now = _time.perf_counter()
        last_phase_times.append((label, now - _t_phase))
        _t_phase = now

    # group emulators so each compiled program covers a uniform batch
    for sig, rel_indices in gp._groups(
        [gp.emulators[i] for i in indices_to_fit]
    ).items():
        global_idx = [indices_to_fit[i] for i in rel_indices]
        ems = [gp.emulators[i] for i in global_idx]
        em0 = ems[0]
        dtype = em0._data.inputs.dtype

        starts = np.stack(
            [_gather_starts(em, n_tries, theta0[i]) for em, i in zip(ems, global_idx)]
        )  # (G, n_tries, P)
        G = len(ems)

        # fixed chunk quantum shared by both race phases: every group size
        # decomposes into the same compiled program shapes
        chunk_q = max(1, (_MAX_LANES * n_dev) // max(n_tries, 1))
        chunk_q = -(-G // (-(-G // chunk_q)))  # equalized
        if mesh is not None:
            chunk_q = -(-chunk_q // n_dev) * n_dev

        plan = _race_plan(n_tries, maxiter, race)
        if plan is None:
            plan = [(maxiter, None)]
        cur = starts
        for stage_idx, (iters, keep) in enumerate(plan):
            # the first (all-restarts) stage uses the shared chunk
            # quantum; later stages self-size their chunks (chunk=None ->
            # fill _MAX_LANES with the survivors): reusing the first
            # stage's outputs-per-chunk quantum would leave them running
            # `keep`-lane slivers (e.g. 48 of 240 lanes), where the
            # latency-bound per-lane cost is several times worse.  Costs
            # one extra compiled shape per (group size, stage width),
            # paid once via the persistent cache.
            fun, xs = _run_fit_chunked(
                ems, cur, em0.kernel, em0.nugget_type, iters, gtol, ftol,
                ladder, dtype, chunk=(chunk_q if stage_idx == 0 else None),
                mesh=mesh,
            )
            _mark("stage{}".format(stage_idx))
            if keep is not None:
                # top `keep` restarts per output advance; non-finite
                # restarts sort last.  (A descent-aware score crediting
                # still-descending lanes their predicted remaining
                # decrease 0.5*lambda*|g|^2 was measured and REJECTED:
                # it overpredicts for lanes headed to poor optima and
                # widened the quality gap 4-8x at every lambda tried.)
                order = np.argsort(
                    np.where(np.isfinite(fun), fun, np.inf), axis=1
                )[:, :keep]
                cur = np.take_along_axis(xs, order[:, :, None], axis=1)

        # ladder escalation for outputs where EVERY restart was
        # non-finite: the reduced trajectory ladder cannot rescue
        # problems that genuinely need large jitter (near-duplicate
        # inputs in float32); the reference's adaptive loop escalates
        # (linalg/cholesky.py:269-278), so rerun just the failed outputs
        # with the full reference ladder before declaring them unfit
        failed = [r for r in range(G) if not np.isfinite(fun[r]).any()]
        rescue = {}
        if failed and em0.nugget_type == "adaptive" and ladder is not False:
            fun_f, xs_f = _run_fit_chunked(
                [ems[r] for r in failed], starts[failed], em0.kernel,
                em0.nugget_type, maxiter, gtol, ftol, False, dtype,
                mesh=mesh,
            )
            for j, r in enumerate(failed):
                finite_f = np.isfinite(fun_f[j])
                if finite_f.any():
                    idx = int(np.nanargmin(
                        np.where(finite_f, fun_f[j], np.inf)
                    ))
                    rescue[r] = xs_f[j, idx]
            _mark("rescue")

        best_raw = np.empty((G, starts.shape[-1]), dtype=np.float64)
        fit_rows = []
        for row, em in enumerate(ems):
            finite = np.isfinite(fun[row])
            if finite.any():
                idx = int(np.nanargmin(np.where(finite, fun[row], np.inf)))
                best_raw[row] = xs[row, idx]
                fit_rows.append(row)
            elif row in rescue:
                best_raw[row] = rescue[row]
                fit_rows.append(row)
            else:
                em.theta = None
        # final exact-ladder refit, chunked on the same quantum as the fit
        # so every group size reuses one compiled refit program
        for r0 in range(0, len(fit_rows), chunk_q):
            rows = fit_rows[r0 : r0 + chunk_q]
            rows_pad = rows + [rows[-1]] * (chunk_q - len(rows))
            data_g = _stack_pytrees([ems[r]._data for r in rows_pad])
            raw_g = jnp.asarray(best_raw[rows_pad], dtype=dtype)
            if mesh is not None:
                from ..parallel.mesh import shard_leading

                raw_g = shard_leading(raw_g, mesh)
                data_g = shard_leading(data_g, mesh)
            arts = _batched_refit(raw_g, data_g, em0.kernel, em0.nugget_type)
            if mesh is not None and jax.process_count() > 1:
                from jax.experimental import multihost_utils

                arts = multihost_utils.process_allgather(arts, tiled=True)
            arts = jax.device_get(arts)
            for k, row in enumerate(rows):
                ems[row]._set_fit_artifacts(
                    best_raw[row],
                    jax.tree_util.tree_map(lambda x: x[k], arts),
                )
        _mark("refit")
    return gp


def fit_GP_MAP(
    *args,
    n_tries=15,
    theta0=None,
    method="L-BFGS-B",
    skip_failures=True,
    refit=False,
    mesh=None,
    **kwargs,
):
    """Fit one or more GPs by minimizing the negative log posterior.

    Drop-in equivalent of the reference entry point
    (``fitting.py:16-186``): accepts an existing ``GaussianProcess`` /
    ``MultiOutputGP``, or constructor arguments for building one; runs
    ``n_tries`` restarts (first from ``theta0`` when provided, the rest
    sampled from the priors) and keeps the best finite result.  All
    restarts -- and for multi-output fitting, all outputs -- run
    batched on device in a single XLA program.

    Additional optimizer options via ``**kwargs``: ``maxiter`` (default
    200), ``gtol``/``ftol`` (dtype-scaled defaults), and ``race``
    (default True) -- a two-phase restart tournament where every restart
    runs a short phase A and only the best few per output get the full
    budget (see ``_race_plan``); pass ``race=False`` for the reference's
    strict all-restarts-full-budget schedule.  With ``nugget="adaptive"``
    the optimizer trajectory uses a reduced jitter ladder selected by
    ``MOGP_TPU_OPT_LADDER`` ("single" default / "sparse" / "full"); the
    final refit of each winner always uses the exact reference ladder
    (``linalg/cholesky.py:234-281``).

    ``mesh`` (MultiOutputGP only) shards the outputs axis of every
    batched program over a ``jax.sharding.Mesh`` -- race, lane chunking,
    and the batched refit are identical to the single-chip path; GSPMD
    partitions the programs (see ``_run_fit_chunked``).
    """
    if len(args) == 1:
        gp = args[0]
        if isinstance(gp, MultiOutputGP):
            gp = _fit_MOGP_MAP(gp, n_tries, theta0, method, refit, mesh,
                               **kwargs)
        elif isinstance(gp, GaussianProcessBase):
            if mesh is not None:
                warnings.warn(
                    "mesh sharding applies to MultiOutputGP fits; ignoring "
                    "mesh for a single GP"
                )
            gp = _fit_single_GP_MAP(gp, n_tries, theta0, method, **kwargs)
        else:
            raise TypeError(
                "single arg to fit_GP_MAP must be a GaussianProcess or "
                "MultiOutputGP instance"
            )
    elif len(args) < 2:
        raise TypeError("missing required inputs/targets arrays to GaussianProcess")
    else:
        gp_kwargs = {}
        for key in _GP_KWARGS:
            if key in kwargs:
                gp_kwargs[key] = kwargs.pop(key)
        try:
            gp = GaussianProcess(*args, **gp_kwargs)
            gp = _fit_single_GP_MAP(gp, n_tries, theta0, method, **kwargs)
        except AssertionError:
            try:
                gp = MultiOutputGP(*args, **gp_kwargs)
                gp = _fit_MOGP_MAP(gp, n_tries, theta0, method, refit, mesh,
                                   **kwargs)
            except AssertionError:
                raise ValueError("Bad values for *args in fit_GP_MAP")

    if isinstance(gp, GaussianProcessBase):
        if gp.theta.get_data() is None:
            raise RuntimeError("GP fitting failed")
    else:
        if len(gp.get_indices_not_fit()) > 0:
            failure_string = "Fitting failed for emulators {}".format(
                gp.get_indices_not_fit()
            )
            if skip_failures:
                print(failure_string)
            else:
                raise RuntimeError(failure_string)
    return gp
