#!/usr/bin/env python3
"""Bring-up check: the GP-emulation main path on one GPU, against float64.

Drives the public API once at the width of the tsunami benchmark (64
outputs, n=210 training points, D=14, 15 L-BFGS restarts, adaptive
nugget, ``maxiter=50``) and compares every result with a float64
reference computed on the host:

* phase 0 -- the device: its name, power limit, and that it is a GPU;
* phase 1 -- ``fit_GP_MAP`` of the 64-output ``MultiOutputGP``;
* phase 2 -- ``predict`` over 1e6 query points in 32768-point tiles;
* phase 3 -- ``HistoryMatching`` over 2^21 coordinates (the fused
  on-device sweep);
* phase 4 -- one n=4096, D=8 fit artifact (progressive jitter ladder);
* phase 5 -- the contract the jitter ladder rests on: a non-positive-
  definite lane factorises to NaN and leaves its neighbours intact;
* phase 6 -- NUTS, VI, device MICE, SMC history matching and MaxiMin LHC.

The card computes in float32 with the library's HIGHEST-precision pins
(x64 off).  The references use numpy/scipy in float64, and the
library's own float64 path for the prior terms only, in a child process
that is held to the CPU -- the card is opened by this process alone.

Every phase prints one line: its name, its wall time with compilation
included, and each comparison beside its tolerance and the reason for
it.  Any failed comparison exits non-zero.  The last line of a passing
run is one JSON object naming the device.

Run from the repository root::

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-gpus  # the cross-device paths, four GPUs
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# --- sizes (the tsunami benchmark's widths; see bench.py) -------------------
N_OUTPUTS = 64
N_TRIES = 15
MAXITER = 50
N_QUERY = 1_000_000
PREDICT_TILE = 32768
N_CHECK = 4096
HM_COORDS = 1 << 21
HM_THRESHOLD = 3.0
LARGE_N = 4096
LARGE_D = 8
LARGE_CORR_RAW = 2.0
NAN_BATCH = 480
NAN_N = 210
NAN_LANE = 137
NUTS_CHAINS = 64
NUTS_ITERS = 200
VI_STEPS = 400
MICE_CAND = 100_000
MICE_STEPS = 2
SMC_PARTICLES = 4096
SMC_STAGES = 2

# --- tolerances --------------------------------------------------------------
# |dNLP| <= TOL_NLP * max(1, |NLP|): a float32 Cholesky holds ~4 digits
# of the log determinant and quadratic form at the fits' conditioning
# (CPU float32 rehearsal: 3e-7 since K(x, x) has an exact zero-distance
# diagonal; before that, 2e-4 to 7e-4 on the H100).
TOL_NLP = 1e-3
# |dmean| <= TOL_MEAN * std(y): the sweep GP's MAP K (nugget ~5e-7
# sigma2) has condition ~1e8, so a float32 K^-1 y keeps ~2 digits near
# the data; CPU float32 rehearsal: 7e-3.  TF32 products would miss by
# orders of magnitude.
TOL_MEAN = 5e-2
# |dvar| <= TOL_VAR * var_ref + TOL_VAR_ABS * sigma2: the variance is
# sigma2 - |L^-1 k*|^2, which cancels where var << sigma2, so the
# relative bound gets an absolute floor at float32 resolution of sigma2.
TOL_VAR = 1e-2
TOL_VAR_ABS = 1e-4
# |dI| <= TOL_I * max(1, I): implausibility inherits the mean error
# above through |z - mu| / sqrt(V); CPU float32 rehearsal: 1.2e-2.
TOL_I = 5e-2
# a factor L of a well-conditioned (cond ~ 1e3) SPD matrix: float32 gives
# max|L - L64| <= ~cond * eps * max|L64|.
TOL_CHOL = 1e-4
# gross non-mixing detector for 64 chains x 200 draws, not a convergence
# proof.
TOL_RHAT = 1.5


class Check(NamedTuple):
    """One comparison: ``value`` must be finite and at most ``tol``."""

    name: str
    value: float
    tol: float
    reason: str

    @property
    def ok(self):
        return bool(np.isfinite(self.value) and self.value <= self.tol)

    def __str__(self):
        return "{}={:.3e} (tol {:.1e}: {}) {}".format(
            self.name, self.value, self.tol, self.reason,
            "ok" if self.ok else "FAILED",
        )


def run_phase(name, fn, *args, **kwargs):
    """Run one phase, print its line, and exit non-zero if it failed."""
    t0 = time.perf_counter()
    checks, result = fn(*args, **kwargs)
    dt = time.perf_counter() - t0
    print("phase {}: {:.3f} s | {}".format(
        name, dt, " | ".join(str(c) for c in checks)), flush=True)
    bad = [c.name for c in checks if not c.ok]
    if bad:
        raise SystemExit("phase {} failed: {}".format(name, ", ".join(bad)))
    return result


# --- float64 host references --------------------------------------------------

def ref_cov(x1, x2, raw, D):
    """Squared-exponential covariance ``sigma2 * exp(-r2/2)`` in float64,
    summing squared differences directly (no matmul cancellation)."""
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    scale = np.exp(np.asarray(raw[:D], np.float64))
    r2 = np.zeros((x1.shape[0], x2.shape[0]))
    for d in range(D):
        diff = x1[:, d, None] - x2[None, :, d]
        r2 += scale[d] * diff * diff
    return np.exp(raw[D]) * np.exp(-0.5 * r2)


def ref_chol(K):
    """Lower Cholesky factor in float64, or ``None`` if K is not PD."""
    from scipy.linalg import lapack

    L, info = lapack.dpotrf(K, lower=1, clean=1)
    return L if info == 0 else None


def ref_ladder(K, maxtries=5):
    """The adaptive jitter ladder in float64: ``(rung, jitter, L)`` of the
    first of ``[0, d*1e-6, ..., d*1e-6*10**(maxtries-1)]`` that factorises,
    with ``d`` the mean diagonal (``ops.cholesky.jit_cholesky``)."""
    jitters = ladder_jitters(np.mean(np.diag(K)), maxtries)
    eye = np.eye(K.shape[0])
    for rung, jitter in enumerate(jitters):
        L = ref_chol(K + jitter * eye)
        if L is not None:
            return rung, jitter, L
    raise AssertionError("float64 ladder failed at every rung")


def ladder_jitters(mean_diag, maxtries=5):
    return np.concatenate([[0.0], mean_diag * 1e-6 * 10.0 ** np.arange(maxtries)])


def ref_nlp(x, y, raw, nugget, log_prior):
    """Zero-mean negative log posterior in float64
    (``ops.linalg.marginal_nlp`` with no mean terms)."""
    from scipy.linalg import solve_triangular

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    K = ref_cov(x, x, raw, x.shape[1]) + nugget * np.eye(x.shape[0])
    L = ref_chol(K)
    assert L is not None, "float64 K + nugget is not positive definite"
    a = solve_triangular(L, y, lower=True)
    n = x.shape[0]
    return 0.5 * (a @ a + 2.0 * np.sum(np.log(np.diag(L)))
                  + n * np.log(2.0 * np.pi)) - log_prior


def ref_predict(x, y, raw, nugget, xq):
    """Zero-mean predictive mean and variance (nugget included) in float64."""
    from scipy.linalg import cho_solve, solve_triangular

    x = np.asarray(x, np.float64)
    D = x.shape[1]
    K = ref_cov(x, x, raw, D) + nugget * np.eye(x.shape[0])
    L = ref_chol(K)
    assert L is not None, "float64 K + nugget is not positive definite"
    Ks = ref_cov(x, xq, raw, D)
    mean = Ks.T @ cho_solve((L, True), np.asarray(y, np.float64))
    v = solve_triangular(L, Ks, lower=True)
    var = np.exp(raw[D]) + nugget - np.sum(v * v, axis=0)
    return mean, var


def _prior_terms_local(inputs, raws, nugget_type):
    import jax
    import jax.numpy as jnp

    from mogp_tpu.models.gp import GaussianProcess, _prior_logp

    gp = GaussianProcess(np.asarray(inputs, np.float64),
                         np.zeros(len(inputs)), nugget=nugget_type)
    raws = jnp.asarray(np.asarray(raws, np.float64))
    fn = jax.vmap(lambda r: _prior_logp(gp._data, r, gp.n_corr, nugget_type))
    return np.asarray(fn(raws), np.float64)


def prior_terms_f64(inputs, raws, nugget_type):
    """Log prior density of each raw vector, by the library's float64 path
    on the CPU.  Run in place when this process already is CPU/float64
    (the tests); otherwise in a child process held to the CPU, so that the
    card is never opened a second time."""
    import jax

    if jax.default_backend() == "cpu" and jax.config.jax_enable_x64:
        return _prior_terms_local(inputs, raws, nugget_type)
    buf = io.BytesIO()
    np.savez(buf, inputs=np.asarray(inputs, np.float64),
             raws=np.asarray(raws, np.float64), nugget_type=nugget_type)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--prior-ref"],
        input=buf.getvalue(), stdout=subprocess.PIPE, env=env, cwd=HERE,
        check=True,
    )
    return np.load(io.BytesIO(out.stdout))["logp"]


def _prior_ref_child():
    """Child entry point of :func:`prior_terms_f64`: npz in on stdin, npz
    out on stdout."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, HERE)
    req = np.load(io.BytesIO(sys.stdin.buffer.read()))
    logp = _prior_terms_local(req["inputs"], req["raws"],
                              str(req["nugget_type"]))
    buf = io.BytesIO()
    np.savez(buf, logp=logp)
    sys.stdout.buffer.write(buf.getvalue())
    sys.stdout.buffer.flush()


def var_error(var, var_ref, sigma2):
    """Worst ``(|dvar| - TOL_VAR_ABS * sigma2) / var_ref``: the relative
    variance error beyond an absolute floor at float32's resolution of
    sigma2 (the variance cancels where var << sigma2)."""
    dvar = np.abs(np.asarray(var) - var_ref) - TOL_VAR_ABS * sigma2
    with np.errstate(divide="ignore"):
        return float(np.max(dvar / np.abs(var_ref)))


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(1.0, np.abs(np.asarray(b)))))


def _as_f64(arr):
    return np.asarray(arr, dtype=np.float64)


def tsunami_data(n_outputs):
    """The benchmark's synthetic tsunami-shape data (``bench.make_data``)."""
    sys.path.insert(0, HERE)
    import bench

    return bench.make_data(n_outputs)


# --- phases -------------------------------------------------------------------

def phase_fit(n_outputs=N_OUTPUTS, n_tries=N_TRIES, maxiter=MAXITER, seed=1):
    """64-output MAP fit; the card's log posterior at its fitted theta
    against float64 at the same theta and realised nugget."""
    from mogp_tpu import MultiOutputGP, fit_GP_MAP

    inputs, targets = tsunami_data(n_outputs)
    mgp = MultiOutputGP(inputs, targets, nugget="adaptive")
    np.random.seed(seed)
    fit_GP_MAP(mgp, n_tries=n_tries, maxiter=maxiter)
    n_unfit = len(mgp.get_indices_not_fit())
    ems = [em for em in mgp.emulators if em.theta.get_data() is not None]
    thetas = np.stack([em.theta.get_data() for em in ems])
    nlp_dev = np.array([em.current_logpost for em in ems])
    nuggets = np.array([float(em._artifacts.nugget) for em in ems])
    x = _as_f64(ems[0]._data.inputs)  # the float32 values the card saw
    log_prior = prior_terms_f64(x, thetas, "adaptive")
    nlp_ref = np.array([
        ref_nlp(x, _as_f64(em._data.targets), th, nug, lp)
        for em, th, nug, lp in zip(ems, thetas, nuggets, log_prior)
    ])
    checks = [
        Check("outputs_not_fit", n_unfit, 0, "every output must fit"),
        Check("nonfinite", float(np.sum(~np.isfinite(thetas))
                                 + np.sum(~np.isfinite(nlp_dev))), 0,
              "fitted theta and NLP must be finite"),
        Check("max_rel_dNLP", _rel(nlp_dev, nlp_ref), TOL_NLP,
              "f32 Cholesky of the 210x210 K vs f64 at the same theta/nugget"),
    ]
    return checks, mgp


def smooth_targets(inputs, n_outputs, seed=5):
    """Smooth outputs of the tsunami-shape inputs, for emulators whose
    predictions the data inform (the benchmark's own outputs vary in all
    14 dimensions, and their MAP fits are white noise: K = sigma2 * I)."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(0.0, 2 * np.pi, n_outputs)
    a = rng.uniform(0.5, 1.5, n_outputs)
    b = rng.uniform(-1.0, 1.0, n_outputs)
    x = inputs
    return np.stack([np.sin(3 * x[:, 0] + c[i]) + a[i] * x[:, 1] ** 2
                     + b[i] * x[:, 2] + 0.1 * x.sum(1)
                     for i in range(n_outputs)])


def fit_from_smooth_start(gp, maxiter=MAXITER):
    """MAP fit from one start with unit correlation scales, off the white-
    noise plateau that prior-sampled starts in 14-D fall onto."""
    from mogp_tpu import fit_GP_MAP

    n_params = (gp.emulators[0] if hasattr(gp, "emulators") else gp).n_params
    return fit_GP_MAP(gp, n_tries=1, theta0=np.zeros(n_params),
                      maxiter=maxiter)


def sweep_gp():
    """The ``bench.sweep_points_per_sec`` GP: tsunami-shape inputs, one
    smooth output."""
    from mogp_tpu import GaussianProcess

    rng = np.random.RandomState(11)
    inputs = rng.uniform(0.0, 1.0, size=(210, 14))
    targets = (np.sin(3 * inputs[:, 0]) + inputs[:, 1] ** 2
               + 0.1 * inputs.sum(1))
    return fit_from_smooth_start(GaussianProcess(inputs, targets))


def smooth_mogp(n_outputs):
    """A fitted ``n_outputs``-output emulator on :func:`smooth_targets`."""
    from mogp_tpu import MultiOutputGP

    inputs, _ = tsunami_data(n_outputs)
    return fit_from_smooth_start(MultiOutputGP(
        inputs, smooth_targets(inputs, n_outputs), nugget="adaptive"))


def query_points(x_train, n, rng):
    """``n`` query points in the unit box: half uniform, half within ~0.05
    of a training point, where the data inform the prediction (in 14-D a
    uniform point is far from every training point and predicts the prior)."""
    n_near = n // 2
    near = (x_train[rng.randint(0, x_train.shape[0], size=n_near)]
            + 0.05 * rng.randn(n_near, x_train.shape[1]))
    q = np.concatenate([rng.uniform(0.0, 1.0, size=(n - n_near,
                                                    x_train.shape[1])),
                        np.clip(near, 0.0, 1.0)])
    return q[rng.permutation(n)]


def phase_predict(n_query=N_QUERY, tile=PREDICT_TILE, n_check=N_CHECK,
                  seed=2):
    """Tiled predict of the sweep benchmark's GP over ``n_query`` points;
    mean and variance on ``n_check`` of them against float64."""
    gp = sweep_gp()
    rng = np.random.RandomState(seed)
    q = query_points(gp.inputs, n_query, rng)
    res = gp.predict(q, max_batch_size=tile)
    mean, var = res.mean, res.unc
    sub = np.sort(rng.choice(n_query, size=min(n_check, n_query), replace=False))
    x = _as_f64(gp._data.inputs)
    y = _as_f64(gp._data.targets)
    raw = gp.theta.get_data()
    nugget = float(gp._artifacts.nugget)
    mref, vref = ref_predict(x, y, raw, nugget, _as_f64(
        np.asarray(q[sub], np.float32)))
    sigma2 = float(np.exp(raw[gp.D]))
    checks = [
        Check("uninformed_fraction", float(np.mean(vref >= 0.5 * sigma2)),
              0.75, "the data inform the checked predictions"),
        Check("shape_mismatch", float(mean.shape != (n_query,)
                                      or var.shape != (n_query,)), 0,
              "one mean and variance per query"),
        Check("nonfinite", float(np.sum(~np.isfinite(mean))
                                 + np.sum(~np.isfinite(var))), 0,
              "every query finite"),
        Check("max_dmean/std_y", float(np.max(np.abs(mean[sub] - mref))
                                       / np.std(y)), TOL_MEAN,
              "f32 K*^T K^-1 y vs f64, cond(K)~1e8"),
        Check("max_rel_dvar", var_error(var[sub], vref, sigma2), TOL_VAR,
              "f32 sigma2-|L^-1 k*|^2 vs f64, floor {:.0e} sigma2".format(
                  TOL_VAR_ABS)),
    ]
    return checks, None


def _hm_obs(mgp, seed):
    """Observations: the card's prediction near a training point, with an
    observation variance of a quarter of each output's data variance."""
    rng = np.random.RandomState(seed)
    x_true = np.clip(mgp.emulators[0].inputs[:1]
                     + 0.02 * rng.randn(1, mgp.D), 0.0, 1.0)
    pred = mgp.predict(x_true)
    obs_mean = np.asarray(pred.mean, np.float64)[:, 0]
    obs_var = np.array([0.25 * np.var(_as_f64(em._data.targets))
                        for em in mgp.emulators])
    return obs_mean, obs_var


def ref_implausibility(mgp, xq, obs_mean, obs_var, rank=1):
    """Rank-scored implausibility in float64 (``HistoryMatching.py:275-286``)."""
    I = []
    for i, em in enumerate(mgp.emulators):
        m, v = ref_predict(_as_f64(em._data.inputs), _as_f64(em._data.targets),
                           em.theta.get_data(), float(em._artifacts.nugget), xq)
        I.append(np.abs(obs_mean[i] - m) / np.sqrt(v + obs_var[i]))
    I = np.array(I)
    n_obs = I.shape[0]
    return np.partition(I, n_obs - rank - 1, axis=0)[n_obs - rank - 1]


def phase_history_matching(n_outputs=N_OUTPUTS, n_coords=HM_COORDS,
                           n_check=N_CHECK, seed=3):
    """History matching of a fitted ``n_outputs``-output emulator over
    ``n_coords`` points through the fused device sweep; implausibility
    and NROY membership on ``n_check`` of them against float64."""
    from mogp_tpu import HistoryMatching
    from mogp_tpu.uq import history_matching

    mgp = smooth_mogp(n_outputs)
    obs_mean, obs_var = _hm_obs(mgp, seed)
    rng = np.random.RandomState(seed + 1)
    coords = query_points(mgp.emulators[0].inputs, n_coords, rng)
    hm = HistoryMatching(gp=mgp, obs=[obs_mean, obs_var], coords=coords,
                         threshold=HM_THRESHOLD)
    I = np.asarray(hm.get_implausibility(rank=1))
    nroy = np.zeros(n_coords, bool)
    nroy[hm.get_NROY()] = True
    sub = np.sort(rng.choice(n_coords, size=min(n_check, n_coords),
                             replace=False))
    I_ref = ref_implausibility(
        mgp, _as_f64(np.asarray(coords[sub], np.float32)), obs_mean, obs_var)
    near = np.abs(I_ref - HM_THRESHOLD) <= TOL_I * HM_THRESHOLD
    wrong = (nroy[sub] != (I_ref <= HM_THRESHOLD)) & ~near
    checks = [
        Check("fused_sweep_off", float(
            n_coords < history_matching._DEVICE_SWEEP_MIN_COORDS), 0,
            "the fused on-device sweep must run"),
        Check("nonfinite", float(np.sum(~np.isfinite(I))), 0,
              "every implausibility finite"),
        Check("max_rel_dI", _rel(I[sub], I_ref), TOL_I,
              "f32 |z-mu|/sqrt(V) vs f64, cond(K)~1e8"),
        Check("nroy_mismatch", float(np.sum(wrong)), 0,
              "NROY membership, points within tol of the threshold excused"),
        Check("nroy_fraction", float(np.mean(nroy)), 1.0, "fraction kept"),
    ]
    return checks, (mgp, [obs_mean, obs_var])


def large_n_data(n=LARGE_N, D=LARGE_D):
    """The ``bench.large_n_tflops`` problem: n points in D dims, seed 0."""
    rng = np.random.RandomState(0)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2:].sum(axis=1)
    return x, y


def phase_large_n(n=LARGE_N, D=LARGE_D, corr_raw=LARGE_CORR_RAW):
    """One n x n fit artifact through the progressive jitter ladder; NLP and
    realised rung against the float64 ladder.  The correlation length is
    one at which K is well within float32's range (cond ~5e4); at the
    benchmark's longer length cond(K) ~3e10 exceeds 1/eps_f32, K is
    indefinite once rounded to float32, and the precisions cannot agree
    on a rung."""
    from mogp_tpu import GaussianProcess
    from mogp_tpu.ops import cholesky

    x, y = large_n_data(n, D)
    theta = np.concatenate([corr_raw * np.ones(D), [0.5]])
    gp = GaussianProcess(x, y, nugget="adaptive")
    gp.fit(theta)
    nlp_dev = float(gp.current_logpost)
    nug_dev = float(gp._artifacts.nugget)
    xf = _as_f64(gp._data.inputs)
    yf = _as_f64(gp._data.targets)
    K = ref_cov(xf, xf, theta, D)
    rung, jitter, _ = ref_ladder(K)
    rung_dev = int(np.argmin(np.abs(ladder_jitters(np.mean(np.diag(K)))
                                    - nug_dev)))
    log_prior = prior_terms_f64(xf, theta[None], "adaptive")[0]
    nlp_ref = ref_nlp(xf, yf, theta, jitter, log_prior)
    checks = [
        Check("single_matrix_ladder_off", float(
            n < cholesky._PROGRESSIVE_LADDER_MIN_N), 0,
            "n must take the progressive ladder"),
        Check("rung_diff", float(abs(rung_dev - rung)), 0,
              "realised jitter rung equals the f64 ladder's"),
        Check("rel_dNLP", _rel(nlp_dev, nlp_ref), TOL_NLP,
              "f32 Cholesky at n=4096 vs f64"),
    ]
    return checks, None


def _spd_batch(B, n, seed, shift=0.1):
    """B well-conditioned SPD matrices: a squared-exponential kernel of
    random 4-D points plus ``shift * I``; float32."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(size=(B, n, 4)).astype(np.float32)
    r2 = np.zeros((B, n, n), np.float32)
    for d in range(4):
        diff = xs[:, :, None, d] - xs[:, None, :, d]
        r2 += diff * diff
    A = np.exp(-0.5 * r2 / np.float32(0.05))
    A += np.float32(shift) * np.eye(n, dtype=np.float32)
    return A


def _lane_checks(L, A, bad, tag):
    """NaN isolation: the lower triangle of the non-PD lane ``bad`` is all
    NaN, every other lane finite and equal to its float64 factor."""
    good = np.ones(L.shape[0], bool)
    good[bad] = False
    L64 = np.linalg.cholesky(_as_f64(A[good]))
    err = np.max(np.abs(L[good] - L64)) / np.max(np.abs(L64))
    lower = np.tril_indices(L.shape[-1])
    return [
        Check(tag + "_bad_lane_finite", float(np.sum(np.isfinite(
            L[bad][lower]))), 0, "a non-PD lane factorises to NaN"),
        Check(tag + "_good_lane_nonfinite", float(np.sum(~np.isfinite(L[good]))),
              0, "neighbours of a NaN lane stay finite"),
        Check(tag + "_max_rel_dL", float(err), TOL_CHOL,
              "f32 factor vs f64 on cond~1e3 SPD lanes"),
    ]


def phase_nan_lanes(batch=NAN_BATCH, n=NAN_N, bad=NAN_LANE, n_large=LARGE_N):
    """The NaN contract the jitter ladder rests on, batched at the fit
    width and at n=4096, plus one ladder escalation at n=4096."""
    import jax
    import jax.numpy as jnp

    from mogp_tpu.ops.cholesky import fixed_cholesky, jit_cholesky

    chol = jax.jit(fixed_cholesky)
    A = _spd_batch(batch, n, seed=5)
    A[bad] -= np.float32(0.5) * np.eye(n, dtype=np.float32)
    checks = _lane_checks(np.asarray(chol(jnp.asarray(A)), np.float64), A,
                          bad, "n{}".format(n))

    Al = _spd_batch(1, n_large, seed=6)
    Al = np.concatenate([Al, Al - np.eye(n_large, dtype=np.float32)[None]])
    checks += _lane_checks(np.asarray(chol(jnp.asarray(Al)), np.float64), Al,
                           1, "n{}".format(n_large))
    del Al

    # ladder escalation: a near-singular kernel matrix shifted so its
    # smallest eigenvalue is -3e-4 of the mean diagonal -- far above
    # float32's resolution of it, and between rungs 3 and 4
    x, _ = large_n_data(n_large, LARGE_D)
    theta = np.concatenate([0.2 * np.ones(LARGE_D), [0.5]])
    K = ref_cov(x, x, theta, LARGE_D)
    K -= 3e-4 * np.exp(theta[-1]) * np.eye(n_large)
    K32 = K.astype(np.float32)
    rung, _, _ = ref_ladder(_as_f64(K32))
    factor, jitter = jax.jit(jit_cholesky)(jnp.asarray(K32))
    jitter = float(jitter)
    rung_dev = int(np.argmin(np.abs(
        ladder_jitters(float(np.mean(np.diag(_as_f64(K32))))) - jitter)))
    checks += [
        Check("ladder_rung_diff", float(abs(rung_dev - rung)), 0,
              "escalated rung equals the f64 ladder's"),
        Check("ladder_nonfinite", float(np.sum(~np.isfinite(
            np.asarray(factor.L)))), 0, "the escalated factor is finite"),
    ]
    return checks, None


def nuts_gp():
    """The ``nuts`` benchmark GP: tsunami-shape inputs, one smooth output,
    fitted nugget."""
    from mogp_tpu import GaussianProcess, fit_GP_MAP

    rng = np.random.RandomState(7)
    inputs = rng.uniform(0.0, 1.0, size=(210, 14))
    targets = (np.sin(3 * inputs[:, 0]) + inputs[:, 1] ** 2
               + 0.1 * inputs.sum(1))
    np.random.seed(2)
    return fit_GP_MAP(GaussianProcess(inputs, targets, nugget="fit"),
                      n_tries=4, maxiter=50)


def phase_surface(hm_case, n_chains=NUTS_CHAINS, n_iters=NUTS_ITERS,
                  vi_steps=VI_STEPS, mice_cand=MICE_CAND,
                  mice_steps=MICE_STEPS, smc_particles=SMC_PARTICLES,
                  smc_stages=SMC_STAGES):
    """NUTS, VI, device MICE, SMC and MaxiMin LHC: finite, valid results."""
    from mogp_tpu import (DeviceMICEDesign, LatinHypercubeDesign, MaxiMinLHC,
                          fit_GP_VI, sample_GP_MCMC, smc_history_match)
    from mogp_tpu.uq import experimental_design

    checks = []
    gp = nuts_gp()
    theta = gp.theta.get_data()
    res = sample_GP_MCMC(gp, n_samples=n_iters, n_warmup=n_iters,
                         n_chains=n_chains, theta0=theta, seed=1)
    checks += [
        Check("nuts_nonfinite", float(np.sum(~np.isfinite(res.samples))), 0,
              "every draw finite"),
        Check("nuts_accept_off", float(abs(np.mean(res.accept_prob) - 0.8)),
              0.3, "mean acceptance near its 0.8 target"),
        Check("nuts_max_rhat", float(np.max(res.rhat)), TOL_RHAT,
              "chains agree"),
    ]

    vi = fit_GP_VI(gp, n_steps=vi_steps, theta0=theta, seed=1)
    elbo = np.asarray(vi.elbo_trace)
    w = max(1, vi_steps // 8)
    checks += [
        Check("vi_nonfinite", float(np.sum(~np.isfinite(vi.mean))
                                    + np.sum(~np.isfinite(vi.log_std))
                                    + np.sum(~np.isfinite(elbo))), 0,
              "finite variational parameters and ELBO"),
        Check("vi_elbo_drop", float(max(0.0, elbo[:w].mean()
                                        - elbo[-w:].mean())), 0,
              "the ELBO does not fall"),
    ]

    np.random.seed(8213)
    bounds = [(-5.0, 10.0), (0.0, 15.0)]

    def branin(p):
        x1, x2 = p[0], p[1]
        return ((x2 - 5.1 / (4 * np.pi ** 2) * x1 ** 2 + 5 / np.pi * x1 - 6)
                ** 2 + 10 * (1 - 1 / (8 * np.pi)) * np.cos(x1) + 10)

    md = DeviceMICEDesign(LatinHypercubeDesign(bounds), branin,
                          n_samples=mice_steps, n_init=16, n_cand=mice_cand,
                          cand_block=min(4096, mice_cand), n_tries=8,
                          maxiter=60)
    md.run_initial_design()
    for _ in range(mice_steps):
        md.run_next_point()
    pts = np.asarray(md.get_inputs())
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    checks += [
        Check("mice_points_missing", float(abs(pts.shape[0] - 16 - mice_steps)),
              0, "one point per step"),
        Check("mice_out_of_bounds", float(np.sum((pts < lo) | (pts > hi))), 0,
              "points in the box"),
        Check("mice_nonfinite_scores", float(np.sum(~np.isfinite(
            md._last_scores))), 0, "finite MICE scores"),
    ]

    mgp, obs = hm_case
    smc = smc_history_match(mgp, obs=obs, bounds=[[0.0, 1.0]] * mgp.D,
                            n_particles=smc_particles, n_stages=smc_stages,
                            n_mcmc=2, seed=0)
    checks += [
        Check("smc_nonfinite", float(np.sum(~np.isfinite(smc.particles))
                                     + np.sum(~np.isfinite(smc.implausibility))),
              0, "finite particles and implausibilities"),
        Check("smc_out_of_box", float(np.sum((smc.particles < 0)
                                             | (smc.particles > 1))), 0,
              "particles in the box"),
        Check("smc_nroy_fraction", float(smc.nroy_fraction), 1.0,
              "a fraction"),
    ]

    design = MaxiMinLHC(5).sample(50)
    strata = np.sort(np.floor(design * 50).astype(int), axis=0)
    checks += [
        Check("maximin_host_scorer", float(
            not experimental_design._use_device_scorer()), 0,
            "scoring runs on the device"),
        Check("maximin_not_lhc", float(np.sum(strata != np.arange(50)[:, None])),
              0, "one point per stratum and column"),
    ]
    return checks, None


# --- four devices ---------------------------------------------------------------

def _devices_line(tag, arr):
    ids = sorted(d.id for d in arr.sharding.device_set)
    print("  {} sharding.device_set ids={}".format(tag, ids), flush=True)
    return ids


def phase_mesh(n_dev=4, n_outputs=N_OUTPUTS, n_query=N_QUERY,
               n_coords=HM_COORDS, mcmc_outputs=16, mcmc_chains=8,
               mcmc_iters=100):
    """The cross-device paths over ``auto_mesh(n_dev)``, each against the
    same call on one device with the same seeds."""
    import jax
    import jax.numpy as jnp

    from mogp_tpu import (GaussianProcess, HistoryMatching, MultiOutputGP,
                          fit_GP_MAP)
    from mogp_tpu import sample_MOGP_MCMC, smc_history_match
    from mogp_tpu.models.fitting import _batched_fit_multi, _OPT_LADDER
    from mogp_tpu.models.gp import gp_predict
    from mogp_tpu.models.mogp import _stack_pytrees
    from mogp_tpu.parallel import (auto_mesh, sharded_fit_mogp,
                                   sharded_predict)
    from mogp_tpu.parallel.mesh import replicate, shard_leading

    mesh = auto_mesh(n_dev)
    all_ids = list(range(n_dev))
    t0 = time.perf_counter()

    def step(name):
        print("  mesh {} done at {:.1f} s".format(name, time.perf_counter()
                                                  - t0), flush=True)

    checks = []
    inputs, targets = tsunami_data(n_outputs)

    one = MultiOutputGP(inputs, targets, nugget="adaptive")
    np.random.seed(1)
    fit_GP_MAP(one, n_tries=N_TRIES, maxiter=MAXITER)
    many = MultiOutputGP(inputs, targets, nugget="adaptive")
    np.random.seed(1)
    sharded_fit_mogp(many, n_tries=N_TRIES, maxiter=MAXITER, mesh=mesh)
    nlp1 = np.array([em.current_logpost for em in one.emulators])
    nlp4 = np.array([em.current_logpost for em in many.emulators])
    # the sharded optimum re-evaluated on one device: the same arithmetic
    # whatever path each optimizer took
    nlp4_on_one = []
    for em1, em4 in zip(one.emulators, many.emulators):
        probe = GaussianProcess(inputs, em1.targets, nugget="adaptive")
        probe.fit(em4.theta.get_data())
        nlp4_on_one.append(probe.current_logpost)
    step("fit")
    print("  fit max|dNLP| sharded vs one device = {:.3e}".format(
        float(np.max(np.abs(nlp4 - nlp1)))), flush=True)
    checks += [
        Check("fit_refit_max_rel_dNLP", _rel(nlp4, np.array(nlp4_on_one)),
              TOL_NLP, "sharded NLP = one-device NLP at the same theta"),
        Check("fit_mean_rel_dNLP", _rel(np.mean(nlp4), np.mean(nlp1)),
              TOL_NLP, "sharded and one-device fits reach equal optima"),
    ]
    em0 = many.emulators[0]
    G = n_dev * max(1, min(4, n_outputs // n_dev))
    starts = shard_leading(jnp.zeros((G, N_TRIES, em0.n_params),
                                     em0._data.inputs.dtype), mesh)
    data = shard_leading(_stack_pytrees([em._data for em in
                                         many.emulators[:G]]), mesh)
    res = _batched_fit_multi(starts, data, em0.kernel, em0.nugget_type, 2,
                             None, None, _OPT_LADDER)
    ids = _devices_line("fit", res.x)
    checks.append(Check("fit_devices_missing", float(len(set(all_ids)
                                                         - set(ids))), 0,
                        "fit lanes on every device"))

    step("fit_devices")
    gp1 = sweep_gp()
    q = query_points(gp1.inputs, n_query, np.random.RandomState(2))
    r1 = gp1.predict(q, max_batch_size=PREDICT_TILE)
    mu4, var4 = sharded_predict(gp1, q, mesh=mesh,
                                max_batch_size=PREDICT_TILE)
    step("predict")
    y1 = _as_f64(gp1._data.targets)
    checks += [
        Check("predict_max_dmean/std_y", float(np.max(np.abs(mu4 - r1.mean))
                                               / np.std(y1)), TOL_MEAN,
              "sharded sweep vs one device"),
        Check("predict_max_rel_dvar", var_error(
            var4, r1.unc, float(np.exp(gp1.theta.get_data()[gp1.D]))),
              TOL_VAR, "sharded sweep vs one device, floor {:.0e} "
              "sigma2".format(TOL_VAR_ABS)),
    ]
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        mesh.axis_names[0], None))
    qj = jax.device_put(jnp.asarray(q[:n_dev * 1024], gp1._data.inputs.dtype),
                        spec)
    dm = jax.device_put(jnp.zeros((qj.shape[0], 0), qj.dtype), spec)
    mu_j, _ = gp_predict(replicate(gp1._artifacts, mesh),
                         replicate(gp1._data, mesh), qj, dm, gp1.kernel,
                         gp1.nugget_type, unc=True, include_nugget=True,
                         full_cov=False)
    ids = _devices_line("predict", mu_j)
    checks.append(Check("predict_devices_missing", float(len(
        set(all_ids) - set(ids))), 0, "queries on every device"))

    hmgp = smooth_mogp(n_outputs)
    sub1 = MultiOutputGP(inputs, smooth_targets(inputs, n_outputs)[
        :mcmc_outputs], nugget="adaptive")
    for em_s, em_o in zip(sub1.emulators, hmgp.emulators):
        em_s.fit(em_o.theta.get_data())
    kw = dict(n_samples=mcmc_iters, n_warmup=mcmc_iters, n_chains=mcmc_chains,
              seed=3)
    step("predict_devices")
    m1 = sample_MOGP_MCMC(sub1, **kw)
    step("mcmc_one")
    m4 = sample_MOGP_MCMC(sub1, mesh=mesh, **kw)
    step("mcmc_mesh")
    z = []
    for a, b in zip(m1, m4):
        sa, sb = a.samples.reshape(-1, a.samples.shape[-1]), b.samples.reshape(
            -1, b.samples.shape[-1])
        se = np.sqrt(sa.var(0) / np.maximum(a.ess, 1)
                     + sb.var(0) / np.maximum(b.ess, 1))
        z.append(np.max(np.abs(sa.mean(0) - sb.mean(0)) / np.maximum(se, 1e-12)))
    diff = max(float(np.max(np.abs(a.samples - b.samples)))
               for a, b in zip(m1, m4))
    print("  mcmc max|dsample|={:.3e}".format(diff), flush=True)
    checks.append(Check("mcmc_max_z", float(np.max(z)), 5.0,
                        "posterior means agree within 5 Monte Carlo s.e."))

    obs_mean, obs_var = _hm_obs(hmgp, 3)
    s1 = smc_history_match(hmgp, obs=[obs_mean, obs_var],
                           bounds=[[0.0, 1.0]] * hmgp.D,
                           n_particles=SMC_PARTICLES, n_stages=SMC_STAGES,
                           n_mcmc=2, seed=0)
    s4 = smc_history_match(hmgp, obs=[obs_mean, obs_var],
                           bounds=[[0.0, 1.0]] * hmgp.D,
                           n_particles=SMC_PARTICLES, n_stages=SMC_STAGES,
                           n_mcmc=2, seed=0, mesh=mesh)
    step("smc")
    checks += [
        Check("smc_dthreshold", _rel(s4.thresholds, s1.thresholds), TOL_I,
              "same tempering schedule"),
        Check("smc_dnroy_fraction", abs(s4.nroy_fraction - s1.nroy_fraction),
              0.05, "same NROY fraction"),
    ]

    coords = query_points(hmgp.emulators[0].inputs, n_coords,
                          np.random.RandomState(4))
    hm1 = HistoryMatching(gp=hmgp, obs=[obs_mean, obs_var], coords=coords)
    hm4 = HistoryMatching(gp=hmgp, obs=[obs_mean, obs_var], coords=coords,
                          mesh=mesh)
    I1 = np.asarray(hm1.get_implausibility(rank=1))
    step("hm_one")
    I4 = np.asarray(hm4.get_implausibility(rank=1))
    step("hm_mesh")
    near = np.abs(I1 - HM_THRESHOLD) <= TOL_I * HM_THRESHOLD
    checks += [
        Check("hm_max_rel_dI", _rel(I4, I1), TOL_I,
              "shard_map sweep vs one device"),
        Check("hm_nroy_mismatch", float(np.sum(((I4 <= HM_THRESHOLD)
                                                != (I1 <= HM_THRESHOLD))
                                               & ~near)), 0,
              "same NROY set"),
    ]
    ems = hmgp.emulators
    top = hm4._sharded_group_topk(
        ems, _stack_pytrees([em._artifacts for em in ems]),
        _stack_pytrees([em._data for em in ems]), coords[:n_dev * 8192],
        list(range(len(ems))), np.zeros(len(ems)), 2,
        ems[0]._data.inputs.dtype)
    ids = _devices_line("hm_sweep", top)
    checks.append(Check("hm_devices_missing", float(len(set(all_ids)
                                                        - set(ids))), 0,
                        "sweep on every device"))
    for d in jax.devices()[:n_dev]:
        stats = d.memory_stats() or {}
        print("  device {} peak_bytes_in_use={}".format(
            d.id, stats.get("peak_bytes_in_use")), flush=True)
    return checks, None


# --- entry point ------------------------------------------------------------------

def device_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, check=True, text=True,
    )
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the cross-device paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    print("phase device: devices={} platform={} kind={}".format(
        devices, dev.platform, dev.device_kind), flush=True)
    if dev.platform != "gpu":
        print("no GPU: JAX platform is {!r}".format(dev.platform),
              file=sys.stderr)
        return 1
    print("nvidia-smi: {}".format(device_line()), flush=True)
    count = 4 if args.four_gpus else 1
    if len(devices) < count:
        print("need {} GPUs, found {}".format(count, len(devices)),
              file=sys.stderr)
        return 1

    sys.path.insert(0, HERE)
    from mogp_tpu.config import enable_compile_cache

    enable_compile_cache()
    if args.four_gpus:
        run_phase("mesh", phase_mesh, n_dev=count)
    else:
        run_phase("fit", phase_fit)
        run_phase("predict", phase_predict)
        hm_case = run_phase("history_matching", phase_history_matching)
        run_phase("large_n", phase_large_n)
        run_phase("nan_lanes", phase_nan_lanes)
        run_phase("surface", phase_surface, hm_case)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--prior-ref"]:
        _prior_ref_child()
    else:
        sys.exit(main())
