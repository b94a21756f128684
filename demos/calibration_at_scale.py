"""BASELINE config 5, end-to-end: calibration at scale on one program
stack.

    gKDR dimension reduction (20-D -> K active dims)
      -> 100-output MultiOutputGP fit (batched MAP, 1500 L-BFGS lanes)
      -> segmented NUTS hyperparameter posteriors for every output
      -> SMC sampling of the joint NROY region
      -> fused on-device implausibility sweep over 10^7 query points

Each stage prints its wall-clock (not yet measured on the GPU; see
``PERF.md``).  The reference can
express only fragments of this workflow (``DimensionReduction.py``,
``MultiOutputGP.py`` + process pool, ``HistoryMatching.py`` grid sweep);
posterior sampling and SMC have no counterpart there.

Run:  python demos/calibration_at_scale.py            # demo scale
      python demos/calibration_at_scale.py --full     # BASELINE scale
                                                      # (1e7-point sweep)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mogp_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

import mogp_tpu
from mogp_tpu import gKDR


D_FULL = 20          # ambient input dimension
D_ACTIVE = 3         # true active subspace dimension
N_OUTPUTS = 100
N_TRAIN = 300


def simulator(x, w):
    """100 outputs driven by a 3-D active subspace of the 20-D input."""
    z = x @ w                        # (..., 3) active coordinates
    outs = []
    for g in range(N_OUTPUTS):
        a, b, c = 1 + 0.02 * g, 2 + 0.01 * g, 0.5 + 0.003 * g
        outs.append(
            np.sin(a * z[..., 0]) + b * z[..., 1] ** 2
            + c * np.cos(3 * z[..., 2]) * z[..., 0]
        )
    return np.stack(outs)            # (N_OUTPUTS, ...)


def main(full=False, seed=1):
    rng = np.random.RandomState(seed)
    w = np.linalg.qr(rng.randn(D_FULL, D_ACTIVE))[0]   # active subspace

    stage_t = {}

    def timed(name):
        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                stage_t[name] = time.perf_counter() - self.t0
                print("[{}] {:.1f} s".format(name, stage_t[name]),
                      flush=True)

        return _T()

    # training data
    lhd = mogp_tpu.LatinHypercubeDesign(D_FULL)
    X = lhd.sample(N_TRAIN)
    Y = simulator(X, w) + 0.01 * rng.randn(N_OUTPUTS, N_TRAIN)

    # 1. gKDR: recover the active subspace from data (reference
    #    DimensionReduction.py:121; here jitted Gram/eigh on device)
    with timed("gKDR"):
        dr = gKDR(X, Y[0], K=D_ACTIVE)
        Xr = dr(X)
    # subspace recovery quality (principal angle vs truth)
    overlap = np.linalg.svd(dr.B[:, :D_ACTIVE].T @ w)[1]
    print("  subspace overlap (singular values): {}".format(
        np.round(overlap, 3)))

    # 2. 100-output MOGP MAP fit on the reduced inputs: 100 x 15
    #    restarts = 1500 batched L-BFGS lanes, chunked per program
    with timed("fit-100-outputs"):
        np.random.seed(seed)
        mgp = mogp_tpu.fit_GP_MAP(
            mogp_tpu.MultiOutputGP(Xr, Y, nugget="adaptive"),
            n_tries=15, maxiter=50,
        )
    print("  fit {} / {} outputs".format(
        len(mgp.get_indices_fit()), N_OUTPUTS))

    # 3. segmented NUTS posterior over every output's hyperparameters
    #    (auto-segmented into bounded dispatches; checkpoint_path= would
    #    make this preemption-safe)
    from mogp_tpu.models.inference import sample_MOGP_MCMC

    n_chains, n_samples = (4, 200) if full else (2, 100)
    with timed("NUTS-posteriors"):
        results = sample_MOGP_MCMC(
            mgp, n_chains=n_chains, n_samples=n_samples,
            n_warmup=n_samples, seed=seed,
        )
    rhats = np.array([float(r.rhat.max()) for r in results])
    print("  {} outputs x {} chains x {} samples: {} outputs mixed "
          "(R-hat < 1.1), median R-hat {:.3f}, worst {:.3f}".format(
              len(results), n_chains, n_samples, int((rhats < 1.1).sum()),
              float(np.median(rhats)), float(rhats.max())))

    # observation: the simulator at a known input, with noise
    x_true = 0.5 + 0.1 * rng.randn(D_FULL)
    obs_mean = simulator(x_true[None, :], w)[:, 0]
    obs_var = np.full(N_OUTPUTS, 0.01)

    # 4. SMC: anneal a particle population onto the joint NROY region of
    #    the reduced space (rank-1 implausibility over 100 outputs)
    from mogp_tpu.uq.smc import smc_history_match

    lo, hi = Xr.min(axis=0), Xr.max(axis=0)
    with timed("SMC-NROY"):
        smc = smc_history_match(
            mgp, obs=[obs_mean, obs_var],
            bounds=np.stack([lo, hi], axis=1),
            n_particles=4096, n_stages=8, n_mcmc=3, seed=seed,
        )
    print("  NROY fraction of final particles: {:.3f}".format(
        smc.nroy_fraction))

    # 5. fused implausibility sweep: 10^7 (full) query points through the
    #    on-device predict + variance-sum + top-k reduction
    n_query = 10_000_000 if full else 1_000_000
    with timed("fused-sweep"):
        qs = mogp_tpu.LatinHypercubeDesign(
            [(float(a), float(b)) for a, b in zip(lo, hi)]
        ).sample(n_query)
        hm = mogp_tpu.HistoryMatching(
            gp=mgp, coords=qs, obs=[obs_mean, obs_var]
        )
        nroy = hm.get_NROY()
    print("  {} of {} query points NROY ({:.1f} kpts/s)".format(
        len(nroy), n_query, n_query / stage_t["fused-sweep"] / 1e3))

    print("\nstage wall-clock summary:")
    for k, v in stage_t.items():
        print("  {:<18} {:>8.1f} s".format(k, v))
    return stage_t


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="BASELINE scale (1e7-point sweep, 4x200 NUTS)")
    args = ap.parse_args()
    main(full=args.full)
