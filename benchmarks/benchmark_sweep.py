"""BASELINE config 5: history-matching implausibility sweep at scale.

A fitted MultiOutputGP is swept over ``--n-query`` points (default 1e7)
with memory-bounded query tiling (``max_batch_size`` chunking /
``gp_predict_tiled``), reporting points/sec and the NROY fraction, plus
an SMC history match on the same emulator.  The reference analogue is
``HistoryMatching.get_implausibility`` over large coords
(``HistoryMatching.py:197``) with the GPU class's ``max_batch_size``
batching (``GaussianProcessGPU.py:608-626``).

Usage:
  python benchmark_sweep.py [--n-query 10000000] [--n-outputs 64]
                            [--tile 32768] [--smc]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from mogp_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

N_POINTS, N_DIM = 210, 8


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-query", type=int, default=10_000_000)
    ap.add_argument("--n-outputs", type=int, default=64)
    ap.add_argument("--tile", type=int, default=32768)
    ap.add_argument("--smc", action="store_true")
    args = ap.parse_args()

    import jax

    from mogp_tpu import HistoryMatching, MultiOutputGP, fit_GP_MAP

    print("backend:", jax.devices()[0].platform, flush=True)
    rng = np.random.RandomState(3)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    w = rng.randn(args.n_outputs, N_DIM)
    targets = np.sin(inputs @ w.T).T + 0.1 * rng.randn(args.n_outputs, N_POINTS)

    np.random.seed(0)
    t0 = time.perf_counter()
    mgp = fit_GP_MAP(MultiOutputGP(inputs, targets), n_tries=5, maxiter=50)
    print("fit {} outputs in {:.1f}s".format(
        args.n_outputs, time.perf_counter() - t0), flush=True)

    obs = [[0.1] * args.n_outputs, [0.04] * args.n_outputs]

    # the sweep streams host->device in query chunks; generate the query
    # cloud once (float32 to halve host memory at 1e7 x D)
    queries = rng.uniform(0.0, 1.0, size=(args.n_query, N_DIM)).astype(
        np.float32
    )

    # first call compiles the fused device sweep (predict + top-k
    # implausibility reduction on device -- only (rank+1, n_query)
    # floats reach the host); second call is the timed figure
    hm = HistoryMatching(gp=mgp, obs=obs, coords=queries)
    t0 = time.perf_counter()
    hm.get_implausibility()
    print("warm sweep (compile+run): {:.1f}s".format(
        time.perf_counter() - t0), flush=True)

    hm = HistoryMatching(gp=mgp, obs=obs, coords=queries)
    t0 = time.perf_counter()
    hm.get_implausibility()
    dt = time.perf_counter() - t0
    nroy = len(hm.get_NROY()) / args.n_query
    print(
        "sweep: {:.3e} points x {} outputs in {:.1f}s = {:.3e} points/s "
        "(NROY fraction {:.3f})".format(
            args.n_query, args.n_outputs, dt, args.n_query / dt, nroy
        ),
        flush=True,
    )

    if args.smc:
        from mogp_tpu.uq.smc import smc_history_match

        t0 = time.perf_counter()
        res = smc_history_match(
            mgp.emulators[0], obs=[0.1, 0.04],
            bounds=[[0.0, 1.0]] * N_DIM,
            n_particles=65536, n_stages=6, n_mcmc=2, seed=0,
        )
        print("SMC: 65536 particles x 6 stages in {:.1f}s, NROY frac "
              "{:.3f}".format(time.perf_counter() - t0, res.nroy_fraction),
              flush=True)


if __name__ == "__main__":
    main()
