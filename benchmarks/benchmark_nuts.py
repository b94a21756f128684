"""NUTS throughput benchmark: ESS/sec for GP hyperparameter posteriors.

The framework's second headline metric (BASELINE.json): effective
samples per second for the hyperparameter posterior of a tsunami-scale
GP, with chains vmapped (and shardable over a mesh).

``--chains N`` sets the chain count (large counts auto-segment into
bounded dispatches).  ``--mogp G`` instead samples the posteriors of a
G-output tsunami-scale MultiOutputGP (the BASELINE north-star
"100-output tsunami-scale emulator" configuration; outputs x chains
batched, segmented).
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
from mogp_tpu.models.inference import sample_GP_MCMC, sample_MOGP_MCMC
from mogp_tpu.utils.metrics import ess_per_sec


def main_mogp(n_outputs, n_chains=4, n_samples=200, n_warmup=200):
    rng = np.random.RandomState(0)
    n, D = 210, 14
    inputs = rng.uniform(0, 1, size=(n, D))
    w = rng.randn(n_outputs, D)
    targets = np.sin(inputs @ w.T).T + 0.1 * rng.randn(n_outputs, n)

    np.random.seed(0)
    t0 = time.perf_counter()
    mgp = mogp_tpu.fit_GP_MAP(
        mogp_tpu.MultiOutputGP(inputs, targets, nugget="fit"), n_tries=5,
        maxiter=50,
    )
    print("MAP fit {} outputs in {:.1f}s".format(
        n_outputs, time.perf_counter() - t0), flush=True)

    t0 = time.perf_counter()
    results = sample_MOGP_MCMC(
        mgp, n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
        seed=1,
    )
    dt = time.perf_counter() - t0
    min_ess = np.array([r.ess.min() for r in results])
    max_rhat = np.array([r.rhat.max() for r in results])
    print("{} outputs x {} chains x ({}+{}) in {:.1f}s".format(
        n_outputs, n_chains, n_warmup, n_samples, dt))
    print("per-output min-ESS: median {:.0f}, worst {:.0f}".format(
        np.median(min_ess), min_ess.min()))
    print("worst R-hat: {:.3f}".format(max_rhat.max()))
    print("aggregate min-ESS/s: {:.1f}".format(min_ess.sum() / dt))


def main(n_chains=8, n_samples=300, n_warmup=300):
    rng = np.random.RandomState(0)
    n, D = 210, 14
    inputs = rng.uniform(0, 1, size=(n, D))
    targets = np.sin(3 * inputs[:, 0]) + inputs[:, 1] ** 2 + 0.1 * inputs.sum(1)

    gp = mogp_tpu.fit_GP_MAP(
        mogp_tpu.GaussianProcess(inputs, targets, nugget="fit"), n_tries=5
    )
    print("MAP found, logpost = {:.2f}".format(gp.current_logpost))
    # warmup run compiles the program
    sample_GP_MCMC(gp, n_samples=10, n_warmup=10, n_chains=n_chains,
                   theta0=gp.theta.get_data(), seed=0)

    t0 = time.perf_counter()
    res = sample_GP_MCMC(
        gp, n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
        theta0=gp.theta.get_data(), seed=1,
    )
    dt = time.perf_counter() - t0

    total = n_chains * n_samples
    print("chains={} samples={} warmup={}: {:.1f}s".format(
        n_chains, n_samples, n_warmup, dt))
    print("R-hat: {}".format(np.round(res.rhat, 3)))
    print("ESS:   {}".format(np.round(res.ess, 0)))
    print("raw samples/s: {:.1f}".format(total / dt))
    print("min-ESS/s:     {:.2f}".format(ess_per_sec(res.ess, dt)))
    print("divergences:   {}".format(int(res.diverging.sum())))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=None,
                    help="chain count (default: 8 single-GP, 4 with --mogp)")
    ap.add_argument("--mogp", type=int, default=0,
                    help="sample a G-output MultiOutputGP instead")
    args = ap.parse_args()
    if args.mogp:
        main_mogp(args.mogp, n_chains=4 if args.chains is None else args.chains)
    else:
        main(n_chains=8 if args.chains is None else args.chains)
