"""Large-n scaling benchmark: adaptive-nugget GP objective at n=512..4096.

The reference's large-n axis runs through f64 LAPACK on the host
(``mogp_emulator/linalg/cholesky.py:234-327``); here the K-build +
jitter-ladder Cholesky + marginalized-mean solve program runs on the
accelerator.  For each n this reports:

* ``t_fit``    -- time for the full fit-artifact program (``gp_fit``)
* ``TFLOP/s``  -- sustained rate (K build + ladder factorizations + solves)
* ``t_v&g``    -- time for one optimizer step (value+grad of ``gp_nlp``)
* ``nlp_rel``  -- relative error of the device NLP vs a CPU float64
  oracle evaluation of the same framework (run in a subprocess)

Usage: python benchmark_large_n.py [--sizes 512,1024,2048,4096] [--no-oracle]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

N_DIM = 8


def make_problem(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(n, N_DIM))
    y = np.sin(4 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2:].sum(axis=1)
    theta = np.concatenate([0.2 * np.ones(N_DIM), [0.5]])
    return x, y, theta


def oracle_nlp(n):
    """CPU float64 oracle NLP (same framework, LAPACK path) via subprocess."""
    code = (
        "import sys\n"
        "import jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark_large_n import make_problem\n"
        "from mogp_tpu import GaussianProcess\n"
        "x, y, theta = make_problem(%d)\n"
        "gp = GaussianProcess(x, y, nugget='adaptive')\n"
        "print('ORACLE', repr(float(gp.logposterior(theta))))\n"
        % (os.path.join(HERE, ".."), HERE, n)
    )
    # the oracle must not open the accelerator this process holds
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=900, env=env,
    )
    for line in out.stdout.splitlines():
        if line.startswith("ORACLE"):
            return float(line.split()[1])
    raise RuntimeError("oracle failed:\n" + out.stdout + out.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048,4096")
    ap.add_argument("--no-oracle", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]

    import jax

    from mogp_tpu import GaussianProcess
    from mogp_tpu.config import enable_compile_cache
    from mogp_tpu.models.gp import gp_nlp
    from mogp_tpu.utils.metrics import flops_gp_nlp

    enable_compile_cache()
    print("backend:", jax.devices()[0].platform, flush=True)
    results = []
    for n in sizes:
        x, y, theta = make_problem(n)
        gp = GaussianProcess(x, y, nugget="adaptive")
        dtype = gp._data.inputs.dtype
        raw = np.asarray(theta, dtype=np.float64)

        # fit-artifact program (K build + full ladder + solves); each
        # iteration ends in a host pull of the scalar log-posterior
        t0 = time.perf_counter()
        gp.fit(raw)
        nlp_dev = float(gp.current_logpost)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.iters):
            gp.fit(raw)
            nlp_dev = float(gp.current_logpost)
        t_fit = (time.perf_counter() - t0) / args.iters

        # one optimizer step: value+grad of the lean objective
        import jax.numpy as jnp

        vg = jax.jit(
            jax.value_and_grad(
                lambda r: gp_nlp(r, gp._data, gp.kernel, gp.nugget_type,
                                 sparse_ladder="single")
            )
        )
        rj = jnp.asarray(raw, dtype=dtype)
        float(vg(rj)[0])
        t0 = time.perf_counter()
        for _ in range(args.iters):
            v, g = vg(rj)
            v = float(v)
        t_vg = (time.perf_counter() - t0) / args.iters

        tflops = flops_gp_nlp(n, N_DIM) / t_fit / 1e12
        row = dict(n=n, t_fit_ms=t_fit * 1e3, tflops=tflops,
                   t_valgrad_ms=t_vg * 1e3, t_compile_s=t_compile,
                   nlp=nlp_dev)
        if not args.no_oracle:
            nlp64 = oracle_nlp(n)
            row["nlp_rel_err"] = abs(nlp_dev - nlp64) / max(abs(nlp64), 1e-12)
        results.append(row)
        print(
            "n={n:5d}  t_fit={t_fit_ms:9.2f} ms  {tflops:6.3f} TFLOP/s  "
            "t_v&g={t_valgrad_ms:9.2f} ms".format(**row)
            + ("  nlp_rel={:.2e}".format(row["nlp_rel_err"])
               if "nlp_rel_err" in row else ""),
            flush=True,
        )
    print(json.dumps({"metric": "large_n_sweep", "results": results}))


if __name__ == "__main__":
    main()
