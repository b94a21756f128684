"""Multi-output convergence benchmark: 8 Branin-like realizations.

Analogue of the reference ``benchmarks/benchmark_branin.py``:
fits a MultiOutputGP to 8 randomized Branin-variant surfaces at
increasing design sizes and verifies that held-out RMSE and mean
predictive variance fall with n -- the convergence property the
reference uses as its accuracy regression test.
"""

import time

import numpy as np

from common import branin, print_table

import mogp_tpu


def make_outputs(x, seed=0, n_outputs=8):
    rng = np.random.RandomState(seed)
    outs = []
    for k in range(n_outputs):
        a = 1.0 + 0.1 * rng.randn()
        s = 10.0 + rng.randn()
        outs.append(branin(x, a=a, s=s))
    return np.stack(outs)


def main():
    np.random.seed(12345)
    lhd = mogp_tpu.LatinHypercubeDesign([(-5.0, 10.0), (0.0, 15.0)])
    x_test = lhd.sample(200)
    y_test = make_outputs(x_test)

    rows = []
    for n in [10, 20, 40, 80]:
        x = lhd.sample(n)
        y = make_outputs(x)
        t0 = time.perf_counter()
        mgp = mogp_tpu.fit_GP_MAP(
            mogp_tpu.MultiOutputGP(x, y, nugget="adaptive"), n_tries=5
        )
        fit_time = time.perf_counter() - t0
        mean, var, _ = mgp.predict(x_test)
        rmse = float(np.sqrt(np.mean((mean - y_test) ** 2)))
        mean_var = float(np.mean(var))
        rows.append([n, rmse, mean_var, fit_time])
        print("n={}: rmse={:.4g} mean_var={:.4g} fit={:.2f}s".format(
            n, rmse, mean_var, fit_time))

    print()
    print_table(["n", "rmse", "mean_var", "fit_s"], rows)
    # convergence check: error must fall as the design grows
    assert rows[-1][1] < rows[0][1], "RMSE did not fall with design size"
    print("convergence check passed")


if __name__ == "__main__":
    main()
