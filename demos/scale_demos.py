"""Production-scale workflow demos: the three scale axes of the
framework, each runnable small (this script) and at full
scale (the corresponding scripts in ``benchmarks/``).

1. ``DeviceMICEDesign`` -- the MICE active-learning loop in two
   fixed-shape device programs (no per-step recompile; 1e5 candidates
   in ``benchmarks/benchmark_MICE.py --device-scale``).
2. Memory-bounded history-matching sweeps -- query tiling
   (``max_batch_size``) plus the fused on-device implausibility
   reduction (1e7 points x 64 outputs in ``benchmarks/benchmark_sweep.py``).
3. Segmented, checkpointed NUTS -- many-chain posterior sampling in
   bounded dispatches with preemption-safe resume.

Reference analogues: ``SequentialDesign.py`` (MICE),
``HistoryMatching.py`` + ``GaussianProcessGPU.py:608-626`` (batched
sweeps); the reference has no posterior sampling to checkpoint.
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mogp_tpu


def f(x):
    return np.sin(4.0 * x[0]) + x[1] ** 2


def device_mice_demo():
    print("-- DeviceMICEDesign: fixed-shape active learning --")
    np.random.seed(100)
    ed = mogp_tpu.LatinHypercubeDesign([(0.0, 1.0), (0.0, 1.0)])
    md = mogp_tpu.DeviceMICEDesign(
        ed, f, n_samples=5, n_init=8, n_cand=64, n_tries=5, maxiter=60
    )
    md.run_sequential_design()
    print("design grew to", md.inputs.shape, "- last acquisition theta:",
          np.round(md.get_current_theta(), 3))
    return md


def chunked_sweep_demo(md):
    print("-- memory-bounded history-matching sweep --")
    np.random.seed(101)
    gp = mogp_tpu.fit_GP_MAP(
        mogp_tpu.GaussianProcess(md.get_inputs(), md.get_targets()),
        n_tries=5,
    )
    coords = np.random.rand(5000, 2)
    hm = mogp_tpu.HistoryMatching(gp=gp, obs=[0.8, 0.01], coords=coords)
    # max_batch_size bounds device memory exactly like the reference GPU
    # class's batching; at >32768 points it engages automatically
    nroy = hm.get_NROY()
    print("NROY fraction over", len(coords), "points:",
          round(len(nroy) / len(coords), 3))


def checkpointed_nuts_demo():
    print("-- segmented, checkpointed NUTS --")
    np.random.seed(102)
    x = np.random.rand(25, 2)
    # observation noise identifies the fitted nugget (a noiseless target
    # sends the nugget posterior to -inf and the chains stick)
    y = np.array([f(xi) for xi in x]) + 0.05 * np.random.randn(25)
    gp = mogp_tpu.fit_GP_MAP(
        mogp_tpu.GaussianProcess(x, y, nugget="fit"), n_tries=4
    )
    from mogp_tpu.models.inference import sample_GP_MCMC

    ckpt = os.path.join(tempfile.mkdtemp(), "chains.npz")
    res = sample_GP_MCMC(
        gp, n_samples=200, n_warmup=100, n_chains=2, seed=0,
        theta0=gp.theta.get_data(), segment=50, checkpoint_path=ckpt,
    )
    # the checkpoint is written after every 50-iteration segment (a
    # preempted run restarted with the same arguments resumes from the
    # last completed segment) and removed on completion
    print("R-hat:", np.round(res.rhat, 3), " min ESS:",
          round(float(res.ess.min()), 1),
          " checkpoint cleaned up:", not os.path.exists(ckpt))


if __name__ == "__main__":
    md = device_mice_demo()
    chunked_sweep_demo(md)
    checkpointed_nuts_demo()
