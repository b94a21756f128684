"""Accelerator demo: the reference GPU-demo workflow.

Counterpart of ``mogp_emulator/demos/gp_demo_gpu.py``: the reference
builds a ``GaussianProcessGPU`` and requires its CUDA extension; here
the GPU classes are aliases of the single implementation
(``mogp_tpu/compat.py``), so the same script runs on a GPU, the CPU, or
anything else JAX targets -- and scales over a device mesh instead of
one card.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mogp_tpu
from mogp_tpu.compat import GaussianProcessGPU, gpu_usable

# gpu_usable() is the reference's hardware gate (LibGPGPU.py:13); here
# it reports whether an accelerator backend is live
print("accelerator usable:", gpu_usable())

x = np.array(
    [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0], [1.0, 3.0, 5.0],
     [5.0, 3.0, 1.0], [2.0, 4.0, 6.0], [6.0, 4.0, 2.0], [3.0, 3.0, 3.0]]
)
y = np.array([2.0, 4.0, 6.0, 3.0, 3.0, 4.0, 4.0, 3.0])

# GaussianProcessGPU is the same class as GaussianProcess (compat alias)
gp = GaussianProcessGPU(x, y, nugget="adaptive")
gp = mogp_tpu.fit_GP_MAP(gp, n_tries=5)
print("fitted theta:", np.round(gp.theta.get_data(), 3))

x_predict = np.array([[2.0, 3.0, 4.0], [7.0, 8.0, 9.0]])
mean, var, _ = gp.predict(x_predict)
print("means:", np.round(mean, 3), " variances:", np.round(var, 5))

# multi-output: the reference's MultiOutputGP_GPU (OpenMP over one GPU)
# becomes a vmapped outputs axis, shardable over a mesh
from mogp_tpu.compat import MultiOutputGP_GPU

mgp = MultiOutputGP_GPU(x, np.stack([y, -y]), nugget="adaptive")
mgp = mogp_tpu.fit_GP_MAP(mgp, n_tries=3)
mu, _, _ = mgp.predict(x_predict)
print("multi-output means:\n", np.round(mu, 3))
