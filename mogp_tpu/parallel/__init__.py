"""Device-mesh parallelism: sharded batched fitting and prediction.

The reference's only distribution strategies are a host process pool
(``MultiOutputGP.py:306-309``, ``fitting.py:333-335``) and an OpenMP loop
(``mogp_gpu/src/multioutputgp_gpu.hpp``).  The equivalent here is a
``jax.sharding.Mesh``: outputs/restarts/query-points are batch axes of
one XLA program, annotated with shardings so GSPMD partitions the work
over devices and inserts any needed collectives (NCCL on GPUs).
"""

from .mesh import auto_mesh, init_distributed, replicate, shard_leading
from .sharded import sharded_fit_mogp, sharded_predict

__all__ = [
    "auto_mesh",
    "init_distributed",
    "replicate",
    "shard_leading",
    "sharded_fit_mogp",
    "sharded_predict",
]
