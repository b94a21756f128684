"""Global configuration: dtype and precision policy, compile cache.

Dtype policy.  All core functions follow the dtype of their array
inputs; ``default_dtype()`` picks float64 when JAX x64 mode is enabled
(the CPU parity suite) and float32 otherwise.  The reference computes in
float64 throughout (``mogp_gpu/src/types.hpp:13``).  The GPU runs
float64 in hardware, but float32 stays the default until its cost and
benefit are measured on the card.

Precision rule.  On the GPU an unpinned float32 matrix product may run
in TF32, which keeps about three decimal digits.  Every contraction whose
operands come from the kernel matrix or its factor -- the pairwise
distance matmul (``ops.kernels.squared_distance``), everything derived
from ``K^-1`` (``ops.linalg.dot_hp``), and the optimizer, sampler and
design-scoring dot products -- therefore requests
``Precision.HIGHEST``.  ``tests/test_precision_audit.py`` traces the
main programs and fails on any float32 ``dot_general`` without it.
"""

import os

import jax
import jax.numpy as jnp

__all__ = ["default_dtype", "enable_compile_cache", "compile_cache_dir"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir():
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache for a script.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and no
    other directory is set here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache``.  Call before the first compilation.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = compile_cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # the fit programs are the ones worth caching, but cache everything:
    # entries are content-addressed and small next to one fit executable
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def default_dtype():
    """Return the default floating dtype for newly-created arrays.

    float64 when ``jax_enable_x64`` is on (used by the CPU parity test
    suite), float32 otherwise.
    """
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
