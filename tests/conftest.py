"""Test configuration: CPU parity mode.

The test suite runs the framework on CPU in float64 against numpy/scipy
oracles (the reference's test strategy: exact numerical oracles, see
reference ``mogp_emulator/tests/``).  An 8-device virtual CPU platform is
forced so mesh/sharding tests exercise real multi-device code paths
without accelerator hardware.  What runs only on the GPU is a phase of
``chip_smoke.py``.

This must run before any JAX backend is initialized (backends initialize
lazily, so overriding here works).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled programs after each test module.

    The full suite compiles thousands of unique CPU programs in one
    process; letting them accumulate has crashed the XLA CPU backend
    (segfault in ``backend_compile_and_load``) near the end of long
    runs.  Per-module clearing bounds the executable cache at a small
    recompile cost (the per-module working set is small)."""
    yield
    jax.clear_caches()
