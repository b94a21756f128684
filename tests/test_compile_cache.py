"""Where the persistent compile cache goes (``config.enable_compile_cache``).

Each case runs in a child process, so the cache setting never leaks into
the rest of the suite.
"""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import jax
    import jax.numpy as jnp
    from mogp_tpu import config
    config._CHECKOUT = {checkout!r}
    config.enable_compile_cache()
    print("DIR", config.compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.jit(lambda x: jnp.sin(x) * 3.0 + x @ x)(jnp.ones((8, 8)))
""")


def _run(tmp_path, env_updates):
    checkout = str(tmp_path / "checkout")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_updates)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=ROOT, checkout=checkout)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return checkout, out.stdout


def _entries(path):
    return os.listdir(path) if os.path.isdir(path) else []


def test_cache_goes_to_env_dir_when_set(tmp_path):
    target = str(tmp_path / "envcache")
    checkout, stdout = _run(tmp_path, {"JAX_COMPILATION_CACHE_DIR": target})
    assert "DIR " + target in stdout
    assert _entries(target)
    assert not _entries(os.path.join(checkout, ".jax_cache"))


def test_cache_goes_to_checkout_when_env_unset(tmp_path):
    checkout, stdout = _run(tmp_path, {})
    target = os.path.join(checkout, ".jax_cache")
    assert "DIR " + target in stdout
    assert _entries(target)


# the package-named cache knob, removed in favour of JAX's variable
_OLD_KNOB = "mogp_tpu".upper() + "_COMPILE_CACHE"


def test_old_cache_knob_is_ignored(tmp_path):
    old = str(tmp_path / "oldknob")
    target = str(tmp_path / "envcache")
    _run(tmp_path, {_OLD_KNOB: old, "JAX_COMPILATION_CACHE_DIR": target})
    assert not os.path.exists(old)
    assert _entries(target)
