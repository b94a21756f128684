"""Multi-host (DCN-axis) validation without hardware.

Spawns two OS processes that each own 4 virtual CPU devices, joins them
with ``mogp_tpu.parallel.init_distributed`` (coordinator on localhost),
builds the 8-device global mesh, runs the sharded multi-output fit over
it, and checks parity with a single-process fit of the same seeded
problem.  This exercises the real ``jax.distributed`` runtime (process
groups, global device enumeration, cross-process GSPMD arrays) -- the
same code path a multi-host run uses (SURVEY §2.3(b), ``BASELINE.md``
multi-host scaling target).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.getcwd())
from mogp_tpu.parallel import init_distributed

init_distributed(
    coordinator_address="localhost:" + port, num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4

import numpy as np
from mogp_tpu import MultiOutputGP
from mogp_tpu.parallel import auto_mesh
from mogp_tpu.parallel.sharded import sharded_fit_mogp

# identical seeded problem on both hosts (SPMD: every process runs the
# same program over its addressable shards)
rng = np.random.RandomState(0)
x = rng.uniform(size=(24, 3))
w = rng.randn(8, 3)
y = np.sin(x @ w.T).T

mesh = auto_mesh(axis_names=("outputs",))
assert mesh.devices.size == 8

mgp = MultiOutputGP(x, y, nugget="adaptive")
np.random.seed(1)
mgp = sharded_fit_mogp(mgp, n_tries=2, mesh=mesh, maxiter=25)

nlps = np.array(
    [float(em.logposterior(em.theta.get_data())) for em in mgp.emulators]
)
assert np.all(np.isfinite(nlps)), nlps
print("RESULT", pid, " ".join("%.12g" % v for v in nlps), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_fit_parity(tmp_path):
    port = str(_free_port())
    worker_file = tmp_path / "dist_worker.py"
    worker_file.write_text(_WORKER)

    env = dict(os.environ)
    # children must build their own (smaller) virtual device topology and
    # must not inherit this process's 8-device flag
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_file), str(pid), port],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"

    # both processes must agree on the fitted NLPs (SPMD determinism)
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                parts = line.split()
                results[int(parts[1])] = np.array([float(v) for v in parts[2:]])
    assert set(results) == {0, 1}
    np.testing.assert_allclose(results[0], results[1], rtol=1e-8)

    # single-process oracle of the same seeded problem
    from mogp_tpu import MultiOutputGP
    from mogp_tpu.parallel import auto_mesh
    from mogp_tpu.parallel.sharded import sharded_fit_mogp

    rng = np.random.RandomState(0)
    x = rng.uniform(size=(24, 3))
    w = rng.randn(8, 3)
    y = np.sin(x @ w.T).T
    mgp = MultiOutputGP(x, y, nugget="adaptive")
    np.random.seed(1)
    mgp = sharded_fit_mogp(
        mgp, n_tries=2, mesh=auto_mesh(axis_names=("outputs",)), maxiter=25
    )
    local = np.array(
        [float(em.logposterior(em.theta.get_data())) for em in mgp.emulators]
    )
    np.testing.assert_allclose(results[0], local, rtol=1e-6)
