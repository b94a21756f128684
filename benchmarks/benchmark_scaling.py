"""Mesh scaling benchmark: fit and prediction throughput vs device count.

Measures (a) batched MultiOutputGP MAP fitting with the outputs axis
sharded over 1/2/4/8 mesh devices and (b) query-sharded prediction
sweeps, reporting scaling efficiency vs the single-device run.

On CPU this exercises the virtual 8-device platform (run with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``);
on a multi-GPU host the same code shards over real devices.
"""

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _dcn_worker(process_id, num_processes, port, local_devices):
    """Worker body for the multi-process (DCN-axis) mode."""
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count={}".format(local_devices)
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from mogp_tpu.parallel import auto_mesh, init_distributed, sharded_fit_mogp
    import mogp_tpu

    init_distributed(coordinator_address="localhost:{}".format(port),
                     num_processes=num_processes, process_id=process_id)
    rng = np.random.RandomState(0)
    n, D, n_outputs = 64, 6, 16
    inputs = rng.rand(n, D)
    targets = np.stack(
        [np.sin((k % 5 + 1) * inputs[:, 0]) + inputs[:, 1]
         for k in range(n_outputs)]
    )
    mesh = auto_mesh()
    mgp = mogp_tpu.MultiOutputGP(inputs, targets)
    np.random.seed(3)
    sharded_fit_mogp(mgp, n_tries=4, mesh=mesh, maxiter=30)  # warm/compile
    mgp2 = mogp_tpu.MultiOutputGP(inputs, targets)
    np.random.seed(4)
    t0 = time.perf_counter()
    sharded_fit_mogp(mgp2, n_tries=4, mesh=mesh, maxiter=30)
    dt = time.perf_counter() - t0
    if process_id == 0:
        print("DCN {} processes x {} devices: {:.2f}s ({:.1f} fits/s) "
              "over the global {}-device mesh".format(
                  num_processes, local_devices, dt, n_outputs / dt,
                  num_processes * local_devices), flush=True)


def run_dcn_mode(num_processes, local_devices):
    """Spawn a multi-process jax.distributed run over localhost (the
    multi-host analogue on one machine; the same code path spans hosts)."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--dcn-worker", str(pid), str(num_processes), str(port),
             str(local_devices)],
            env=env,
        )
        for pid in range(num_processes)
    ]
    rc = [p.wait(timeout=900) for p in procs]
    assert all(r == 0 for r in rc), "DCN worker failed: {}".format(rc)


def main():
    import jax

    from common import print_table

    import mogp_tpu
    from mogp_tpu.parallel import auto_mesh, sharded_fit_mogp, sharded_predict

    n_dev_avail = len(jax.devices())
    print("devices available:", n_dev_avail)
    if jax.default_backend() == "cpu":
        print(
            "NOTE: virtual CPU devices share the same physical cores -- "
            "this run validates the sharded code paths, not scaling.  "
            "Scaling efficiency is meaningful on real devices."
        )

    rng = np.random.RandomState(0)
    n, D, n_outputs = 64, 6, 16
    inputs = rng.rand(n, D)
    targets = np.stack(
        [np.sin((k % 5 + 1) * inputs[:, 0]) + inputs[:, 1] for k in range(n_outputs)]
    )

    rows = []
    base_time = None
    for n_dev in [1, 2, 4, 8]:
        if n_dev > n_dev_avail:
            break
        mesh = auto_mesh(n_dev)
        np.random.seed(3)
        mgp = mogp_tpu.MultiOutputGP(inputs, targets)
        # warmup/compile
        sharded_fit_mogp(mgp, n_tries=4, mesh=mesh, maxiter=30)
        np.random.seed(4)
        mgp2 = mogp_tpu.MultiOutputGP(inputs, targets)
        t0 = time.perf_counter()
        sharded_fit_mogp(mgp2, n_tries=4, mesh=mesh, maxiter=30)
        dt = time.perf_counter() - t0
        if base_time is None:
            base_time = dt
        eff = base_time / (dt * n_dev)
        rows.append([n_dev, dt, n_outputs / dt, eff])
        print("{} devices: {:.2f}s  ({:.1f} fits/s, efficiency {:.2f})".format(
            n_dev, dt, n_outputs / dt, eff))

    print()
    print_table(["devices", "seconds", "fits_per_s", "efficiency"], rows)

    # prediction sweep scaling
    gp = mgp2.emulators[0]
    queries = rng.rand(200_000, D)
    pred_rows = []
    base = None
    for n_dev in [1, 2, 4, 8]:
        if n_dev > n_dev_avail:
            break
        mesh = auto_mesh(n_dev)
        sharded_predict(gp, queries[:1000], mesh=mesh)  # warm
        t0 = time.perf_counter()
        mu, var = sharded_predict(gp, queries, mesh=mesh)
        dt = time.perf_counter() - t0
        if base is None:
            base = dt
        pred_rows.append([n_dev, dt, len(queries) / dt / 1e6, base / (dt * n_dev)])
        print("predict {} devices: {:.2f}s ({:.2f}M pts/s)".format(
            n_dev, dt, len(queries) / dt / 1e6))

    print()
    print_table(["devices", "seconds", "Mpts_per_s", "efficiency"], pred_rows)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--dcn-worker":
        _dcn_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    int(sys.argv[5]))
    else:
        ap = argparse.ArgumentParser()
        ap.add_argument("--dcn", type=int, default=0, metavar="N_PROC",
                        help="run the multi-process (DCN-axis) mode with "
                             "N_PROC processes instead of the in-process sweep")
        ap.add_argument("--local-devices", type=int, default=4)
        args = ap.parse_args()
        if args.dcn:
            run_dcn_mode(args.dcn, args.local_devices)
        else:
            main()
