"""Mesh construction and sharding helpers."""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["auto_mesh", "shard_leading", "replicate", "init_distributed"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize multi-process JAX (several hosts, or one process per
    GPU).

    Thin convenience over ``jax.distributed.initialize``: call once per
    process before building meshes; ``auto_mesh`` then spans the global
    device set, and the sharded fit/predict/MCMC paths run unchanged.
    Nothing on a plain GPU host tells JAX of a cluster, so pass all three
    arguments there (e.g. ``coordinator_address="localhost:<port>"``);
    they default only where a cluster environment JAX recognizes (e.g.
    SLURM) supplies them.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def auto_mesh(n_devices=None, axis_names=("outputs",), shape=None):
    """Build a ``Mesh`` over the available devices.

    :param n_devices: number of devices to use (default: all available).
    :param axis_names: logical axis names; default a single ``outputs``
                       axis (the embarrassingly-parallel direction of
                       multi-output GP work).
    :param shape: explicit mesh shape; default puts all devices on the
                  first axis.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    assert int(np.prod(shape)) == len(devices)
    dev_array = np.array(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def shard_leading(tree, mesh, axis_name=None):
    """Place a pytree on ``mesh`` with its leading axis sharded.

    Leaves whose leading dimension is not divisible by the mesh axis size
    are replicated instead (scalars, packed prior params, etc.).
    """
    axis_name = axis_name or mesh.axis_names[0]
    size = mesh.shape[axis_name]

    def put(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] % size == 0:
            spec = P(axis_name, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh):
    """Replicate a pytree across every device of the mesh."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )
