"""Drop-in compatibility aliases for mogp-emulator code.

The reference ships device-specific classes (``GaussianProcessGPU``,
``MultiOutputGP_GPU``; soft-import gate ``LibGPGPU.gpu_usable()``)
alongside the CPU classes.  In this framework the single implementation
IS the accelerator implementation -- the same jitted programs run on
CPU or GPU -- so the device-specific names alias the standard classes.

Usage for code being migrated from the reference::

    from mogp_tpu.compat import GaussianProcessGPU, gpu_usable

    if gpu_usable():                      # is an accelerator available?
        gp = GaussianProcessGPU(x, y)     # same object as GaussianProcess
"""

import jax

from .models.gp import GaussianProcess
from .models.mogp import MultiOutputGP
from .ops.kernels import KernelBase, mat52, sqexp

__all__ = [
    "GaussianProcessGPU",
    "MultiOutputGP_GPU",
    "GPUUnavailableError",
    "gpu_usable",
    "StationaryKernel",
    "UniformKernel",
    "ProductKernel",
    "SqExpBase",
    "Mat52Base",
]

# kernel base-class aliases for reference imports
# (``from mogp_emulator.Kernel import StationaryKernel`` etc.); the
# reference's mixin hierarchy (``Kernel.py:224,419,581,765,853``)
# collapses to configuration fields here.
StationaryKernel = KernelBase
UniformKernel = KernelBase
ProductKernel = KernelBase


class SqExpBase:
    """Function-base alias (``Kernel.py:765``)."""

    calc_K = staticmethod(sqexp)


class Mat52Base:
    """Function-base alias (``Kernel.py:853``)."""

    calc_K = staticmethod(mat52)


class GPUUnavailableError(RuntimeError):
    """Raised by reference code when no GPU is available
    (``GaussianProcessGPU.py:24``); retained for except-clause
    compatibility.  This framework never raises it."""


# device-resident GP == the standard GP on an accelerator backend
GaussianProcessGPU = GaussianProcess
MultiOutputGP_GPU = MultiOutputGP


def gpu_usable():
    """Whether an accelerator backend is active (the analogue of
    ``LibGPGPU.gpu_usable``, ``LibGPGPU.py:13``)."""
    try:
        return jax.default_backend() not in ("cpu",)
    except RuntimeError:  # pragma: no cover
        return False
