"""Hyperparameter coordinate transforms.

The framework stores GP hyperparameters as an unconstrained raw vector
``theta`` and maps it to the interpretable (constrained) values:

* correlation length ``l = exp(-theta/2)``   (reference:
  ``mogp_emulator/GPParams.py:34-80`` ``CorrTransform``)
* covariance / nugget ``sigma2 = exp(theta)`` (reference:
  ``mogp_emulator/GPParams.py:82-161`` ``CovTransform``)

Unlike the reference, derivative helpers (``dscaled_draw`` etc.) are not
needed: everything downstream is differentiated with ``jax.grad``.

The transforms dispatch on input type: JAX arrays/tracers go through
``jnp`` (so they stay jittable), everything else through numpy.  Host
callers (parameter views, prior sampling for optimizer restarts) would
otherwise pay one device round-trip PER SCALAR.
"""

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CorrTransform", "CovTransform"]


def _xp(x):
    """numpy for host values, jax.numpy for device values / tracers."""
    if isinstance(x, (jax.Array, jax.core.Tracer)):
        return jnp
    return np


class CorrTransform:
    """raw <-> correlation length: ``l = exp(-0.5 * theta)``."""

    @staticmethod
    def transform(raw):
        return _xp(raw).exp(-0.5 * raw)

    @staticmethod
    def inv_transform(scaled):
        return -2.0 * _xp(scaled).log(scaled)


class CovTransform:
    """raw <-> covariance / nugget: ``sigma2 = exp(theta)``."""

    @staticmethod
    def transform(raw):
        return _xp(raw).exp(raw)

    @staticmethod
    def inv_transform(scaled):
        return _xp(scaled).log(scaled)
