"""Marginalized-mean GP linear algebra (the ``linalg_utils`` layer).

Re-design of ``mogp_emulator/linalg/linalg_utils.py``: instead
of the reference's separate ``calc_Ainv`` / ``calc_mean_params`` /
``calc_R`` solves (``linalg_utils.py:5,96,132``; three K^-1 solves per
objective evaluation), everything the marginalized-mean math needs comes
from ONE stacked lower-triangular half-solve

    W = L^-1 [H | (y - m)]

because small triangular solves are latency-bound and the stacked RHS
amortizes both sweeps.  ``calc_A_deriv`` / ``logdet_deriv``
(``linalg_utils.py:42,170``) have no counterpart: gradients come from
``jax.grad`` of the log posterior.

This module is the single implementation used by both the fit-artifact
path and the lean optimizer objective (``models/gp.py``).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .cholesky import ChoFactor, fixed_cholesky

__all__ = ["MarginalCore", "marginal_core", "marginal_nlp", "dot_hp"]

# Full-f32 dot for everything derived from K^-1 (the precision rule in
# mogp_tpu/config.py).  A reduced-precision product (TF32 on the GPU) is
# catastrophic for A = Wh^T Wh when the design matrix is non-trivial and
# K is near-singular -- Wh = L^-1 H carries K^-1-amplified entries, and a
# short mantissa turns the mean coefficients into garbage (observed with
# bf16 products: linear-mean tsunami holdout rmse/std 5e4 vs 0.02 at
# full f32).  These dots are tiny (n x M, M <= ~16) next to the
# factorization, so HIGHEST costs nothing.
dot_hp = partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)


class MarginalCore(NamedTuple):
    """Artifacts of the stacked half-solve shared by fit and objective.

    ``W = L^-1 [H | (y-m)]`` split into ``Wh`` (n, M) and ``alpha`` (n,);
    ``Ainv`` factors ``A = H^T K^-1 H + B^-1`` (``linalg_utils.py:5-40``);
    ``H_Kinv_t = H^T K^-1 (y-m)``.
    """

    W: jnp.ndarray
    Wh: jnp.ndarray
    alpha: jnp.ndarray
    Ainv: ChoFactor
    H_Kinv_t: jnp.ndarray


def marginal_core(Kinv, dm, resid, mean_inv_cov):
    """One stacked half-solve giving the marginalized-mean artifacts.

    :param Kinv: covariance factor (``ChoFactor``/``PivotedChoFactor``).
    :param dm: design matrix ``H`` (n, M).
    :param resid: ``y - H b`` residual against the prior mean (n,).
    :param mean_inv_cov: ``B^-1`` (M, M) -- zeros for weak mean priors.
    """
    rhs = jnp.concatenate([dm, resid[:, None]], axis=1)
    W = Kinv.solve_L(rhs)
    Wh, alpha = W[:, :-1], W[:, -1]
    # A = H^T K^-1 H + B^-1 = Wh^T Wh + B^-1   (linalg_utils.py:5-40)
    A = dot_hp(Wh.T, Wh) + mean_inv_cov
    Ainv = ChoFactor(fixed_cholesky(A))
    H_Kinv_t = dot_hp(Wh.T, alpha)
    return MarginalCore(W=W, Wh=Wh, alpha=alpha, Ainv=Ainv, H_Kinv_t=H_Kinv_t)


def marginal_nlp(core: MarginalCore, Kinv, mean_logdet_cov, n_coeff):
    """Negative log marginal posterior data terms
    (``GaussianProcess.py:674-685``): quadratic form, the mean-
    marginalization correction, and all log-determinant terms."""
    return 0.5 * (
        dot_hp(core.alpha, core.alpha)
        - dot_hp(core.H_Kinv_t, core.Ainv.solve(core.H_Kinv_t))
        + Kinv.logdet()
        + core.Ainv.logdet()
        + mean_logdet_cov
        + n_coeff * jnp.log(2.0 * jnp.pi)
    )
