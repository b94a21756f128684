"""Dimension reduction by gradient kernel dimension reduction (gKDR).

Re-design of ``mogp_emulator/DimensionReduction.py`` (gKDR of
Fukumizu & Leng).  The O(N^2 M) kernel-gradient contraction that builds
the ``R`` matrix -- a Python loop over N in the reference
(``DimensionReduction.py:218-223``) -- is a single jitted einsum
program; Gram matrices, the regularized solve, and the symmetric
eigendecomposition all run on device.
"""

import sys

import numpy as np
from scipy.spatial.distance import cdist, pdist, squareform

import jax
import jax.numpy as jnp

from ..utils import k_fold_cross_validation

__all__ = ["gram_matrix", "gram_matrix_sqexp", "median_dist", "gKDR"]


def gram_matrix(X, k):
    """Gram matrix under an arbitrary kernel callable
    (``DimensionReduction.py:77-93``)."""
    return cdist(X, X, k)


def gram_matrix_sqexp(X, sigma2):
    """Gram matrix under the squared-exponential kernel
    (``DimensionReduction.py:94-113``)."""
    return np.exp(-0.5 * squareform(pdist(X, "sqeuclidean")) / sigma2)


def median_dist(X):
    """Median pairwise Euclidean distance (``DimensionReduction.py:114-119``)."""
    return np.median(pdist(X))


@jax.jit
def _gkdr_projection(X, Y, SGX2, SGY2, EPS):
    """Device core: eigenvectors of the gKDR ``R`` matrix.

    Implements ``DimensionReduction.py:200-229``:
    ``F = (Kx + N eps I)^-1 Ky (Kx + N eps I)^-1``,
    ``H[i,j,m] = (X[i,m]-X[j,m])/SGX2 * Kx[i,j]``,
    ``R = sum_i H[i]^T F H[i]``, then ``eigh(R)`` sorted descending.
    """
    N = X.shape[0]

    def sq_gram(Z, s2):
        sq = jnp.sum(Z * Z, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.matmul(
            Z, Z.T, precision=jax.lax.Precision.HIGHEST
        )
        return jnp.exp(-0.5 * jnp.maximum(d2, 0.0) / s2)

    Kx = sq_gram(X, SGX2)
    Ky = sq_gram(Y, SGY2)

    reg = Kx + N * EPS * jnp.eye(N, dtype=X.dtype)
    L = jax.lax.linalg.cholesky(reg)

    def cho_solve(b):
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

    F = cho_solve(cho_solve(Ky).T).T

    # H[i,j,m] = (X[i,m] - X[j,m]) / SGX2 * Kx[i,j]
    H = (X[:, None, :] - X[None, :, :]) / SGX2 * Kx[:, :, None]
    # R = sum_i H[i]^T (F H[i])  ->  einsum over the contracted axes
    hi = jax.lax.Precision.HIGHEST
    FH = jnp.einsum("kl,ljm->kjm", F, H, precision=hi)
    R = jnp.einsum("kjm,kjn->mn", H, FH, precision=hi)

    evals, V = jnp.linalg.eigh(R)
    order = jnp.argsort(evals)[::-1]
    return V[:, order], evals[order]


class gKDR:
    """gKDR projection object (``DimensionReduction.py:121-250``).

    Callable: maps ``(N, M)`` inputs to the reduced ``(N, K)`` space via
    ``X @ B[:, :K]``.
    """

    def __init__(self, X, Y, K=None, X_scale=1.0, Y_scale=1.0, EPS=1e-8,
                 SGX=None, SGY=None):
        X = np.asarray(X, dtype=np.float64)
        N, M = X.shape
        if K is None:
            K = M
        assert 0 <= K <= M
        assert EPS >= 0
        assert SGX is None or SGX > 0.0
        assert SGY is None or SGY > 0.0

        Y = np.reshape(np.asarray(Y, dtype=np.float64), (N, 1))

        SGX = X_scale * median_dist(X) if SGX is None else SGX
        SGY = Y_scale * median_dist(Y) if SGY is None else SGY

        SGX2 = max(SGX * SGX, sys.float_info.min)
        SGY2 = max(SGY * SGY, sys.float_info.min)

        B, evals = _gkdr_projection(
            jnp.asarray(X), jnp.asarray(Y),
            jnp.asarray(SGX2), jnp.asarray(SGY2), jnp.asarray(EPS),
        )

        self.X_scale = X_scale
        self.Y_scale = Y_scale
        self.K = K
        self.B = np.asarray(B)
        self.evals = np.asarray(evals)

    def __call__(self, X):
        """Map inputs to the reduced space (``DimensionReduction.py:238-249``)."""
        return np.asarray(X) @ self.B[:, 0 : self.K]

    @staticmethod
    def _compute_loss(X, Y, train_model, cross_validation_folds, *params,
                      **kwparams):
        """Cross-validated L1 loss of a model on gKDR-reduced inputs
        (``DimensionReduction.py:252-306``)."""
        XY = np.hstack((X, Y[:, np.newaxis]))
        fold_losses = []
        for fold_train, fold_val in k_fold_cross_validation(
            XY, cross_validation_folds
        ):
            tr, va = np.array(fold_train), np.array(fold_val)
            dr = gKDR(tr[:, :-1], tr[:, -1], *params, **kwparams)
            model = train_model(dr(tr[:, :-1]), tr[:, -1])
            fold_losses.append(
                np.mean(np.abs(va[:, -1] - model(dr(va[:, :-1]))))
            )
        return np.mean(fold_losses)

    @classmethod
    def tune_parameters(cls, X, Y, train_model, cXs=None, cYs=None, maxK=None,
                        cross_validation_folds=5, verbose=False):
        """Grid/doubling search over (X_scale, Y_scale, K) minimizing
        cross-validated L1 loss (``DimensionReduction.py:309-456``)."""
        X = np.asarray(X)
        Y = np.asarray(Y)
        N, M = X.shape
        default_scales = (0.5, 1.0, 5.0)
        cXs = list(default_scales) if cXs is None else cXs
        cYs = list(default_scales) if cYs is None else cYs
        maxK = M if maxK is None else maxK
        assert 1 <= maxK <= M

        # K ladder: 1, 2, 4, ... capped at maxK (the reference walks the
        # same ladder with an inline doubling loop, DimensionReduction.py:421-449)
        k_ladder = []
        k = 1
        while k < maxK:
            k_ladder.append(k)
            k *= 2
        k_ladder.append(maxK)

        min_loss, argmin_loss = np.inf, None
        for cX in cXs:
            for cY in cYs:
                prev_loss = np.inf
                for k in k_ladder:
                    loss = gKDR._compute_loss(
                        X, Y, train_model, cross_validation_folds, k, cX, cY
                    )
                    if verbose:
                        print(
                            "loss(K={}, X_scale={}, Y_scale={}) = {}".format(
                                k, cX, cY, loss
                            )
                        )
                    if loss < min_loss:
                        min_loss, argmin_loss = loss, (k, cX, cY)
                    if loss > prev_loss:
                        break  # loss rising along the K ladder: stop early
                    prev_loss = loss

        dr = gKDR(X, Y, *argmin_loss)
        return (dr, min_loss)
