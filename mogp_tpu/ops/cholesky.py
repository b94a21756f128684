"""Nugget-aware Cholesky factorizations, jittable end-to-end.

Re-design of ``mogp_emulator/linalg/cholesky.py`` (and the CUDA
adaptive-jitter loop in ``mogp_gpu/src/densegp_gpu.hpp:524-562``):

* ``fixed_cholesky``  -- plain lower Cholesky (``cholesky.py:225``).
* ``jit_cholesky``    -- adaptive-jitter escalation (``cholesky.py:234``)
  expressed as a ``lax.while_loop`` over jitter exponents; a failed
  factorization is detected via the NaN fill that XLA produces for
  non-positive-definite inputs instead of a LAPACK info code.  Failure
  after ``maxtries`` yields an all-NaN factor, which propagates to a NaN
  log-posterior and reproduces the reference's skip-failed-restarts
  semantics (``fitting.py:252-255``) without host-side exceptions.
* ``pivoted_cholesky`` -- a jittable left-looking outer-product pivoted
  Cholesky replacing LAPACK ``dpstrf`` (``cholesky.py:284-327``), with the
  same synthetic decreasing diagonal for the rank-deficient tail so the
  log-determinant semantics match.  Solves mask out the rank-deficient
  directions ("collinear rows are skipped").

Factors are NamedTuple pytrees (``ChoFactor``, ``PivotedChoFactor``) so
they flow through ``jit``/``vmap``/``grad`` and can be stored in model
state; they expose the same ``solve`` / ``solve_L`` / ``logdet`` surface
as the reference's ``ChoInv`` / ``ChoInvPivot`` (``cholesky.py:6-165``).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import gammaln

# Above this n, the adaptive ladder factorizes its jitter candidates
# SEQUENTIALLY (lax.while_loop, stop at first success) instead of as one
# batched 6-candidate Cholesky: at large n each candidate is a large
# factorization, so the batched ladder wastes 4-5 of them in the common
# case where rung 0/1 succeeds; at small n per-factorization latency
# dominates and the batched form wins.  The threshold of 1024 was tuned
# on the previous accelerator and is not yet measured on the GPU.  Env:
# MOGP_TPU_PROGRESSIVE_LADDER_MIN_N (0 disables the progressive path).
import os as _os

_PROGRESSIVE_LADDER_MIN_N = int(
    _os.environ.get("MOGP_TPU_PROGRESSIVE_LADDER_MIN_N", "1024")
)
if _PROGRESSIVE_LADDER_MIN_N <= 0:
    _PROGRESSIVE_LADDER_MIN_N = 1 << 62

__all__ = [
    "ChoFactor",
    "PivotedChoFactor",
    "fixed_cholesky",
    "jit_cholesky",
    "pivoted_cholesky",
    "cholesky_factor",
]


def _chol(A):
    """Lower Cholesky (cuSOLVER on the GPU, LAPACK on the CPU); the
    factor's lower triangle is NaN when ``A`` is not positive definite,
    lane by lane in a batch -- the contract the jitter ladder rests on."""
    return lax.linalg.cholesky(A)


def _solve_lower(L, b):
    """Solve ``L x = b`` (lower triangular)."""
    return solve_triangular(L, b, lower=True)


def _solve_lower_t(L, b):
    """Solve ``L^T x = b`` (the upper sweep)."""
    return solve_triangular(L.T, b, lower=False)


class ChoFactor(NamedTuple):
    """Lower-triangular Cholesky factor with reference ``ChoInv`` surface.

    ``solve``/``solve_L``/``logdet`` mirror ``linalg/cholesky.py:22-79``.
    Zero-size factors (no mean parameters) are handled by shape, which is
    static under jit.
    """

    L: jnp.ndarray

    def solve(self, b):
        """Solve ``A x = b`` given ``A = L L^T`` (``cholesky.py:22``)."""
        if self.L.shape[0] == 0:
            return jnp.zeros_like(b)
        return _solve_lower_t(self.L, _solve_lower(self.L, b))

    def solve_L(self, b):
        """Solve ``L x = b`` (matrix square root solve, ``cholesky.py:44``)."""
        if self.L.shape[0] == 0:
            return jnp.zeros_like(b)
        return _solve_lower(self.L, b)

    def solve_from_half(self, w):
        """Complete a full solve from a half-solve: given ``w = solve_L(b)``,
        return ``solve(b)``.  Lets callers batch several right-hand sides
        into ONE stacked triangular solve and finish them together --
        small triangular solves are latency-bound, so one lower and one
        upper sweep over a stacked RHS replace two sweeps per RHS."""
        if self.L.shape[0] == 0:
            return jnp.zeros_like(w)
        return _solve_lower_t(self.L, w)

    def logdet(self):
        """``log det A = 2 sum log diag L`` (``cholesky.py:67``)."""
        if self.L.shape[0] == 0:
            return jnp.zeros((), dtype=self.L.dtype)
        return 2.0 * jnp.sum(jnp.log(jnp.diag(self.L)))


class PivotedChoFactor(NamedTuple):
    """Pivoted Cholesky factor (reference ``ChoInvPivot``, ``cholesky.py:82``).

    ``P`` is the pivot permutation (``A[P][:, P] ~= L L^T``), ``rank`` the
    numerical rank.  Solves drop components in the rank-deficient tail,
    implementing the documented "skip collinear rows" semantics.
    """

    L: jnp.ndarray
    P: jnp.ndarray
    rank: jnp.ndarray

    def _mask(self, x):
        idx = jnp.arange(x.shape[0])
        keep = idx < self.rank
        if x.ndim > 1:
            keep = keep.reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(keep, x, 0.0)

    def solve(self, b):
        """Permuted solve with rank masking (``cholesky.py:106-133``)."""
        y = self._mask(solve_triangular(self.L, b[self.P], lower=True))
        x = solve_triangular(self.L.T, y, lower=False)
        return x[jnp.argsort(self.P)]

    def solve_L(self, b):
        """Permuted triangular solve (``cholesky.py:135-165``)."""
        return self._mask(solve_triangular(self.L, b[self.P], lower=True))

    def solve_from_half(self, w):
        """Complete a full solve from ``w = solve_L(b)`` (see ``ChoFactor``):
        upper sweep + inverse permutation, rank masking already in ``w``."""
        x = solve_triangular(self.L.T, w, lower=False)
        return x[jnp.argsort(self.P)]

    def logdet(self):
        return 2.0 * jnp.sum(jnp.log(jnp.diag(self.L)))


def fixed_cholesky(A):
    """Cholesky decomposition with fixed noise level (``cholesky.py:225``)."""
    return _chol(A)


def jit_cholesky(A, maxtries=5, reuse_factor=True, sparse_ladder=False,
                 jitter_mask=None, progressive_ok=True):
    """Jittered Cholesky decomposition (``cholesky.py:234-281``).

    Tries an exact factorization and, on failure, diagonal jitter of
    ``mean(diag(A)) * 1e-6 * 10**k`` for ``k = 0..maxtries-1`` -- but
    instead of the reference's sequential retry loop (or a
    ``lax.while_loop``, which costs one factorization *latency* per
    attempt and compiles poorly when nested under vmapped optimizers),
    ALL candidate jitters are factorized in one batched Cholesky on a
    gradient-stopped copy and the first finite one is selected.  The
    extra FLOPs are negligible next to the latency of sequential small
    factorizations; the returned factor is recomputed once
    with the selected (gradient-stopped) jitter so reverse-mode autodiff
    is exact.

    :param jitter_mask: optional (n,) 0/1 vector restricting BOTH the
        jitter diagonal add and the mean-diagonal magnitude estimate to
        the marked rows.  Used by the fixed-shape (masked) MICE path,
        where padded rows carry a unit diagonal that must stay exactly 1
        so they contribute nothing to the log determinant.
    :returns: ``(ChoFactor, jitter)``; the factor is all-NaN if even the
              largest jitter fails (callers see a NaN log-posterior,
              reproducing the skip-failed-restart semantics).
    """
    A_sg = lax.stop_gradient(A)
    n = A.shape[0]
    if jitter_mask is None:
        mean_diag = jnp.mean(jnp.diag(A_sg))
        eye = jnp.eye(n, dtype=A.dtype)
    else:
        mean_diag = jnp.sum(jitter_mask * jnp.diag(A_sg)) / jnp.maximum(
            jnp.sum(jitter_mask), 1.0
        )
        eye = jnp.diag(jitter_mask.astype(A.dtype))

    if sparse_ladder == "single":
        # leanest optimization-phase path: ONE candidate, the reference
        # ladder's first nonzero rung 1e-6*mean(diag).  Saves two of the
        # three factorizations of the sparse ladder per objective
        # evaluation; points where even this jitter fails evaluate to NaN
        # and are rejected by the line search (the batched analogue of a
        # skipped LinAlgError restart, fitting.py:252-255).  Only the
        # optimizer's trajectory sees this; the final refit uses the
        # exact reference ladder.
        jitters = mean_diag * jnp.asarray([1e-6], dtype=A.dtype)
    elif sparse_ladder:
        # optimization-phase fast path: 3 candidates {0, 1e-6, 1e-2}*d
        # instead of the reference's 6-step ladder.  The candidate batch
        # is the dominant cost of every batched MAP objective evaluation
        # (6 Cholesky factorizations per eval); the sparse ladder spans
        # the same jitter range with coarser resolution.  Only the
        # optimizer's trajectory sees this; the final refit of the best
        # restart uses the exact reference ladder, so realized nuggets
        # and reported log-posteriors match the reference semantics.
        jitters = mean_diag * jnp.asarray([0.0, 1e-6, 1e-2], dtype=A.dtype)
    else:
        # candidates: [0, d*1e-6, d*1e-5, ..., d*1e-6*10**(maxtries-1)]
        exponents = jnp.power(
            jnp.asarray(10.0, dtype=A.dtype), jnp.arange(maxtries, dtype=A.dtype)
        )
        jitters = jnp.concatenate(
            [jnp.zeros((1,), dtype=A.dtype), mean_diag * 1e-6 * exponents]
        )
    if (
        progressive_ok
        and sparse_ladder is False
        and A.ndim == 2
        and n >= _PROGRESSIVE_LADDER_MIN_N
    ):
        # LARGE-n escalation: factorize candidates SEQUENTIALLY and stop
        # at the first finite one.  The batched all-candidates ladder
        # below is right for small matrices (the extra FLOPs are free
        # next to per-factorization latency, and it vectorizes cleanly
        # under vmapped optimizers), but at n >= ~1024 each candidate is
        # a large factorization and the common case (rung 0 or 1
        # succeeds) would waste 4-5 of them.  Static shape gate, so
        # small-n programs are untouched.
        def cond(c):
            k, _, ok = c
            return jnp.logical_and(jnp.logical_not(ok), k < jitters.shape[0])

        def body(c):
            k, _, _ = c
            Lk = _chol(A_sg + jitters[k] * eye)
            return k + 1, Lk, jnp.all(jnp.isfinite(Lk))

        k_end, L_last, any_ok = lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32),
                         jnp.full_like(A_sg, jnp.nan), jnp.array(False))
        )
        jitter = jnp.where(
            any_ok, jitters[jnp.maximum(k_end - 1, 0)],
            jnp.full((), jnp.nan, dtype=A.dtype),
        )
        if reuse_factor:
            L_sel = jnp.where(any_ok, L_last, jnp.full_like(L_last, jnp.nan))
            L = _chol_of_sum(A + jitter * eye, L_sel)
        else:
            L = _chol(A + jitter * eye)
        return ChoFactor(L), jitter

    batch = A_sg[None, :, :] + jitters[:, None, None] * eye[None, :, :]
    Ls = _chol(batch)  # one batched factorization, (maxtries+1, n, n)
    ok = jnp.all(jnp.isfinite(Ls), axis=(1, 2))
    idx = jnp.argmax(ok)  # first finite candidate
    jitter = jnp.where(
        jnp.any(ok), jitters[idx], jnp.full((), jnp.nan, dtype=A.dtype)
    )
    # Reuse the selected candidate factor as the primal result instead of
    # re-factorizing A + jitter*I; _chol_of_sum carries a custom VJP that
    # differentiates as if chol were applied to the (traced) sum, so
    # first-order gradients are exact while the forward pass costs zero
    # extra factorizations.  The custom VJP does not support higher-order
    # differentiation; callers needing Hessians pass
    # ``reuse_factor=False`` to re-factorize differentiably instead.
    if reuse_factor:
        L_sel = jnp.where(jnp.any(ok), Ls[idx], jnp.full_like(Ls[0], jnp.nan))
        L = _chol_of_sum(A + jitter * eye, L_sel)
    else:
        L = _chol(A + jitter * eye)
    return ChoFactor(L), jitter


@jax.custom_vjp
def _chol_of_sum(M, L_precomputed):
    """Return a precomputed Cholesky factor of ``M``, differentiable in
    ``M`` via the standard Cholesky pullback (so the forward pass can
    reuse a factor already computed on a gradient-stopped copy)."""
    return L_precomputed


def _chol_of_sum_fwd(M, L_precomputed):
    return L_precomputed, L_precomputed


def _chol_of_sum_bwd(L, L_bar):
    # Cholesky reverse rule: with S = Phi(L^T L_bar) (lower triangle,
    # halved diagonal), M_bar = 0.5 * sym(L^-T S L^-1).
    n = L.shape[0]
    S = jnp.tril(jnp.matmul(L.T, L_bar, precision=lax.Precision.HIGHEST))
    S = S - 0.5 * jnp.diag(jnp.diag(S))
    W = solve_triangular(L.T, S, lower=False)
    W = solve_triangular(L.T, W.T, lower=False).T
    M_bar = 0.5 * (W + W.T)
    return M_bar, jnp.zeros_like(L)


_chol_of_sum.defvjp(_chol_of_sum_fwd, _chol_of_sum_bwd)


def pivoted_cholesky(A):
    """Pivoted Cholesky decomposition (``cholesky.py:284-327``).

    Left-looking outer-product algorithm with greedy diagonal pivoting
    (the algorithm underlying LAPACK ``dpstrf``), expressed as a
    ``lax.fori_loop`` so it jits with static shapes.  Each step does an
    O(n) column update driven by one dense matvec, so total work is
    O(n^3)/2 in fused XLA ops.

    Rank determination uses the LAPACK ``dpstrf`` default tolerance
    ``n * eps * max(diag)``.  Diagonal entries in the rank-deficient tail
    are replaced with the synthetic decreasing sequence
    ``L[r-1, r-1] / ((r+1) * (r+2) * ... )`` exactly as the reference does
    (``cholesky.py:321-325``) so log-determinants agree; the factorial is
    evaluated via ``gammaln`` to avoid overflow for large n.

    :returns: ``PivotedChoFactor(L, P, rank)``.
    """
    n = A.shape[0]
    dtype = A.dtype
    eps = jnp.finfo(dtype).eps
    idx = jnp.arange(n)

    d0 = jnp.diag(A)
    tol = n * eps * jnp.max(d0)

    def swap_vec(v, i, j):
        vi, vj = v[i], v[j]
        return v.at[i].set(vj).at[j].set(vi)

    def swap_sym(M, i, j):
        M = M.at[i, :].set(M[j, :]).at[j, :].set(M[i, :])
        return M.at[:, i].set(M[:, j]).at[:, j].set(M[:, i])

    def body(k, state):
        W, d, perm, rank, active = state
        # greedy pivot: largest remaining Schur-complement diagonal
        j = jnp.argmax(jnp.where(idx >= k, d, -jnp.inf))
        W = swap_sym(W, k, j)
        d = swap_vec(d, k, j)
        perm = swap_vec(perm, k, j)

        pivot = d[k]
        active = jnp.logical_and(active, pivot > tol)

        lkk = jnp.sqrt(jnp.maximum(pivot, eps))
        # left-looking update: subtract contributions of columns < k
        row_k = jnp.where(idx < k, W[k, :], 0.0)
        col = (W[:, k] - jnp.dot(W, row_k, precision=lax.Precision.HIGHEST)) / lkk
        newcol = jnp.where(idx == k, lkk, jnp.where(idx > k, col, W[:, k]))
        W = jnp.where(active, W.at[:, k].set(newcol), W)
        d = jnp.where(active, jnp.where(idx > k, d - col**2, d), d)
        rank = rank + active.astype(jnp.int32)
        return W, d, perm, rank, active

    W0 = A
    perm0 = jnp.arange(n)
    rank0 = jnp.zeros((), dtype=jnp.int32)
    W, d, perm, rank, _ = lax.fori_loop(
        0, n, body, (W0, d0, perm0, rank0, jnp.array(True))
    )

    L = jnp.tril(W)
    # synthetic decreasing diagonal for the deficient tail:
    # L[i, i] = L[rank-1, rank-1] * rank! / (i+1)!   for i >= rank
    l_rr = L[jnp.maximum(rank - 1, 0), jnp.maximum(rank - 1, 0)]
    rank_f = rank.astype(dtype)
    synth = l_rr * jnp.exp(gammaln(rank_f + 1.0) - gammaln(idx.astype(dtype) + 2.0))
    diag_new = jnp.where(idx >= rank, synth, jnp.diag(L))
    # zero the (meaningless) off-diagonal entries of deficient columns
    col_ok = (idx < rank)[None, :]
    L = jnp.where(col_ok, L, 0.0)
    L = L.at[idx, idx].set(diag_new)
    return PivotedChoFactor(L, perm, rank)


def cholesky_factor(K, nugget, nugget_type, reuse_factor=True,
                    sparse_ladder=False, jitter_mask=None,
                    progressive_ok=True):
    """Dispatch factorization on nugget handling (``cholesky.py:168-193``).

    :param K: covariance matrix (without nugget).
    :param nugget: nugget value (traced scalar; ignored for ``adaptive`` /
                   ``pivot``).
    :param nugget_type: static string: ``"adaptive"``, ``"pivot"``,
                        ``"fit"`` or ``"fixed"``.
    :param jitter_mask: optional (n,) 0/1 vector restricting the nugget /
                        jitter diagonal add to the marked rows (masked
                        fixed-shape problems; not supported for
                        ``pivot``).
    :returns: ``(factor, nugget)`` where factor is a ``ChoFactor`` or
              ``PivotedChoFactor`` and nugget is the (possibly updated)
              nugget value.
    """
    if nugget_type == "adaptive":
        factor, nugget = jit_cholesky(
            K, reuse_factor=reuse_factor, sparse_ladder=sparse_ladder,
            jitter_mask=jitter_mask, progressive_ok=progressive_ok,
        )
    elif nugget_type == "pivot":
        assert jitter_mask is None, (
            "jitter_mask is not supported with pivoted factorization"
        )
        factor = pivoted_cholesky(K)
    elif nugget_type in ("fit", "fixed"):
        if jitter_mask is None:
            eye = jnp.eye(K.shape[0], dtype=K.dtype)
        else:
            eye = jnp.diag(jitter_mask.astype(K.dtype))
        Kn = K + nugget * eye
        factor = ChoFactor(fixed_cholesky(Kn))
    else:
        raise ValueError("Bad value for nugget_type in cholesky_factor")
    return factor, nugget
