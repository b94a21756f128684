"""Factorization tests against scipy oracles.

Mirrors the reference's ``tests/test_linalg.py`` strategy: small SPD
fixtures, exact comparisons to LAPACK results.
"""

import numpy as np
import pytest
import scipy.linalg
from numpy.testing import assert_allclose
from scipy.linalg import lapack

import jax.numpy as jnp

from mogp_tpu.ops.cholesky import (
    ChoFactor,
    cholesky_factor,
    fixed_cholesky,
    jit_cholesky,
    pivoted_cholesky,
)


def make_spd(n, seed=0, jitter=0.0):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n)
    A = A @ A.T + n * np.eye(n) * 0.1 + jitter * np.eye(n)
    return A


@pytest.mark.parametrize("n", [3, 6, 8, 21, 64, 130, 300, 517])
def test_fixed_cholesky(n):
    A = make_spd(n)
    L = np.asarray(fixed_cholesky(jnp.asarray(A)))
    assert_allclose(L, scipy.linalg.cholesky(A, lower=True), rtol=1e-10,
                    atol=1e-12 * n)
    assert_allclose(np.triu(L, 1), 0.0)


@pytest.mark.parametrize("n", [6, 21, 130, 300])
def test_chofactor_solve_and_logdet(n):
    """Full solve, lower half-solve and the upper sweep that completes it
    (vector and 2-column right-hand sides) against LAPACK."""
    A = make_spd(n, seed=1)
    rng = np.random.RandomState(2)
    b = rng.randn(n)
    B = rng.randn(n, 2)
    f = ChoFactor(fixed_cholesky(jnp.asarray(A)))
    assert_allclose(np.asarray(f.solve(jnp.asarray(b))), np.linalg.solve(A, b), rtol=1e-9)
    assert_allclose(float(f.logdet()), np.linalg.slogdet(A)[1], rtol=1e-10)
    L = scipy.linalg.cholesky(A, lower=True)
    assert_allclose(
        np.asarray(f.solve_L(jnp.asarray(b))),
        scipy.linalg.solve_triangular(L, b, lower=True),
        rtol=1e-9,
    )
    W = f.solve_L(jnp.asarray(B))
    assert_allclose(np.asarray(W), scipy.linalg.solve_triangular(L, B, lower=True),
                    rtol=1e-9, atol=1e-12)
    assert_allclose(np.asarray(f.solve_from_half(W)), np.linalg.solve(A, B),
                    rtol=1e-8, atol=1e-12)


def test_fixed_cholesky_batched():
    """The jitter ladder factorizes a (candidates, n, n) batch in one call."""
    A = np.stack([make_spd(96, seed=s) for s in range(4)])
    L = np.asarray(fixed_cholesky(jnp.asarray(A)))
    for i in range(4):
        assert_allclose(L[i], scipy.linalg.cholesky(A[i], lower=True),
                        rtol=1e-10, atol=1e-12)


def test_fixed_cholesky_nan_lane_isolation():
    """A non-PD lane of a batch factorizes to NaN (its lower triangle) and
    leaves its neighbours exact -- the contract jit_cholesky's ladder
    selection rests on."""
    A = np.stack([make_spd(40, seed=s) for s in range(5)])
    A[2] -= 1e4 * np.eye(40)
    L = np.asarray(fixed_cholesky(jnp.asarray(A)))
    assert np.all(np.isnan(L[2][np.tril_indices(40)]))
    for i in (0, 1, 3, 4):
        assert_allclose(L[i], scipy.linalg.cholesky(A[i], lower=True),
                        rtol=1e-10, atol=1e-12)


def test_fixed_cholesky_grad():
    """d/dA [logdet(A)/2] through the factorization equals A^-1 / 2 (sym)."""
    import jax

    A = jnp.asarray(make_spd(80))

    def half_logdet(A):
        return jnp.sum(jnp.log(jnp.diagonal(fixed_cholesky(A))))

    g = np.asarray(jax.grad(half_logdet)(A))
    expect = 0.5 * np.linalg.inv(np.asarray(A))
    assert_allclose((g + g.T) / 2, (expect + expect.T) / 2, atol=1e-10)


def test_jit_cholesky_no_jitter_needed():
    A = make_spd(5, seed=3)
    f, jitter = jit_cholesky(jnp.asarray(A))
    assert float(jitter) == 0.0
    assert_allclose(np.asarray(f.L), scipy.linalg.cholesky(A, lower=True), rtol=1e-10)


def test_jit_cholesky_adds_jitter():
    """Reference semantics (cholesky.py:234-281): jitter starts at
    1e-6 * mean(diag) and escalates by 10x."""
    # a singular matrix: duplicated row/column
    A = make_spd(5, seed=4)
    A[4] = A[3]
    A[:, 4] = A[:, 3]
    f, jitter = jit_cholesky(jnp.asarray(A))
    assert float(jitter) > 0.0
    assert np.all(np.isfinite(np.asarray(f.L)))
    # factor reproduces A + jitter*I
    rec = np.asarray(f.L) @ np.asarray(f.L).T
    assert_allclose(rec, A + float(jitter) * np.eye(5), rtol=1e-6, atol=1e-8)


def test_jit_cholesky_hopeless_matrix_gives_nan():
    A = -np.eye(4)
    f, jitter = jit_cholesky(jnp.asarray(A))
    assert not np.all(np.isfinite(np.asarray(f.L)))


def test_pivoted_cholesky_full_rank_matches_lapack():
    A = make_spd(7, seed=5)
    f = pivoted_cholesky(jnp.asarray(A))
    L_ref, P_ref, rank_ref, info = lapack.dpstrf(A, lower=1)
    L_ref = np.tril(L_ref)
    assert int(f.rank) == rank_ref == 7
    assert_allclose(np.asarray(f.P), P_ref - 1)
    assert_allclose(np.asarray(f.L), L_ref, rtol=1e-8, atol=1e-10)


def test_pivoted_cholesky_solve():
    A = make_spd(7, seed=6)
    b = np.random.RandomState(7).randn(7)
    f = pivoted_cholesky(jnp.asarray(A))
    assert_allclose(np.asarray(f.solve(jnp.asarray(b))), np.linalg.solve(A, b), rtol=1e-8)


def test_pivoted_cholesky_rank_deficient():
    """Collinear rows are skipped; synthetic decreasing diagonal matches the
    reference construction (cholesky.py:321-325)."""
    A = make_spd(6, seed=8)
    A[5] = A[4]
    A[:, 5] = A[:, 4]
    f = pivoted_cholesky(jnp.asarray(A))
    rank = int(f.rank)
    assert rank == 5
    L = np.asarray(f.L)
    d = np.diag(L)
    # decreasing diagonal within the meaningful block, synthetic tail
    assert np.all(np.diff(d[:rank]) <= 1e-10)
    divs = np.cumprod(np.arange(rank + 1, 7, dtype=np.float64))
    assert_allclose(d[rank:], L[rank - 1, rank - 1] / divs, rtol=1e-6)
    # reconstruction on the meaningful block
    P = np.asarray(f.P)
    rec = L @ L.T
    assert_allclose(rec[:rank][:, :rank], A[P][:, P][:rank][:, :rank], rtol=1e-7, atol=1e-9)
    # solve of a consistent system ignores the collinear direction
    x = np.asarray(f.solve(jnp.asarray(A @ np.ones(6))))
    assert np.all(np.isfinite(x))


def test_cholesky_factor_dispatch():
    A = make_spd(5, seed=9)
    for nugget_type, nugget in [
        ("adaptive", 0.0),
        ("fit", 1e-4),
        ("fixed", 1e-4),
        ("pivot", 0.0),
    ]:
        f, nug = cholesky_factor(jnp.asarray(A), jnp.asarray(nugget), nugget_type)
        b = np.ones(5)
        target = A + (nugget if nugget_type in ("fit", "fixed") else 0.0) * np.eye(5)
        assert_allclose(
            np.asarray(f.solve(jnp.asarray(b))),
            np.linalg.solve(target, b),
            rtol=1e-7,
        )
    with pytest.raises(ValueError):
        cholesky_factor(jnp.asarray(A), 0.0, "bogus")


def test_empty_factor():
    f = ChoFactor(jnp.zeros((0, 0)))
    assert np.asarray(f.solve(jnp.zeros((0,)))).shape == (0,)
    assert float(f.logdet()) == 0.0


def test_progressive_ladder_matches_batched():
    """The large-n progressive (stop-at-first-success) ladder must EQUAL
    the batched all-candidates ladder: same selected jitter, same
    factor, same NaN semantics on hopeless inputs, same gradients
    (custom-VJP factor reuse applies to both paths)."""
    import jax

    import mogp_tpu.ops.cholesky as C

    rng = np.random.RandomState(0)
    n = 30
    X = rng.randn(n, 8)
    cases = {
        "pd": X @ X.T + n * np.eye(n),
        "needs_jitter": X[:, :2] @ X[:, :2].T,  # rank 2
        "hopeless": -np.eye(n),
    }
    saved = C._PROGRESSIVE_LADDER_MIN_N
    try:
        for name, A in cases.items():
            Aj = jnp.asarray(A)
            C._PROGRESSIVE_LADDER_MIN_N = 1
            f_prog, j_prog = C.jit_cholesky(Aj)
            C._PROGRESSIVE_LADDER_MIN_N = 10**9
            f_bat, j_bat = C.jit_cholesky(Aj)
            np.testing.assert_allclose(
                np.asarray(j_prog), np.asarray(j_bat), err_msg=name
            )
            np.testing.assert_allclose(
                np.asarray(f_prog.L), np.asarray(f_bat.L), equal_nan=True,
                err_msg=name,
            )

        def loss(Am, minn):
            C._PROGRESSIVE_LADDER_MIN_N = minn
            f, _ = C.jit_cholesky(Am)
            return f.logdet()

        A = jnp.asarray(cases["pd"])
        g1 = jax.grad(lambda M: loss(M, 1))(A)
        g2 = jax.grad(lambda M: loss(M, 10**9))(A)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2))
    finally:
        C._PROGRESSIVE_LADDER_MIN_N = saved
