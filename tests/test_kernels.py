"""Kernel parity tests against direct numpy oracles.

Oracle formulas follow the reference definitions: scaled squared distance
``r2 = sum_d exp(theta_d) (x1_d - x2_d)^2`` (``Kernel.py:444-480``),
SqExp ``exp(-r2/2)`` (``Kernel.py:791``), Matern-5/2
``(1 + sqrt(5 r2) + 5 r2/3) exp(-sqrt(5 r2))`` (``Kernel.py:882``).
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from mogp_tpu.ops.kernels import (
    Matern52,
    ProductMat52,
    SquaredExponential,
    UniformMat52,
    UniformSqExp,
    get_kernel,
)

rng = np.random.RandomState(1234)
X1 = rng.uniform(-2, 2, size=(7, 3))
X2 = rng.uniform(-2, 2, size=(5, 3))
PARAMS = rng.uniform(-1, 1, size=3)


def oracle_r2(x1, x2, params):
    exp_theta = np.exp(params)
    return np.sum(
        exp_theta * (x1[:, None, :] - x2[None, :, :]) ** 2, axis=-1
    )


def oracle_sqexp(r2):
    return np.exp(-0.5 * r2)


def oracle_mat52(r2):
    return (1.0 + np.sqrt(5.0 * r2) + 5.0 / 3.0 * r2) * np.exp(-np.sqrt(5.0 * r2))


def test_sqexp_matrix():
    K = np.asarray(SquaredExponential().kernel_f(X1, X2, PARAMS))
    assert_allclose(K, oracle_sqexp(oracle_r2(X1, X2, PARAMS)), rtol=1e-12)


def test_mat52_matrix():
    K = np.asarray(Matern52().kernel_f(X1, X2, PARAMS))
    assert_allclose(K, oracle_mat52(oracle_r2(X1, X2, PARAMS)), rtol=1e-12)


def test_uniform_kernels():
    p = PARAMS[:1]
    r2 = np.sum(np.exp(p[0]) * (X1[:, None, :] - X2[None, :, :]) ** 2, axis=-1)
    assert_allclose(
        np.asarray(UniformSqExp().kernel_f(X1, X2, p)), oracle_sqexp(r2), rtol=1e-12
    )
    assert_allclose(
        np.asarray(UniformMat52().kernel_f(X1, X2, p)), oracle_mat52(r2), rtol=1e-12
    )


def test_product_mat52():
    exp_theta = np.exp(PARAMS)
    r2_d = exp_theta * (X1[:, None, :] - X2[None, :, :]) ** 2
    expected = np.prod(oracle_mat52(r2_d), axis=-1)
    assert_allclose(
        np.asarray(ProductMat52().kernel_f(X1, X2, PARAMS)), expected, rtol=1e-12
    )


def test_diagonal_is_one():
    for k in [SquaredExponential(), Matern52(), ProductMat52()]:
        K = np.asarray(k.kernel_f(X1, X1, PARAMS))
        assert_allclose(np.diag(K), np.ones(len(X1)), rtol=1e-10)


@pytest.mark.parametrize(
    "kernel", [SquaredExponential(), Matern52(), UniformSqExp(), ProductMat52()]
)
def test_kernel_deriv_matches_fd(kernel):
    params = PARAMS[: (1 if kernel.form == "uniform" else 3)]
    deriv = np.asarray(kernel.kernel_deriv(X1, X2, params))
    assert deriv.shape == (len(params), len(X1), len(X2))
    eps = 1e-6
    for i in range(len(params)):
        pp = params.copy()
        pp[i] += eps
        pm = params.copy()
        pm[i] -= eps
        fd = (
            np.asarray(kernel.kernel_f(X1, X2, pp))
            - np.asarray(kernel.kernel_f(X1, X2, pm))
        ) / (2 * eps)
        assert_allclose(deriv[i], fd, rtol=1e-5, atol=1e-7)


def test_deriv_finite_at_zero_distance():
    """Matern autodiff must be NaN-free on the diagonal (r2 = 0)."""
    deriv = np.asarray(Matern52().kernel_deriv(X1, X1, PARAMS))
    assert np.all(np.isfinite(deriv))
    # coincident points: true derivative contribution is zero
    assert_allclose(deriv[:, np.arange(len(X1)), np.arange(len(X1))], 0.0, atol=1e-12)


def test_kernel_hessian_shape():
    hess = np.asarray(Matern52().kernel_hessian(X1, X2, PARAMS))
    assert hess.shape == (3, 3, len(X1), len(X2))
    assert np.all(np.isfinite(hess))


def test_get_n_params():
    assert SquaredExponential().get_n_params(X1) == 3
    assert UniformSqExp().get_n_params(X1) == 1
    assert ProductMat52().get_n_params(X1) == 3


def test_get_kernel_dispatch():
    assert get_kernel("Matern52") == Matern52()
    assert get_kernel(Matern52()) == Matern52()
    with pytest.raises(ValueError):
        get_kernel("NotAKernel")
    with pytest.raises(ValueError):
        get_kernel(1.5)


def test_1d_input_reshape():
    x1 = np.array([1.0, 2.0, 3.0])
    K = np.asarray(SquaredExponential().kernel_f(x1, x1, np.array([0.0])))
    assert K.shape == (3, 3)
    assert_allclose(K[0, 1], np.exp(-0.5), rtol=1e-12)


def test_calc_r2():
    r2 = np.asarray(SquaredExponential().calc_r2(X1, X2, PARAMS))
    assert_allclose(r2, oracle_r2(X1, X2, PARAMS), rtol=1e-10, atol=1e-12)
    r2u = np.asarray(UniformSqExp().calc_r2(X1, X2, PARAMS[:1]))
    assert r2u.shape == (len(X1), len(X2))
    r2p = np.asarray(ProductMat52().calc_r2(X1, X2, PARAMS))
    assert r2p.shape == (3, len(X1), len(X2))
    assert_allclose(r2p.sum(axis=0), oracle_r2(X1, X2, PARAMS), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kernel,oracle", [(SquaredExponential(), oracle_sqexp),
                                           (Matern52(), oracle_mat52)])
@pytest.mark.parametrize("shape", [(50, 37, 3), (130, 200, 14), (5, 5, 1)])
def test_kernel_matrix_matmul_form_matches_oracle(kernel, oracle, shape):
    """The predict-path cross covariance (matmul-form distance, fused by
    XLA) against the direct-difference oracle at the shapes of the
    sweep's tiles: ragged, D=14, and D=1."""
    n, m, D = shape
    r = np.random.RandomState(n + m + D)
    x1 = r.uniform(0.0, 1.0, size=(n, D))
    x2 = r.uniform(0.0, 1.0, size=(m, D))
    p = r.uniform(-1.0, 1.0, size=D)
    K = np.asarray(kernel.kernel_f(x1, x2, p))
    assert K.shape == (n, m)
    assert_allclose(K, oracle(oracle_r2(x1, x2, p)), rtol=1e-10, atol=1e-12)


def test_kernel_matrix_diag_is_one():
    """Coincident points give r2 = 0 exactly (clamped cancellation), so the
    kernel diagonal is 1 for both families."""
    z = np.random.RandomState(3).randn(64, 6)
    for kernel in (SquaredExponential(), Matern52()):
        K = np.asarray(kernel.kernel_f(z, z, np.zeros(6)))
        assert_allclose(np.diag(K), 1.0, atol=1e-12)


def test_symmetric_distance_has_exact_zero_diagonal():
    """K(x, x) gets an exactly zero-distance diagonal even at short
    correlation lengths, where the matmul form's rounding (of order
    eps * |z|^2) would otherwise shrink K's diagonal in float32."""
    import jax.numpy as jnp

    x = jnp.asarray(np.random.RandomState(5).uniform(size=(30, 14)),
                    jnp.float32)
    p = jnp.full((14,), 9.4, jnp.float32)
    K = np.asarray(SquaredExponential().kernel_f(x, x, p))
    assert np.all(np.diag(K) == 1.0)
    assert np.max(np.abs(K - np.eye(30))) < 1e-6
