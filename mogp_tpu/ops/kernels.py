"""Stationary covariance kernels as pure, jittable functions.

Re-design of the reference kernel module (``mogp_emulator/Kernel.py``;
CUDA analogue ``mogp_gpu/src/kernel.cu``):

* The scaled squared distance is computed in *matmul form*
  ``r2 = |z1|^2 + |z2|^2 - 2 z1 z2^T`` with ``z = x * exp(theta/2)``, one
  matrix product that XLA fuses with the kernel function (the reference
  broadcasts differences, ``Kernel.py:444-480``; the CUDA backend uses a
  hand-written thread grid, ``kernel.cu:170-178``).
* Gradients/Hessians of the kernel with respect to the raw
  hyperparameters come from ``jax.jacfwd`` instead of the hand-derived
  expressions in ``Kernel.py:133-223`` and ``kernel.cu:69-141``.
* Kernel functions are evaluated with "safe sqrt" guards so that
  autodiff through the Matern-5/2 at r2=0 (the diagonal) is NaN-free.

Kernel *objects* are lightweight static descriptors (hashable, usable as
jit static args); all state lives in the arrays passed in.

Reference parity: ``SquaredExponential``, ``UniformSqExp``, ``Matern52``,
``UniformMat52``, ``ProductMat52`` (``Kernel.py:946-996``).
"""

import jax
import jax.numpy as jnp

__all__ = [
    "KernelBase",
    "SquaredExponential",
    "UniformSqExp",
    "Matern52",
    "UniformMat52",
    "ProductMat52",
    "sqexp",
    "mat52",
    "squared_distance",
    "get_kernel",
]


# ---------------------------------------------------------------------------
# Kernel functions of squared distance (element-wise work)
# ---------------------------------------------------------------------------

def sqexp(r2):
    """Squared-exponential kernel function ``K = exp(-r2/2)``.

    Reference: ``Kernel.py:791`` (``SqExpBase.calc_K``).
    """
    return jnp.exp(-0.5 * r2)


def mat52(r2):
    """Matern-5/2 kernel function ``K = (1 + sqrt(5 r2) + 5/3 r2) exp(-sqrt(5 r2))``.

    Reference: ``Kernel.py:882`` (``Mat52Base.calc_K``).  The double-where
    guard keeps ``jax.grad`` finite at ``r2 = 0`` (the sqrt has an infinite
    slope there; the true derivative contribution is zero because
    ``d r2/d theta = 0`` for coincident points).
    """
    pos = r2 > 0.0
    safe_r2 = jnp.where(pos, r2, 1.0)
    r = jnp.sqrt(5.0 * safe_r2)
    k = (1.0 + r + (5.0 / 3.0) * safe_r2) * jnp.exp(-r)
    return jnp.where(pos, k, 1.0)


_BASE_FNS = {"sqexp": sqexp, "mat52": mat52}


# ---------------------------------------------------------------------------
# Scaled squared distances (matmul work)
# ---------------------------------------------------------------------------

def squared_distance(x1, x2, exp_theta, symmetric=False):
    """All-pairs scaled squared Euclidean distance, in matmul form.

    ``r2[i, j] = sum_d exp_theta[d] * (x1[i, d] - x2[j, d])**2`` computed as
    ``|z1|^2 + |z2|^2 - 2 z1 z2^T`` with ``z = x * sqrt(exp_theta)`` so the
    dominant cost is a single matmul.  Values are clamped at zero to
    guard against cancellation error.

    Reference semantics: ``Kernel.py:444-480`` (``StationaryKernel.calc_r2``).

    :param x1: ``(n1, D)`` input array.
    :param x2: ``(n2, D)`` input array.
    :param exp_theta: ``(D,)`` or scalar per-dimension scale ``exp(theta)``.
    :param symmetric: ``x1`` and ``x2`` are the same points, so the
        diagonal is exactly zero.
    :returns: ``(n1, n2)`` matrix of scaled squared distances.
    """
    scale = jnp.sqrt(exp_theta)
    z1 = x1 * scale
    z2 = x2 * scale
    sq1 = jnp.sum(z1 * z1, axis=-1)
    sq2 = jnp.sum(z2 * z2, axis=-1)
    # full operand precision: in TF32 (the GPU's default for float32
    # products) the cancellation in ||z1||^2 + ||z2||^2 - 2 z1.z2 leaves
    # ~2 digits, which destroys the kernel matrix conditioning downstream
    cross = jnp.dot(
        z1, z2.T,
        preferred_element_type=z1.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    r2 = sq1[:, None] + sq2[None, :] - 2.0 * cross
    if symmetric:
        # the matmul form leaves rounding of order eps * |z|^2 where the
        # true value is 0; at short correlation lengths |z|^2 is large and
        # float32 K(x, x) lost ~1e-3 of its diagonal (NLP off by ~1e-3)
        r2 = jnp.where(jnp.eye(r2.shape[0], dtype=bool), 0.0, r2)
    return jnp.maximum(r2, 0.0)


def _product_kernel_matrix(x1, x2, raw_params, base_fn):
    """Per-dimension kernel product (reference ``ProductKernel.kernel_f``,
    ``Kernel.py:627-660``): apply the base kernel to each dimension's scaled
    squared distance, then multiply across dimensions.

    Scanned over D so peak memory stays O(n1*n2) instead of O(n1*n2*D).
    """
    exp_theta = jnp.exp(raw_params)

    def step(carry, operands):
        x1_d, x2_d, s_d = operands
        r2_d = s_d * (x1_d[:, None] - x2_d[None, :]) ** 2
        return carry * base_fn(r2_d), None

    init = jnp.ones((x1.shape[0], x2.shape[0]), dtype=x1.dtype)
    prod, _ = jax.lax.scan(step, init, (x1.T, x2.T, exp_theta))
    return prod


# ---------------------------------------------------------------------------
# Kernel descriptor objects (static configuration, no array state)
# ---------------------------------------------------------------------------

class KernelBase:
    """Static kernel descriptor.

    ``base``  -- kernel function family: ``"sqexp"`` or ``"mat52"``.
    ``form``  -- distance form: ``"stationary"`` (one correlation length per
    input dimension), ``"uniform"`` (single shared length), or ``"product"``
    (per-dimension kernel values multiplied together).

    Instances are immutable, hashable, and carry no data, so they can be
    passed as static arguments under ``jax.jit``.
    """

    base = "sqexp"
    form = "stationary"

    def get_n_params(self, inputs):
        """Number of correlation-length parameters for the given inputs.

        Reference: ``Kernel.py:16-32`` / ``Kernel.py:229-243``.
        """
        if self.form == "uniform":
            return 1
        inputs = jnp.asarray(inputs)
        assert inputs.ndim == 2, "Inputs must be a 2D array"
        return inputs.shape[1]

    # -- evaluation ---------------------------------------------------------

    def kernel_f(self, x1, x2, params):
        """Kernel matrix ``K(x1, x2)`` for raw parameters ``params``.

        Matches ``KernelBase.kernel_f`` (``Kernel.py:99-132``) for the
        respective concrete kernel class.
        """
        symmetric = x1 is x2
        x1, x2, params = self._coerce(x1, x2, params)
        base_fn = _BASE_FNS[self.base]
        if self.form == "product":
            return _product_kernel_matrix(x1, x2, params, base_fn)
        if self.form == "uniform":
            exp_theta = jnp.exp(params[0])
        else:
            exp_theta = jnp.exp(params)
        return base_fn(squared_distance(x1, x2, exp_theta,
                                        symmetric=symmetric))

    def calc_r2(self, x1, x2, params):
        """Scaled squared distances (``Kernel.py:444-480`` /
        ``Kernel.py:297-338`` for the uniform form; the product form
        returns per-dimension distances ``(D, n1, n2)`` matching
        ``Kernel.py:584-625``)."""
        x1, x2, params = self._coerce(x1, x2, params)
        exp_theta = jnp.exp(params)
        if self.form == "product":
            d2 = (x1[:, None, :] - x2[None, :, :]) ** 2 * exp_theta
            return jnp.moveaxis(d2, -1, 0)
        if self.form == "uniform":
            exp_theta = exp_theta[0]
        return squared_distance(x1, x2, exp_theta)

    def kernel_deriv(self, x1, x2, params):
        """Gradient of the kernel matrix w.r.t. the raw parameters.

        Shape ``(n_params, n1, n2)`` to match ``Kernel.py:133-174``; computed
        with forward-mode autodiff instead of hand-derived expressions.
        """
        x1, x2, params = self._coerce(x1, x2, params)
        jac = jax.jacfwd(lambda p: self.kernel_f(x1, x2, p))(params)
        return jnp.moveaxis(jac, -1, 0)

    def kernel_hessian(self, x1, x2, params):
        """Hessian of the kernel matrix w.r.t. the raw parameters.

        Shape ``(n_params, n_params, n1, n2)``; reference ``Kernel.py:175-223``.
        """
        x1, x2, params = self._coerce(x1, x2, params)
        hess = jax.jacfwd(jax.jacfwd(lambda p: self.kernel_f(x1, x2, p)))(params)
        return jnp.moveaxis(hess, (-2, -1), (0, 1))

    # -- plumbing -----------------------------------------------------------

    def _coerce(self, x1, x2, params):
        params = jnp.atleast_1d(jnp.asarray(params))
        x1 = jnp.asarray(x1)
        x2 = jnp.asarray(x2)
        if self.form == "uniform":
            if x1.ndim != 2:
                x1 = jnp.reshape(x1, (-1, 1))
            if x2.ndim != 2:
                x2 = jnp.reshape(x2, (-1, 1))
            assert params.shape == (1,), (
                "Uniform kernels only support a single correlation length"
            )
        else:
            D = params.shape[0]
            if x1.ndim != 2:
                x1 = jnp.reshape(x1, (-1, 1)) if D == 1 else jnp.reshape(x1, (1, D))
            if x2.ndim != 2:
                x2 = jnp.reshape(x2, (-1, 1)) if D == 1 else jnp.reshape(x2, (1, D))
            assert x1.shape[1] == D and x2.shape[1] == D, "bad shape for inputs"
        assert x1.shape[1] == x2.shape[1]
        return x1, x2, params

    # static-descriptor protocol -------------------------------------------

    def __hash__(self):
        return hash((type(self).__name__, self.base, self.form))

    def __eq__(self, other):
        return (
            isinstance(other, KernelBase)
            and self.base == other.base
            and self.form == other.form
        )

    def __repr__(self):
        return type(self).__name__ + "()"


class SquaredExponential(KernelBase):
    """Per-dimension-lengthscale squared exponential (``Kernel.py:946``)."""

    base, form = "sqexp", "stationary"

    def __str__(self):
        return "Squared Exponential Kernel"


class UniformSqExp(KernelBase):
    """Single-lengthscale squared exponential (``Kernel.py:956``)."""

    base, form = "sqexp", "uniform"

    def __str__(self):
        return "Squared Exponential Kernel"


class Matern52(KernelBase):
    """Per-dimension-lengthscale Matern 5/2 (``Kernel.py:966``)."""

    base, form = "mat52", "stationary"

    def __str__(self):
        return "Matern 5/2 Kernel"


class UniformMat52(KernelBase):
    """Single-lengthscale Matern 5/2 (``Kernel.py:976``)."""

    base, form = "mat52", "uniform"

    def __str__(self):
        return "Matern 5/2 Kernel"


class ProductMat52(KernelBase):
    """Product-form Matern 5/2 (``Kernel.py:986``)."""

    base, form = "mat52", "product"

    def __str__(self):
        return "Product Matern 5/2 Kernel"


_KERNELS = {
    "SquaredExponential": SquaredExponential,
    "UniformSqExp": UniformSqExp,
    "Matern52": Matern52,
    "UniformMat52": UniformMat52,
    "ProductMat52": ProductMat52,
}


def get_kernel(kernel):
    """Resolve a kernel argument (object or name string) to a descriptor.

    Mirrors the string dispatch in ``GaussianProcess.__init__``
    (``GaussianProcess.py:203-211``).
    """
    if isinstance(kernel, KernelBase):
        return kernel
    if isinstance(kernel, str):
        try:
            return _KERNELS[kernel]()
        except KeyError:
            raise ValueError(
                "provided kernel '{}' not a supported kernel type".format(kernel)
            )
    raise ValueError("provided kernel is not a subclass of KernelBase")
