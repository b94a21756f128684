"""Composable symbolic mean functions.

Re-design of ``mogp_emulator/MeanFunction.py`` (~2 kLoC of
hand-derived parameter/input derivatives; C++ analogue
``mogp_gpu/src/meanfunc.hpp``): the same composable AST surface
(``MeanSum`` / ``MeanProduct`` / ``MeanPower`` / ``MeanComposite`` built
by the ``+ * ** ()`` operators, ``MeanFunction.py:326-467``) but every
derivative -- ``mean_deriv``, ``mean_hessian``, ``mean_inputderiv`` --
is produced by ``jax.jacfwd`` of the single ``mean_f`` definition, so
each node implements exactly one method.

Note the current reference ``GaussianProcess`` consumes *design
matrices* (patsy) rather than these objects at fit time
(``GaussianProcess.py:499-515``); this module exists for API parity, the
``MeanFunction()`` formula factory, and users composing parametric
means.
"""

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "MeanFunction",
    "MeanBase",
    "MeanSum",
    "MeanProduct",
    "MeanPower",
    "MeanComposite",
    "FixedMean",
    "ConstantMean",
    "LinearMean",
    "Coefficient",
    "PolynomialMean",
]


def MeanFunction(formula, inputdict={}, use_patsy=True):
    """Mean-function factory from a string formula
    (``MeanFunction.py:80-159``).

    ``formula`` may be a string (parsed with the native formula parser),
    an existing ``MeanBase``, or ``None`` (zero mean).
    """
    from .formula import mean_from_string

    if formula is None:
        return ConstantMean(0.0)
    if isinstance(formula, MeanBase):
        return formula
    if not isinstance(formula, str):
        raise ValueError("input formula must be a string or MeanBase instance")
    return mean_from_string(formula, inputdict)


class MeanBase:
    """Base class of the mean-function AST (``MeanFunction.py:160-485``).

    Subclasses implement ``get_n_params(x)`` and ``mean_f(x, params)``;
    all derivatives are supplied here via autodiff.
    """

    def get_n_params(self, x):
        raise NotImplementedError(
            "base mean function does not implement a particular function"
        )

    def mean_f(self, x, params):
        raise NotImplementedError(
            "base mean function does not implement a particular function"
        )

    def _coerce(self, x, params):
        x = jnp.asarray(x, dtype=jnp.result_type(float))
        if x.ndim == 1:
            x = x.reshape(-1, 1)
        params = jnp.atleast_1d(jnp.asarray(params, dtype=x.dtype))
        assert params.shape == (self.get_n_params(x),), (
            "bad number of parameters in mean function"
        )
        return x, params

    def __call__(self, *args):
        """Dual role matching the reference: called with another
        ``MeanBase``, builds a ``MeanComposite``
        (``MeanFunction.py:442-467``); called with ``(x, params)``,
        evaluates the mean."""
        if len(args) == 1 and isinstance(args[0], MeanBase):
            return MeanComposite(self, args[0])
        x, params = self._coerce(*args)
        return np.asarray(self.mean_f(x, params))

    def mean_deriv(self, x, params):
        """Gradient w.r.t. parameters, shape ``(n_params, n)``
        (``MeanFunction.py:254-277``); autodiff replaces the hand-derived
        implementations."""
        x, params = self._coerce(x, params)
        jac = jax.jacfwd(lambda p: self.mean_f(x, p))(params)
        return np.asarray(jnp.moveaxis(jnp.atleast_2d(jac), -1, 0))

    def mean_hessian(self, x, params):
        """Hessian w.r.t. parameters, shape ``(n_params, n_params, n)``
        (``MeanFunction.py:278-301``)."""
        x, params = self._coerce(x, params)
        hess = jax.jacfwd(jax.jacfwd(lambda p: self.mean_f(x, p)))(params)
        return np.asarray(jnp.moveaxis(hess, (-2, -1), (0, 1)))

    def mean_inputderiv(self, x, params):
        """Gradient w.r.t. inputs, shape ``(D, n)``
        (``MeanFunction.py:302-325``)."""
        x, params = self._coerce(x, params)

        def f_single(xi):
            return self.mean_f(xi.reshape(1, -1), params)[0]

        jac = jax.vmap(jax.jacfwd(f_single))(x)  # (n, D)
        return np.asarray(jac.T)

    # -- operator algebra (``MeanFunction.py:326-467``) ---------------------

    def __add__(self, other):
        if isinstance(other, MeanBase):
            return MeanSum(self, other)
        if isinstance(other, (float, int)):
            return MeanSum(self, ConstantMean(float(other)))
        raise TypeError("other function cannot be used in mean composition")

    def __radd__(self, other):
        if isinstance(other, (float, int)):
            return MeanSum(ConstantMean(float(other)), self)
        raise TypeError("other function cannot be used in mean composition")

    def __mul__(self, other):
        if isinstance(other, MeanBase):
            return MeanProduct(self, other)
        if isinstance(other, (float, int)):
            return MeanProduct(self, ConstantMean(float(other)))
        raise TypeError("other function cannot be used in mean composition")

    def __rmul__(self, other):
        if isinstance(other, (float, int)):
            return MeanProduct(ConstantMean(float(other)), self)
        raise TypeError("other function cannot be used in mean composition")

    def __pow__(self, exp):
        if isinstance(exp, (float, int, MeanBase)):
            return MeanPower(self, exp)
        raise TypeError("exponent in mean power must be a number or MeanBase")

    def __str__(self):
        return type(self).__name__


class _Binary(MeanBase):
    def __init__(self, f1, f2):
        assert isinstance(f1, MeanBase) and isinstance(f2, MeanBase), (
            "arguments to mean composition must be MeanBase instances"
        )
        self.f1 = f1
        self.f2 = f2

    def get_n_params(self, x):
        return self.f1.get_n_params(x) + self.f2.get_n_params(x)

    def _split(self, x, params):
        n1 = self.f1.get_n_params(x)
        return params[:n1], params[n1:]


class MeanSum(_Binary):
    """Sum of two mean functions (``MeanFunction.py:486-672``)."""

    def mean_f(self, x, params):
        p1, p2 = self._split(x, params)
        return self.f1.mean_f(x, p1) + self.f2.mean_f(x, p2)

    def __str__(self):
        return "({} + {})".format(self.f1, self.f2)


class MeanProduct(_Binary):
    """Product of two mean functions (``MeanFunction.py:673-871``)."""

    def mean_f(self, x, params):
        p1, p2 = self._split(x, params)
        return self.f1.mean_f(x, p1) * self.f2.mean_f(x, p2)

    def __str__(self):
        return "{}*{}".format(self.f1, self.f2)


class MeanPower(MeanBase):
    """Mean function raised to a power (``MeanFunction.py:872-1126``).

    The exponent may be a number or itself a ``MeanBase`` (e.g. a
    ``Coefficient`` for a fit exponent, as the formula parser produces).
    """

    def __init__(self, f, exp):
        assert isinstance(f, MeanBase)
        if not isinstance(exp, MeanBase):
            exp = ConstantMean(float(exp))
        self.f = f
        self.exp = exp

    def get_n_params(self, x):
        return self.f.get_n_params(x) + self.exp.get_n_params(x)

    def mean_f(self, x, params):
        n1 = self.f.get_n_params(x)
        base = self.f.mean_f(x, params[:n1])
        expval = self.exp.mean_f(x, params[n1:])
        return base**expval

    def __str__(self):
        return "({})^{}".format(self.f, self.exp)


class MeanComposite(_Binary):
    """Composition ``f1(f2(x))`` (``MeanFunction.py:1127-1296``): the inner
    function's scalar output becomes a 1-D input to the outer."""

    def mean_f(self, x, params):
        p1, p2 = self._split(x, params)
        inner = self.f2.mean_f(x, p2).reshape(-1, 1)
        return self.f1.mean_f(inner, p1)

    def get_n_params(self, x):
        x = jnp.asarray(x)
        inner_probe = jnp.zeros((1, 1))
        return self.f1.get_n_params(inner_probe) + self.f2.get_n_params(x)

    def _split(self, x, params):
        n1 = self.f1.get_n_params(jnp.zeros((1, 1)))
        return params[:n1], params[n1:]

    def __str__(self):
        return "{}({})".format(self.f1, self.f2)


class FixedMean(MeanBase):
    """Fixed (no-parameter) mean from a callable (``MeanFunction.py:1297-1582``)."""

    def __init__(self, f, deriv=None):
        assert callable(f), "fixed mean function must be callable"
        self.f = f
        self.deriv = deriv  # retained for API parity; autodiff is used

    def get_n_params(self, x):
        return 0

    def mean_f(self, x, params):
        return jnp.broadcast_to(jnp.asarray(self.f(x)), (x.shape[0],))

    def __str__(self):
        return "f"


class ConstantMean(FixedMean):
    """Fixed constant mean (``MeanFunction.py:1583-1622``)."""

    def __init__(self, val):
        self.val = float(val)
        super().__init__(lambda x: jnp.full((x.shape[0],), self.val))

    def __str__(self):
        return "c"


class LinearMean(FixedMean):
    """Fixed linear mean in one input dimension (``MeanFunction.py:1623-1668``)."""

    def __init__(self, index=0):
        self.index = int(index)
        super().__init__(lambda x: x[:, self.index])

    def __str__(self):
        return "x[{}]".format(self.index)


class Coefficient(MeanBase):
    """Single free fitting coefficient (``MeanFunction.py:1669-1811``)."""

    def get_n_params(self, x):
        return 1

    def mean_f(self, x, params):
        return jnp.broadcast_to(params[0], (x.shape[0],))

    def __str__(self):
        return "c"


class PolynomialMean(MeanBase):
    """Full polynomial mean of a given degree in every input dimension
    (``MeanFunction.py:1812-1996``): intercept + per-dimension powers."""

    def __init__(self, degree):
        assert int(degree) > 0, "degree must be a positive integer"
        self.degree = int(degree)

    def get_n_params(self, x):
        x = jnp.asarray(x)
        D = 1 if x.ndim == 1 else x.shape[1]
        return 1 + D * self.degree

    def mean_f(self, x, params):
        n, D = x.shape
        out = jnp.broadcast_to(params[0], (n,))
        idx = 1
        for d in range(D):
            for p in range(1, self.degree + 1):
                out = out + params[idx] * x[:, d] ** p
                idx += 1
        return out

    def __str__(self):
        return "polynomial mean of degree {}".format(self.degree)
