"""Prior distributions over GP hyperparameters.

Re-design of ``mogp_emulator/Priors.py`` (C++ analogue
``mogp_gpu/src/gppriors.hpp``):

* Distribution objects (``NormalPrior``, ``LogNormalPrior``, ``GammaPrior``,
  ``InvGammaPrior``, ``WeakPrior``) keep the reference API surface
  (``logp`` / ``dlogpdx`` / ``dlogpdtheta`` / ``sample``,
  ``Priors.py:583-1150``) but their log-densities are written in jnp so
  they are jittable and differentiable.
* Every distribution also lowers to a *coded* representation
  ``(code, a, b)`` so that a whole prior set packs into three flat arrays.
  This is what makes the prior log-density **vmappable across outputs and
  restarts** in the batched MAP fit -- the reference loops over
  heterogeneous Python objects (``Priors.py:291-320``), which cannot
  batch.
* Gradients of the log-prior w.r.t. raw parameters come from ``jax.grad``
  of ``GPPriors.logp_raw``; the hand-derived chain-rule code
  (``Priors.py:321-392``, ``WeakPrior.dlogpdtheta``) survives only in the
  per-distribution API-parity methods.
* Data-driven default priors (``GPPriors.default_priors``,
  ``Priors.py:85-152``) do their scipy root solves on the host at model
  construction time -- they are not traced.
"""

import numpy as np
import scipy.stats
from scipy.optimize import root

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import gammaln

from ..ops.transforms import CorrTransform, CovTransform

__all__ = [
    "WeakPrior",
    "PriorDist",
    "NormalPrior",
    "LogNormalPrior",
    "GammaPrior",
    "InvGammaPrior",
    "MeanPriors",
    "GPPriors",
    "max_spacing",
    "min_spacing",
]

# distribution codes for the packed representation
DIST_WEAK = 0
DIST_NORMAL = 1
DIST_LOGNORMAL = 2
DIST_GAMMA = 3
DIST_INVGAMMA = 4

# transform codes
TRANSFORM_CORR = 0
TRANSFORM_COV = 1


# ---------------------------------------------------------------------------
# Coded (packed) log-density and sampling -- the batchable fast path
# ---------------------------------------------------------------------------

def _logp_weak(x, a, b):
    return jnp.zeros_like(x)


def _logp_normal(x, a, b):
    return -0.5 * ((x - a) / b) ** 2 - jnp.log(b) - 0.5 * jnp.log(2.0 * jnp.pi)


def _logp_lognormal(x, a, b):
    # a = shape, b = scale (Priors.py:863-925)
    return (
        -0.5 * (jnp.log(x / b) / a) ** 2
        - 0.5 * jnp.log(2.0 * jnp.pi)
        - jnp.log(x)
        - jnp.log(a)
    )


def _logp_gamma(x, a, b):
    # a = shape, b = scale (Priors.py:926-990)
    return -a * jnp.log(b) - gammaln(a) + (a - 1.0) * jnp.log(x) - x / b


def _logp_invgamma(x, a, b):
    # a = shape, b = scale (Priors.py:991-1150)
    return a * jnp.log(b) - gammaln(a) - (a + 1.0) * jnp.log(x) - b / x


_LOGP_BRANCHES = (_logp_weak, _logp_normal, _logp_lognormal, _logp_gamma, _logp_invgamma)


def dist_logp(code, a, b, x):
    """Log-density of distribution ``code`` with params ``(a, b)`` at the
    *transformed* value ``x``.  Branch-selected with ``lax.switch`` so it
    vmaps to an elementwise select across parameter slots."""
    return lax.switch(code, _LOGP_BRANCHES, x, a, b)


def dist_sample_raw(code, a, b, transform_code, key):
    """Draw one sample and convert to *raw* parameter space.

    Weak priors sample the raw value uniformly on [-2.5, 2.5]
    (``Priors.py:668``); proper distributions sample the transformed value
    and invert the transform (``Priors.py:790-803``).
    """
    k_norm, k_gamma, k_unif = jax.random.split(key, 3)
    z = jax.random.normal(k_norm, dtype=a.dtype)
    g = jax.random.gamma(k_gamma, jnp.maximum(a, 1e-12), dtype=a.dtype)
    u = jax.random.uniform(k_unif, dtype=a.dtype)

    x_normal = a + b * z
    x_lognormal = jnp.exp(a * z) * b
    x_gamma = g * b
    x_invgamma = b / jnp.maximum(g, 1e-30)

    x = jax.lax.switch(
        code,
        [
            lambda: jnp.ones_like(a),  # weak: placeholder, overridden below
            lambda: x_normal,
            lambda: x_lognormal,
            lambda: x_gamma,
            lambda: x_invgamma,
        ],
    )
    x_safe = jnp.maximum(x, 1e-300)
    raw = jnp.where(
        transform_code == TRANSFORM_CORR,
        CorrTransform.inv_transform(x_safe),
        CovTransform.inv_transform(x_safe),
    )
    weak_raw = 5.0 * (u - 0.5)
    return jnp.where(code == DIST_WEAK, weak_raw, raw)


# ---------------------------------------------------------------------------
# Distribution objects (API parity with Priors.py)
# ---------------------------------------------------------------------------

class WeakPrior:
    """Flat (improper) prior (``Priors.py:583-668``)."""

    code = DIST_WEAK

    @property
    def packed_params(self):
        return (1.0, 1.0)

    def logp(self, x):
        return jnp.zeros(())

    def dlogpdx(self, x):
        return jnp.zeros(())

    def d2logpdx2(self, x):
        return jnp.zeros(())

    def dlogpdtheta(self, x, transform):
        """Chain rule to raw parameters; autodiff equivalent retained for
        API parity (``Priors.py:620-640``)."""
        raw = transform.inv_transform(x)
        return float(jax.grad(lambda r: self.logp(transform.transform(r)))(raw))

    def d2logpdtheta2(self, x, transform):
        raw = transform.inv_transform(x)
        return float(
            jax.grad(jax.grad(lambda r: self.logp(transform.transform(r))))(raw)
        )

    def sample(self, transform=None):
        return float(5.0 * (np.random.rand() - 0.5))

    def sample_n(self, transform=None, n=1):
        """Vectorized :meth:`sample`: ``n`` draws in one RNG call."""
        return 5.0 * (np.random.rand(n) - 0.5)


class PriorDist(WeakPrior):
    """Base for proper prior distributions (``Priors.py:688-803``)."""

    @classmethod
    def default_prior(cls, min_val, max_val):
        """Fit distribution parameters so 99% of the mass lies in
        ``[min_val, max_val]`` (``Priors.py:697-758``)."""
        dist_map = {
            InvGammaPrior: scipy.stats.invgamma,
            GammaPrior: scipy.stats.gamma,
            LogNormalPrior: scipy.stats.lognorm,
        }
        if cls not in dist_map:
            raise ValueError(
                "Default prior must be invgamma, gamma, or lognormal"
            )
        dist_obj = dist_map[cls]

        assert min_val > 0.0, "min_val must be positive"
        assert max_val > 0.0, "max_val must be positive"
        assert min_val < max_val, "min_val must be less than max_val"

        def f(x):
            cdf = dist_obj(np.exp(x[0]), scale=np.exp(x[1])).cdf
            return np.array([cdf(min_val) - 0.005, cdf(max_val) - 0.995])

        result = root(f, np.zeros(2))
        if not result["success"]:
            print("Prior solver failed to converge")
            return WeakPrior()
        return cls(np.exp(result["x"][0]), np.exp(result["x"][1]))

    @classmethod
    def default_prior_corr(cls, inputs):
        """Default prior from min/max input spacing (``Priors.py:760-780``)."""
        min_val = min_spacing(inputs)
        max_val = max_spacing(inputs)
        if min_val == 0.0 or max_val == 0.0:
            print("Too few unique inputs; defaulting to flat priors")
            return WeakPrior()
        return cls.default_prior(min_val, max_val)

    def sample_x(self):
        raise NotImplementedError("PriorDist does not implement a sampler")

    def sample(self, transform):
        return float(np.asarray(transform.inv_transform(self.sample_x())))

    def sample_x_n(self, n):
        """Vectorized :meth:`sample_x`; subclasses draw ``rvs(size=n)``."""
        return np.array([self.sample_x() for _ in range(n)])

    def sample_n(self, transform, n=1):
        """``n`` raw-space samples in one vectorized draw."""
        return np.asarray(transform.inv_transform(self.sample_x_n(n)))

    def dlogpdx(self, x):
        return float(jax.grad(self.logp)(jnp.asarray(x, dtype=jnp.result_type(float))))

    def d2logpdx2(self, x):
        return float(
            jax.grad(jax.grad(self.logp))(jnp.asarray(x, dtype=jnp.result_type(float)))
        )


class NormalPrior(PriorDist):
    """Normal prior on the transformed value (``Priors.py:806-862``)."""

    code = DIST_NORMAL

    def __init__(self, mean, std):
        assert std > 0.0, "std parameter must be positive"
        self.mean = float(mean)
        self.std = float(std)

    @property
    def packed_params(self):
        return (self.mean, self.std)

    def logp(self, x):
        return _logp_normal(jnp.asarray(x), self.mean, self.std)

    def sample_x(self):
        return float(scipy.stats.norm.rvs(size=1, loc=self.mean, scale=self.std)[0])

    def sample_x_n(self, n):
        return scipy.stats.norm.rvs(size=n, loc=self.mean, scale=self.std)


class LogNormalPrior(PriorDist):
    """Lognormal prior, params (shape, scale) (``Priors.py:863-925``)."""

    code = DIST_LOGNORMAL

    def __init__(self, shape, scale):
        assert shape > 0.0, "shape must be greater than zero"
        assert scale > 0.0, "scale must be greater than zero"
        self.shape = float(shape)
        self.scale = float(scale)

    @property
    def packed_params(self):
        return (self.shape, self.scale)

    def logp(self, x):
        return _logp_lognormal(jnp.asarray(x), self.shape, self.scale)

    def sample_x(self):
        return float(
            scipy.stats.lognorm.rvs(size=1, s=self.shape, scale=self.scale)[0]
        )

    def sample_x_n(self, n):
        return scipy.stats.lognorm.rvs(size=n, s=self.shape, scale=self.scale)


class GammaPrior(PriorDist):
    """Gamma prior, params (shape, scale) (``Priors.py:926-990``)."""

    code = DIST_GAMMA

    def __init__(self, shape, scale):
        assert shape > 0.0, "shape parameter must be positive"
        assert scale > 0.0, "scale parameter must be positive"
        self.shape = float(shape)
        self.scale = float(scale)

    @property
    def packed_params(self):
        return (self.shape, self.scale)

    def logp(self, x):
        return _logp_gamma(jnp.asarray(x), self.shape, self.scale)

    def sample_x(self):
        return float(scipy.stats.gamma.rvs(size=1, a=self.shape, scale=self.scale)[0])

    def sample_x_n(self, n):
        return scipy.stats.gamma.rvs(size=n, a=self.shape, scale=self.scale)


class InvGammaPrior(PriorDist):
    """Inverse-gamma prior, params (shape, scale) (``Priors.py:991-1150``)."""

    code = DIST_INVGAMMA

    def __init__(self, shape, scale):
        assert shape > 0.0, "shape parameter must be positive"
        assert scale > 0.0, "scale parameter must be positive"
        self.shape = float(shape)
        self.scale = float(scale)

    @property
    def packed_params(self):
        return (self.shape, self.scale)

    @classmethod
    def default_prior_mode(cls, min_val, max_val):
        """Mode-anchored default: mode at the geometric mean of
        (min_val, max_val), 99.5% of mass below max_val
        (``Priors.py:1012-1055``)."""
        assert min_val > 0.0
        assert max_val > 0.0
        assert min_val < max_val, "min_val must be less than max_val"

        mode = np.sqrt(min_val * max_val)

        def f(x):
            a = np.exp(x)
            return (
                scipy.stats.invgamma(a, scale=(1.0 + a) * mode).cdf(max_val) - 0.995
            )

        result = root(f, 0.0)
        if not result["success"]:
            print("Prior solver failed to converge")
            return WeakPrior()
        a = float(np.exp(result["x"][0]))
        return cls(a, scale=(1.0 + a) * mode)

    @classmethod
    def default_prior_corr_mode(cls, inputs):
        """Mode-anchored default from input spacing (``Priors.py:1057-1081``)."""
        min_val = min_spacing(inputs)
        max_val = max_spacing(inputs)
        if min_val == 0.0 or max_val == 0.0:
            print("Too few unique inputs; defaulting to flat priors")
            return WeakPrior()
        return cls.default_prior_mode(min_val, max_val)

    @classmethod
    def default_prior_nugget(cls, min_val=1.0e-8, max_val=1.0e-6):
        """Small-nugget default (``Priors.py:1083-1103``)."""
        return cls.default_prior_mode(min_val, max_val)

    def logp(self, x):
        return _logp_invgamma(jnp.asarray(x), self.shape, self.scale)

    def sample_x(self):
        return float(
            scipy.stats.invgamma.rvs(size=1, a=self.shape, scale=self.scale)[0]
        )

    def sample_x_n(self, n):
        return scipy.stats.invgamma.rvs(size=n, a=self.shape, scale=self.scale)


# ---------------------------------------------------------------------------
# Mean priors
# ---------------------------------------------------------------------------

class MeanPriors:
    """Multivariate-normal prior on mean coefficients (``Priors.py:423-581``).

    ``mean is None`` indicates weak prior information; all methods then
    return zeros of the right shape so the marginalized-mean math works
    without conditionals at the call sites.
    """

    def __init__(self, mean=None, cov=None):
        if mean is None:
            self.mean = None
            if cov is not None:
                import warnings

                warnings.warn(
                    "Both mean and cov need to be set to form a valid nontrivial "
                    "MeanPriors object. mean is not provided, so ignoring the "
                    "provided cov."
                )
            self.cov = None
            return
        self.mean = np.reshape(np.asarray(mean, dtype=np.float64), (-1,))
        if cov is None:
            raise ValueError(
                "Both mean and cov need to be set to form a valid MeanPriors object"
            )
        self.cov = np.asarray(cov, dtype=np.float64)
        if self.cov.ndim == 0:
            assert self.cov > 0.0, "covariance term must be greater than zero"
        elif self.cov.ndim == 1:
            assert len(self.cov) == len(self.mean), (
                "mean and variances must have the same length in MeanPriors"
            )
            assert np.all(self.cov > 0.0), "all variances must be greater than zero"
        elif self.cov.ndim == 2:
            assert self.cov.shape == (len(self.mean), len(self.mean)), (
                "mean and covariances must have the same shape in MeanPriors"
            )
            assert np.all(np.diag(self.cov) > 0.0)
        else:
            raise ValueError("Bad shape for the covariance in MeanPriors")

    @property
    def n_params(self):
        return 0 if self.mean is None else len(self.mean)

    @property
    def has_weak_priors(self):
        return self.mean is None

    def dm_dot_b(self, dm):
        """``H b`` or zeros under weak priors (``Priors.py:493-513``)."""
        if self.mean is None:
            return jnp.zeros(dm.shape[0], dtype=dm.dtype)
        return jnp.dot(dm, jnp.asarray(self.mean, dtype=dm.dtype),
                       precision=jax.lax.Precision.HIGHEST)

    def inv_cov(self):
        """``B^-1`` or scalar zero (``Priors.py:515-538``)."""
        if self.cov is None:
            return 0.0
        if self.cov.ndim < 2:
            return jnp.diag(jnp.broadcast_to(1.0 / self.cov, (len(self.mean),)))
        return jnp.linalg.inv(jnp.asarray(self.cov))

    def inv_cov_b(self):
        """``B^-1 b`` or scalar zero (``Priors.py:539-561``)."""
        if self.cov is None:
            return 0.0
        if self.cov.ndim < 2:
            return jnp.asarray(self.mean) / self.cov
        return jnp.linalg.solve(jnp.asarray(self.cov), jnp.asarray(self.mean))

    def logdet_cov(self):
        """``log det B`` or zero (``Priors.py:562-575``)."""
        if self.cov is None:
            return 0.0
        if self.cov.ndim < 2:
            return float(np.sum(np.log(np.broadcast_to(self.cov, (len(self.mean),)))))
        return float(np.linalg.slogdet(self.cov)[1])

    def __str__(self):
        return "MeanPriors with mean = {} and cov = {}".format(self.mean, self.cov)


# ---------------------------------------------------------------------------
# GPPriors container
# ---------------------------------------------------------------------------

class GPPriors:
    """Collection of priors for one GP (``Priors.py:9-421``).

    Holds per-slot distributions (correlation lengths, covariance and --
    when fit -- nugget) plus ``MeanPriors``.  In addition to the
    reference-parity methods, exposes:

    * ``packed()``       -- ``(codes, a, b, transform_codes)`` flat arrays.
    * ``logp_raw(raw)``  -- jittable log-density of the raw vector.
    * ``sample_raw(key)``-- jittable sampling for optimizer restarts.
    """

    def __init__(
        self,
        mean=None,
        corr=None,
        cov=None,
        nugget=None,
        n_corr=None,
        nugget_type="fit",
    ):
        if corr is None and n_corr is None:
            raise ValueError(
                "Must provide an argument for either corr or n_corr in GPPriors"
            )
        self.mean = mean
        self._n_corr = n_corr
        self.corr = corr
        self.cov = cov
        assert nugget_type in ("fit", "adaptive", "fixed", "pivot"), (
            "Bad value for nugget type in GPPriors"
        )
        self._nugget_type = nugget_type
        self.nugget = nugget

    # cache for default-prior construction: MultiOutputGP creates one
    # GPPriors per output over the SAME inputs, and each construction does
    # O(D) scipy root solves (Priors.py:741-752) -- memoize on the input
    # bytes so the solves run once per distinct design
    _default_cache = {}

    @classmethod
    def default_priors(cls, inputs, n_corr, nugget_type="fit", dist="invgamma"):
        """Data-driven defaults (``Priors.py:85-152``): correlation priors
        put 99% of mass between the min/max input spacing; fit nuggets get
        a small-value InvGamma prior."""
        assert nugget_type in ("fit", "adaptive", "fixed", "pivot")

        if isinstance(dist, str):
            try:
                import hashlib

                key = (
                    hashlib.sha1(
                        np.ascontiguousarray(np.asarray(inputs, dtype=np.float64))
                    ).hexdigest(),
                    int(n_corr),
                    nugget_type,
                    dist.lower(),
                )
            except (TypeError, ValueError):
                key = None
            if key is not None and key in cls._default_cache:
                corr_cached, nugget_cached = cls._default_cache[key]
                return cls(
                    mean=None, corr=list(corr_cached), cov=None,
                    nugget=nugget_cached, nugget_type=nugget_type,
                )
        else:
            key = None

        if isinstance(dist, str):
            dist_obj = {
                "lognormal": LogNormalPrior,
                "gamma": GammaPrior,
                "invgamma": InvGammaPrior,
            }.get(dist.lower())
            if dist_obj is None:
                raise TypeError(
                    "dist must be a prior distribution to construct default priors"
                )
        else:
            if not isinstance(dist, (LogNormalPrior, GammaPrior, InvGammaPrior)):
                raise TypeError(
                    "dist must be a prior distribution to construct default priors"
                )
            dist_obj = dist

        inputs = np.asarray(inputs)
        if inputs.shape[1] == n_corr:
            modified_inputs = np.transpose(inputs)
        elif n_corr == 1:
            modified_inputs = np.reshape(inputs, (1, -1))
        else:
            raise ValueError(
                "Number of correlation lengths not compatible with input array"
            )

        priors = [dist_obj.default_prior_corr(param) for param in modified_inputs]
        priors_updated = [
            p
            if isinstance(p, dist_obj)
            else InvGammaPrior.default_prior_corr_mode(param)
            for (p, param) in zip(priors, modified_inputs)
        ]

        nugget = InvGammaPrior.default_prior_nugget() if nugget_type == "fit" else None
        if key is not None:
            cls._default_cache[key] = (list(priors_updated), nugget)
        return cls(
            mean=None,
            corr=priors_updated,
            cov=None,
            nugget=nugget,
            nugget_type=nugget_type,
        )

    # -- attribute plumbing -------------------------------------------------

    @property
    def mean(self):
        return self._mean

    @mean.setter
    def mean(self, newmean):
        if newmean is None:
            self._mean = MeanPriors()
        elif isinstance(newmean, MeanPriors):
            self._mean = newmean
        else:
            try:
                self._mean = MeanPriors(*newmean)
            except TypeError:
                raise ValueError(
                    "Bad value for defining a MeanPriors object in GPPriors"
                )

    @property
    def n_mean(self):
        return self._mean.n_params

    @property
    def corr(self):
        return self._corr

    @corr.setter
    def corr(self, newcorr):
        if newcorr is None:
            assert self._n_corr is not None
            newcorr = [WeakPrior() for _ in range(self._n_corr)]
        try:
            list(newcorr)
        except TypeError:
            raise TypeError("corr must be a list of WeakPrior-derived objects")
        newcorr = [WeakPrior() if d is None else d for d in newcorr]
        for d in newcorr:
            assert isinstance(d, WeakPrior), (
                "all corr priors must be WeakPrior-derived objects"
            )
        if self._n_corr is not None:
            assert len(newcorr) == self._n_corr, (
                "corr must have length n_corr"
            )
        self._corr = list(newcorr)
        self._n_corr = len(self._corr)

    @property
    def n_corr(self):
        return self._n_corr

    @property
    def cov(self):
        return self._cov

    @cov.setter
    def cov(self, newcov):
        if newcov is None:
            newcov = WeakPrior()
        assert isinstance(newcov, WeakPrior), (
            "cov prior must be a WeakPrior-derived object"
        )
        self._cov = newcov

    @property
    def nugget_type(self):
        return self._nugget_type

    @property
    def nugget(self):
        return self._nugget

    @nugget.setter
    def nugget(self, newnugget):
        if self.nugget_type != "fit":
            self._nugget = None
            return
        if newnugget is None:
            newnugget = WeakPrior()
        assert isinstance(newnugget, WeakPrior), (
            "nugget prior must be a WeakPrior-derived object"
        )
        self._nugget = newnugget

    @property
    def n_params(self):
        return self.n_corr + 1 + int(self.nugget_type == "fit")

    def _slots(self):
        """Ordered (distribution, transform_code) pairs for the packed form."""
        slots = [(d, TRANSFORM_CORR) for d in self._corr]
        slots.append((self._cov, TRANSFORM_COV))
        if self.nugget_type == "fit":
            slots.append((self._nugget, TRANSFORM_COV))
        return slots

    def packed(self, dtype=None):
        """Flat arrays (codes, a, b, transform_codes) for batched use."""
        slots = self._slots()
        codes = np.array([d.code for d, _ in slots], dtype=np.int32)
        a = np.array([d.packed_params[0] for d, _ in slots])
        b = np.array([d.packed_params[1] for d, _ in slots])
        tcodes = np.array([t for _, t in slots], dtype=np.int32)
        if dtype is not None:
            a = a.astype(dtype)
            b = b.astype(dtype)
        return codes, a, b, tcodes

    # -- jittable core ------------------------------------------------------

    def transformed_values(self, raw):
        """Map raw fitting parameters to per-slot transformed values."""
        raw = jnp.asarray(raw)
        corr = CorrTransform.transform(raw[: self.n_corr])
        cov = CovTransform.transform(raw[self.n_corr : self.n_corr + 1])
        vals = [corr, cov]
        if self.nugget_type == "fit":
            vals.append(CovTransform.transform(raw[-1:]))
        return jnp.concatenate(vals)

    def logp_raw(self, raw):
        """Total log prior density of the raw parameter vector (jittable)."""
        codes, a, b, _ = self.packed()
        vals = self.transformed_values(raw)
        codes = jnp.asarray(codes)
        a = jnp.asarray(a, dtype=vals.dtype)
        b = jnp.asarray(b, dtype=vals.dtype)
        return jnp.sum(jax.vmap(dist_logp)(codes, a, b, vals))

    def sample_raw(self, key):
        """One raw-parameter sample for optimizer restarts (jittable).

        Reference semantics: ``GPPriors.sample`` (``Priors.py:394-421``).
        """
        codes, a, b, tcodes = self.packed()
        dtype = jnp.result_type(float)
        keys = jax.random.split(key, len(codes))
        return jax.vmap(dist_sample_raw)(
            jnp.asarray(codes),
            jnp.asarray(a, dtype=dtype),
            jnp.asarray(b, dtype=dtype),
            jnp.asarray(tcodes),
            keys,
        )

    # -- reference API parity ----------------------------------------------

    def _check_theta(self, theta):
        from .params import GPParams

        if not isinstance(theta, GPParams):
            raise TypeError(
                "theta must be a GPParams object when computing priors in GPPriors"
            )
        assert self.n_corr == theta.n_corr
        assert self.nugget_type == theta.nugget_type
        assert theta.get_data() is not None

    def logp(self, theta):
        """Log prior density of a ``GPParams`` object (``Priors.py:291``)."""
        self._check_theta(theta)
        return float(self.logp_raw(jnp.asarray(theta.get_data())))

    def dlogpdtheta(self, theta):
        """Gradient w.r.t. raw parameters via autodiff (``Priors.py:321``)."""
        self._check_theta(theta)
        raw = jnp.asarray(theta.get_data(), dtype=jnp.result_type(float))
        return np.asarray(jax.grad(self.logp_raw)(raw))

    def d2logpdtheta2(self, theta):
        """Diagonal of the Hessian via autodiff (``Priors.py:356``)."""
        self._check_theta(theta)
        raw = jnp.asarray(theta.get_data(), dtype=jnp.result_type(float))
        hess = jax.hessian(self.logp_raw)(raw)
        return np.asarray(jnp.diag(hess))

    def sample(self):
        """Host-side sample (numpy RNG) matching ``Priors.py:394-421``."""
        sample_pt = []
        for dist in self._corr:
            sample_pt.append(dist.sample(CorrTransform))
        sample_pt.append(self._cov.sample(CovTransform))
        if self.nugget_type == "fit":
            sample_pt.append(self._nugget.sample(CovTransform))
        return np.array(sample_pt)

    def sample_n(self, n):
        """``n`` host-side samples, shape ``(n, n_params)``.

        One vectorized ``rvs``/``rand`` call per parameter slot instead of
        ``n * n_params`` scalar draws -- scipy's per-call overhead (~50 us)
        dominates restart-start generation for large MultiOutputGP fits.
        Consumes the numpy RNG slot-major (``sample`` is try-major), so
        seeded runs differ from a loop of :meth:`sample` but remain
        deterministic."""
        cols = [dist.sample_n(CorrTransform, n) for dist in self._corr]
        cols.append(self._cov.sample_n(CovTransform, n))
        if self.nugget_type == "fit":
            cols.append(self._nugget.sample_n(CovTransform, n))
        return np.stack(cols, axis=1)

    def __str__(self):
        return "GPPriors with {} corr priors, cov prior {}, nugget type {}".format(
            self.n_corr, self._cov, self.nugget_type
        )


def max_spacing(input):
    """Total range of unique input values (``Priors.py:1151-1170``)."""
    input = np.unique(np.asarray(input).flatten())
    if len(input) <= 1:
        return 0.0
    input_sorted = np.sort(input)
    return float(input_sorted[-1] - input_sorted[0])


def min_spacing(input):
    """Median spacing of unique input values (``Priors.py:1171-1188``)."""
    input = np.unique(np.asarray(input).flatten())
    if len(input) <= 2:
        return 0.0
    return float(np.median(np.diff(np.sort(input))))
