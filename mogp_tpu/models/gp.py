"""Gaussian Process emulator: functional core + reference-parity class.

Re-design of ``mogp_emulator/GaussianProcess.py`` (CUDA
analogue ``mogp_gpu/src/densegp_gpu.hpp``).  The reference's mutable
cached-state object (``fit``/``logposterior``/``logpost_deriv`` with
refit checks, ``GaussianProcess.py:606-782``) dissolves into three pure
jittable functions over a ``GPData`` pytree:

* ``gp_fit``      -- all fit-time artifacts + negative log posterior,
                     implementing the marginalized-mean math of
                     ``GaussianProcess.fit`` (``GaussianProcess.py:655-685``).
* ``gp_nlp``      -- scalar negative log posterior (the optimization
                     objective); its gradient is ``jax.grad(gp_nlp)``,
                     replacing the hand-derived ``logpost_deriv``
                     (``GaussianProcess.py:711-782``) and the CUDA
                     derivative kernels (``densegp_gpu.hpp:663-766``).
* ``gp_predict``  -- predictive mean/variance/full covariance with the
                     mean-correction term (``GaussianProcess.py:818-927``).

Because the functions are pure and shape-static, ``vmap`` batches them
over outputs and optimizer restarts, and a device mesh shards those batch
axes -- that is the whole multi-output/multi-process story of
the reference (``MultiOutputGP.py``, ``fitting.py:333-335``) collapsed
into XLA program structure.

The ``GaussianProcess`` class at the bottom keeps the reference's
constructor and method surface for drop-in familiarity.
"""

import warnings
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import default_dtype
from ..ops.cholesky import cholesky_factor
from ..ops.kernels import get_kernel
from .meanfun import design_matrix
from .params import GPParams, _process_nugget
from .priors import GPPriors, dist_logp

__all__ = [
    "GPData",
    "FitArtifacts",
    "gp_fit",
    "gp_nlp",
    "gp_predict",
    "GaussianProcess",
    "PredictResult",
]


class GPData(NamedTuple):
    """Training data + packed priors for one GP; a pure array pytree.

    All leaves are arrays so a stack of ``GPData`` (over outputs) is just
    a ``GPData`` with a leading axis, ready for ``vmap``/``pjit``.

    Mean-prior information is stored in unrolled array form (zeros for
    weak priors) so the marginalized-mean math needs no conditionals:
    ``mean_mean`` = prior mean ``b`` (M,), ``mean_inv_cov`` = ``B^-1``
    (M, M), ``mean_inv_cov_b`` = ``B^-1 b`` (M,), ``mean_logdet_cov`` =
    ``log det B`` (scalar), ``n_coeff`` = the effective coefficient count
    in the 2-pi normalization (``GaussianProcess.py:674-677``).
    """

    inputs: jnp.ndarray       # (n, D)
    targets: jnp.ndarray      # (n,)
    dm: jnp.ndarray           # (n, M)
    prior_codes: jnp.ndarray  # (P,) int32
    prior_a: jnp.ndarray      # (P,)
    prior_b: jnp.ndarray      # (P,)
    fixed_nugget: jnp.ndarray    # scalar; only used for nugget_type="fixed"
    mean_mean: jnp.ndarray       # (M,)
    mean_inv_cov: jnp.ndarray    # (M, M)
    mean_inv_cov_b: jnp.ndarray  # (M,)
    mean_logdet_cov: jnp.ndarray  # scalar
    n_coeff: jnp.ndarray          # scalar


class FitArtifacts(NamedTuple):
    """Everything cached by the reference ``fit`` (``GaussianProcess.py:655-685``)."""

    raw: jnp.ndarray          # raw hyperparameters used for the fit
    Kinv: object              # ChoFactor or PivotedChoFactor of K (+nugget)
    Ainv: object              # ChoFactor of A = H^T K^-1 H + B^-1
    mean: jnp.ndarray         # analytic mean coefficients beta_hat (M,)
    Kinv_t_mean: jnp.ndarray  # K^-1 (y - H beta_hat)  (n,)
    Kinv_dm: jnp.ndarray      # K^-1 H  (n, M); lets predict build the
                              # R-correction with a matmul instead of a
                              # triangular solve (K symmetric:
                              # H^T K^-1 K* = (K^-1 H)^T K*)
    nugget: jnp.ndarray       # realized nugget (adaptive jitter / fit / fixed)
    logpost: jnp.ndarray      # negative log posterior (scalar)


def make_gp_data(inputs, targets, dm, priors, nugget_value=0.0, dtype=None):
    """Assemble a ``GPData`` pytree from host-side objects."""
    dtype = dtype or default_dtype()
    inputs = jnp.asarray(inputs, dtype=dtype)
    targets = jnp.asarray(targets, dtype=dtype)
    dm = jnp.asarray(dm, dtype=dtype)
    n, M = dm.shape

    codes, a, b, _ = priors.packed()
    mp = priors.mean
    if mp.has_weak_priors:
        mean_mean = jnp.zeros((M,), dtype=dtype)
        mean_inv_cov = jnp.zeros((M, M), dtype=dtype)
        mean_inv_cov_b = jnp.zeros((M,), dtype=dtype)
        mean_logdet = jnp.zeros((), dtype=dtype)
        n_coeff = jnp.asarray(n - M, dtype=dtype)
    else:
        mean_mean = jnp.asarray(mp.mean, dtype=dtype)
        mean_inv_cov = jnp.asarray(mp.inv_cov(), dtype=dtype).reshape(M, M)
        mean_inv_cov_b = jnp.asarray(mp.inv_cov_b(), dtype=dtype).reshape(M)
        mean_logdet = jnp.asarray(mp.logdet_cov(), dtype=dtype)
        n_coeff = jnp.asarray(n, dtype=dtype)

    return GPData(
        inputs=inputs,
        targets=targets,
        dm=dm,
        prior_codes=jnp.asarray(codes),
        prior_a=jnp.asarray(a, dtype=dtype),
        prior_b=jnp.asarray(b, dtype=dtype),
        fixed_nugget=jnp.asarray(
            0.0 if nugget_value is None else nugget_value, dtype=dtype
        ),
        mean_mean=mean_mean,
        mean_inv_cov=mean_inv_cov,
        mean_inv_cov_b=mean_inv_cov_b,
        mean_logdet_cov=mean_logdet,
        n_coeff=n_coeff,
    )


def _prior_logp(data: GPData, raw, n_corr, nugget_type):
    """Packed-prior log density of the raw vector (batch-friendly)."""
    corr = jnp.exp(-0.5 * raw[:n_corr])
    cov = jnp.exp(raw[n_corr : n_corr + 1])
    vals = [corr, cov]
    if nugget_type == "fit":
        vals.append(jnp.exp(raw[-1:]))
    vals = jnp.concatenate(vals)
    return jnp.sum(
        jax.vmap(dist_logp)(data.prior_codes, data.prior_a, data.prior_b, vals)
    )


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "reuse_factor", "sparse_ladder",
                     "progressive_ok"),
)
def gp_fit(raw, data: GPData, kernel, nugget_type, reuse_factor=True,
           sparse_ladder=False, progressive_ok=True):
    """Compute all fit-time artifacts for raw hyperparameters ``raw``.

    Implements ``GaussianProcess.fit`` (``GaussianProcess.py:629-685``):
    covariance build, nugget-aware factorization, analytic mean solve, and
    the negative log posterior including the prior term.
    """
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = raw[:n_corr]
    sigma2 = jnp.exp(raw[n_corr])

    if nugget_type == "fit":
        nugget = jnp.exp(raw[-1])
    elif nugget_type == "fixed":
        nugget = data.fixed_nugget
    else:
        nugget = jnp.zeros((), dtype=data.inputs.dtype)

    from ..ops.linalg import dot_hp, marginal_core, marginal_nlp

    m = dot_hp(data.dm, data.mean_mean)
    K = sigma2 * kernel.kernel_f(data.inputs, data.inputs, corr_raw)
    Kinv, nugget = cholesky_factor(
        K, nugget, nugget_type,
        reuse_factor=reuse_factor, sparse_ladder=sparse_ladder,
        progressive_ok=progressive_ok,
    )

    # One stacked half-solve W = L^-1 [H | (y - m)] provides everything
    # the marginalized-mean math needs (the reference's three separate
    # K^-1 solves, GaussianProcess.py:655-672) -- see ops/linalg.py.
    core = marginal_core(Kinv, data.dm, data.targets - m, data.mean_inv_cov)
    Ainv = core.Ainv

    # analytic mean: beta_hat = A^-1 (H^T K^-1 y + B^-1 b)
    # (linalg_utils.py:96-130)
    mean = Ainv.solve(core.H_Kinv_t + data.mean_inv_cov_b)

    # complete the full solves (upper sweep) for the prediction artifacts;
    # Kinv_t_mean = K^-1 (y - H mean) = Kinv_t + (K^-1 H)(b - mean)
    full = Kinv.solve_from_half(core.W)
    Kinv_dm, Kinv_t = full[:, :-1], full[:, -1]
    Kinv_t_mean = Kinv_t + dot_hp(Kinv_dm, data.mean_mean - mean)

    logpost = marginal_nlp(core, Kinv, data.mean_logdet_cov, data.n_coeff)
    logpost = logpost - _prior_logp(data, raw, n_corr, nugget_type)

    return FitArtifacts(
        raw=raw,
        Kinv=Kinv,
        Ainv=Ainv,
        mean=mean,
        Kinv_t_mean=Kinv_t_mean,
        Kinv_dm=Kinv_dm,
        nugget=nugget,
        logpost=logpost,
    )


def gp_nlp(raw, data: GPData, kernel, nugget_type, reuse_factor=True,
           sparse_ladder=False, progressive_ok=True):
    """Negative log posterior (the MAP objective).  ``jax.grad`` of this
    replaces ``logpost_deriv`` (``GaussianProcess.py:711-782``).

    Lean evaluation for the optimizer hot loop: everything follows from
    ONE lower-triangular half-solve with the stacked RHS ``[H | y - m]``
    -- no upper sweeps, no prediction artifacts.  (XLA's dead-code
    elimination would strip most of ``gp_fit`` anyway; writing the lean
    form explicitly keeps the traced program -- and compile time -- small
    under the vmapped/while-looped optimizer.)
    """
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = raw[:n_corr]
    sigma2 = jnp.exp(raw[n_corr])

    if nugget_type == "fit":
        nugget = jnp.exp(raw[-1])
    elif nugget_type == "fixed":
        nugget = data.fixed_nugget
    else:
        nugget = jnp.zeros((), dtype=data.inputs.dtype)

    from ..ops.linalg import dot_hp, marginal_core, marginal_nlp

    m = dot_hp(data.dm, data.mean_mean)
    K = sigma2 * kernel.kernel_f(data.inputs, data.inputs, corr_raw)
    Kinv, nugget = cholesky_factor(
        K, nugget, nugget_type,
        reuse_factor=reuse_factor, sparse_ladder=sparse_ladder,
        progressive_ok=progressive_ok,
    )

    core = marginal_core(Kinv, data.dm, data.targets - m, data.mean_inv_cov)
    logpost = marginal_nlp(core, Kinv, data.mean_logdet_cov, data.n_coeff)
    return logpost - _prior_logp(data, raw, n_corr, nugget_type)


def _gp_predict_impl(
    artifacts: FitArtifacts,
    data: GPData,
    testing,
    dmtest,
    kernel,
    nugget_type,
    unc=True,
    include_nugget=True,
    full_cov=False,
):
    """Predictive mean and (co)variance (``GaussianProcess.py:818-927``).

    :param testing: ``(n_predict, D)`` query points.
    :param dmtest: ``(n_predict, M)`` design matrix of the query points.
    :returns: ``(mu, var)``; ``var`` is ``None`` if ``unc`` is False,
              ``(n_predict,)`` variances, or ``(n_predict, n_predict)``
              full covariance if ``full_cov``.
    """
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = artifacts.raw[:n_corr]
    sigma2 = jnp.exp(artifacts.raw[n_corr])

    from ..ops.linalg import dot_hp

    mtest = dot_hp(dmtest, artifacts.mean)
    # cross covariance: XLA fuses the distance epilogue and the kernel
    # function into the (n, m) build
    Ktest = sigma2 * kernel.kernel_f(data.inputs, testing, corr_raw)

    mu = mtest + dot_hp(Ktest.T, artifacts.Kinv_t_mean)

    if not unc:
        return mu, None

    # R = H*^T - H^T K^-1 K* (linalg_utils.py:132-167) via the stored
    # K^-1 H and symmetry of K: one matmul, no triangular solve.
    # The quadratic forms use half-solves (one lower sweep each) instead
    # of full solves -- triangular solves are the latency-bound op here.
    R = dmtest.T - dot_hp(artifacts.Kinv_dm.T, Ktest)  # (M, m)
    Linv_Ktest = artifacts.Kinv.solve_L(Ktest)
    LAinv_R = artifacts.Ainv.solve_L(R)

    if full_cov:
        sigma_2 = sigma2 * kernel.kernel_f(testing, testing, corr_raw)
        if include_nugget and nugget_type != "pivot":
            sigma_2 = sigma_2 + jnp.eye(
                testing.shape[0], dtype=sigma_2.dtype
            ) * artifacts.nugget
        var = (
            sigma_2
            - dot_hp(Linv_Ktest.T, Linv_Ktest)
            + dot_hp(LAinv_R.T, LAinv_R)
        )
    else:
        sigma_2 = sigma2
        if include_nugget and nugget_type != "pivot":
            sigma_2 = sigma_2 + artifacts.nugget
        var = jnp.maximum(
            sigma_2
            - jnp.sum(Linv_Ktest**2, axis=0)
            + jnp.sum(LAinv_R**2, axis=0),
            0.0,
        )
    return mu, var


gp_predict = partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "unc", "include_nugget", "full_cov"),
)(_gp_predict_impl)
gp_predict.__name__ = "gp_predict"


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "unc", "include_nugget", "tile"),
)
def gp_predict_tiled(
    artifacts: FitArtifacts,
    data: GPData,
    testing,
    dmtest,
    kernel,
    nugget_type,
    unc=True,
    include_nugget=True,
    tile=32768,
):
    """Memory-bounded prediction: ``lax.map`` over fixed-size query tiles.

    Form of the reference's batched device prediction
    (``GaussianProcessGPU.py:608-626`` loops ``max_batch_size=2000``
    query batches; ``mogp_gpu/src/densegp_gpu.hpp:786-812`` preallocates
    a ``testing_size`` buffer): the per-tile working set -- the ``(n,
    tile)`` cross-covariance, its half-solve, and the ``(M, tile)``
    R-correction -- is all that ever exists on device, so a 10^7-point
    HistoryMatching/SMC sweep runs in HBM that depends only on ``n`` and
    ``tile``, not on the query count.  ``lax.map`` keeps the whole sweep
    one dispatch (one compiled program per (n_tiles, tile) shape pair,
    and tile shapes are quantized so shapes recur).

    Full covariance is inherently O(m^2) and is not supported here; use
    :func:`gp_predict` with ``full_cov=True`` for modest ``m``.

    :param tile: static query-tile size.
    :returns: ``(mu, var)`` with ``var`` ``None`` when ``unc`` is False.
    """
    def one(args):
        t, dm = args
        mu, var = _gp_predict_impl(
            artifacts, data, t, dm, kernel, nugget_type,
            unc=unc, include_nugget=include_nugget, full_cov=False,
        )
        return (mu, var) if unc else (mu, jnp.zeros((0,), dtype=mu.dtype))

    (mu, var), m = tiled_query_map(testing, dmtest, tile, one)
    mu = mu.reshape(-1)[:m]
    if not unc:
        return mu, None
    return mu, var.reshape(-1)[:m]


def tiled_query_map(testing, dmtest, tile, body):
    """Shared query-tiling scaffold: pad the query axis to a ``tile``
    multiple (repeating the final row -- padded lanes compute finite
    garbage the caller slices off), reshape to ``(n_tiles, tile, .)``,
    and ``lax.map`` ``body`` over ``(testing_tile, dmtest_tile)`` pairs.

    Used by :func:`gp_predict_tiled` and the fused history-matching
    sweep (``uq/history_matching._implausibility_topk_tiled``) so the
    padding/tiling semantics cannot diverge between them.

    :returns: ``(mapped_outputs, m)`` with ``m`` the true query count.
    """
    m = testing.shape[0]
    n_tiles = -(-m // tile)
    pad = n_tiles * tile - m
    if pad:
        testing = jnp.concatenate(
            [testing, jnp.repeat(testing[-1:], pad, axis=0)], axis=0
        )
        dmtest = jnp.concatenate(
            [dmtest, jnp.repeat(dmtest[-1:], pad, axis=0)], axis=0
        )
    t3 = testing.reshape(n_tiles, tile, testing.shape[1])
    dm3 = dmtest.reshape(n_tiles, tile, dmtest.shape[1])
    return jax.lax.map(body, (t3, dm3)), m


def _predict_tile_size(n_testing, max_batch_size, n_train=None, n_lanes=1):
    """Resolve the query-tile size for chunked prediction.

    ``None`` -> automatic: unchunked below the auto tile, tiled above
    (bounding HBM for huge sweeps without a flag, like the reference GPU
    class's default ``max_batch_size=2000``).  The auto tile shrinks
    with the per-tile working set: each tile holds ~4 ``(n_lanes,
    n_train, tile)`` f32 buffers (cross-covariance, half-solves, fusion
    temporaries), kept under ``_PREDICT_TILE_BYTES`` so e.g. a
    64-output sweep does not OOM where a single-output one fits.  An
    explicit value is rounded up to a multiple of 256 (collapses
    near-identical compiled shapes).  Returns 0
    for "do not chunk".
    """
    if max_batch_size is None:
        tile = _AUTO_PREDICT_TILE
        if n_train:
            budget = _PREDICT_TILE_BYTES // (16 * int(n_train) * max(1, n_lanes))
            tile = min(tile, max(256, budget // 256 * 256))
        return tile if n_testing > tile else 0
    tile = int(max_batch_size)
    assert tile > 0, "max_batch_size must be positive"
    tile = -(-tile // 256) * 256
    return tile if n_testing > tile else 0


_AUTO_PREDICT_TILE = 32768
_PREDICT_TILE_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Reference-parity class
# ---------------------------------------------------------------------------

class PredictResult(dict):
    """Prediction results: dict/tuple/attribute hybrid
    (``GaussianProcess.py:948-1026``)."""

    _fields = ("mean", "unc", "deriv")

    def __init__(self, mean=None, unc=None, deriv=None):
        super().__init__(mean=mean, unc=unc, deriv=deriv)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __getitem__(self, key):
        if isinstance(key, int):
            return dict.__getitem__(self, self._fields[key])
        return dict.__getitem__(self, key)

    def __iter__(self):
        return iter(self[f] for f in self._fields)

    def __len__(self):
        return 3


class GaussianProcessBase:
    pass


class GaussianProcess(GaussianProcessBase):
    """Single-output GP emulator with the reference API surface
    (``GaussianProcess.py:20-947``), backed by the jitted functional core.

    Example::

        >>> import numpy as np
        >>> from mogp_tpu import GaussianProcess, fit_GP_MAP
        >>> x = np.array([[1., 2., 3.], [4., 5., 6.]])
        >>> y = np.array([4., 6.])
        >>> gp = GaussianProcess(x, y)
        >>> gp = fit_GP_MAP(gp)
        >>> mu, var, _ = gp.predict(np.array([[2., 3., 4.]]))
    """

    def __init__(
        self,
        inputs,
        targets,
        mean=None,
        kernel="SquaredExponential",
        priors=None,
        nugget="adaptive",
        inputdict={},
        use_patsy=True,
        standardize=False,
    ):
        inputs = self._process_inputs(inputs)
        targets = np.asarray(targets, dtype=np.float64)
        assert targets.ndim == 1
        assert targets.shape[0] == inputs.shape[0]

        # optional target standardization (beyond the reference): the GP is
        # fit on (y - mean)/std and predictions are mapped back, which
        # keeps factorizations well-conditioned in float32 for
        # badly-scaled simulators.  Hyperparameters and log posteriors
        # then refer to the standardized targets.
        self._standardize = bool(standardize)
        if self._standardize:
            self._t_mean = float(np.mean(targets))
            self._t_std = float(np.std(targets)) or 1.0
            targets_model = (targets - self._t_mean) / self._t_std
        else:
            self._t_mean, self._t_std = 0.0, 1.0
            targets_model = targets

        self.kernel = get_kernel(kernel)
        self._inputs = inputs
        self._targets = targets          # original units
        self._targets_model = targets_model  # what the GP is fit on

        if inputdict:
            warnings.warn(
                "The inputdict interface for mean functions has been deprecated.",
                DeprecationWarning,
            )
        if not use_patsy:
            warnings.warn(
                "formulae are parsed natively; the use_patsy option is ignored.",
                DeprecationWarning,
            )

        self._mean = mean
        # categorical C(...) level bindings, captured here from the
        # training inputs and reused for every later design matrix
        # (patsy's design_info role)
        self._mean_state = {}
        self._dm = design_matrix(mean, self._inputs, state=self._mean_state)

        nugget_value, self._nugget_type = _process_nugget(nugget)

        self._set_priors(priors)

        self._theta = GPParams(
            n_mean=self.n_mean, n_corr=self.n_corr, nugget=nugget
        )
        self._nugget_value = nugget_value

        self._data = make_gp_data(
            self._inputs,
            self._targets_model,
            self._dm,
            self._priors,
            nugget_value=nugget_value if nugget_value is not None else 0.0,
        )
        self._artifacts = None

    # -- basic properties ---------------------------------------------------

    @property
    def inputs(self):
        return self._inputs

    @property
    def targets(self):
        return self._targets

    @property
    def n(self):
        return self._inputs.shape[0]

    @property
    def D(self):
        return self._inputs.shape[1]

    @property
    def n_mean(self):
        return self._dm.shape[1]

    @property
    def n_corr(self):
        return self.kernel.get_n_params(self._inputs)

    @property
    def n_params(self):
        """Number of fitting parameters (``GaussianProcess.py:300-320``)."""
        return self.n_corr + 1 + int(self._nugget_type == "fit")

    @property
    def nugget_type(self):
        return self._nugget_type

    @property
    def nugget(self):
        return self._theta.nugget

    @property
    def theta(self):
        """Current hyperparameters as ``GPParams`` (``GaussianProcess.py:383``)."""
        return self._theta

    @theta.setter
    def theta(self, newtheta):
        if newtheta is None:
            self._theta = GPParams(
                n_mean=self.n_mean,
                n_corr=self.n_corr,
                nugget=(
                    self._nugget_value
                    if self._nugget_type == "fixed"
                    else self._nugget_type
                ),
            )
            self._artifacts = None
        else:
            self.fit(newtheta)

    @property
    def priors(self):
        return self._priors

    def _set_priors(self, priors):
        """Resolve the priors argument (``GaussianProcess.py:440-483``)."""
        if priors is None:
            self._priors = GPPriors.default_priors(
                self._inputs, self.n_corr, nugget_type=self._nugget_type
            )
        elif isinstance(priors, GPPriors):
            self._priors = priors
        elif isinstance(priors, dict):
            self._priors = GPPriors(**priors)
        else:
            raise ValueError(
                "priors must be a GPPriors object, dict of kwargs, or None"
            )
        if self._priors.n_mean > 0:
            assert self._priors.n_mean == self.n_mean
        assert self._priors.n_corr == self.n_corr, (
            "bad number of correlation lengths in GPPriors object"
        )
        assert self._priors.nugget_type == self._nugget_type, (
            "nugget type of GPPriors object does not match"
        )

    # -- design / covariance helpers ---------------------------------------

    def get_design_matrix(self, inputs):
        """Design matrix for a set of inputs (``GaussianProcess.py:485-515``)."""
        inputs = self._process_inputs(inputs)
        assert inputs.shape[1] == self.D, "bad shape for inputs"
        return design_matrix(self._mean, inputs, state=self._mean_state)

    def get_cov_matrix(self, other_inputs):
        """Covariance of training inputs vs ``other_inputs``
        (``GaussianProcess.py:517-543``)."""
        other = self._process_inputs(other_inputs)
        return np.asarray(
            self._theta.cov
            * self.kernel.kernel_f(self._inputs, other, self._theta.corr_raw)
        )

    def get_K_matrix(self):
        """Current training covariance, without nugget
        (``GaussianProcess.py:545-558``)."""
        return self.get_cov_matrix(self._inputs)

    def _process_inputs(self, inputs):
        inputs = np.asarray(inputs, dtype=np.float64)
        if inputs.ndim == 1:
            if not hasattr(self, "_inputs") or self.D == 1:
                inputs = np.reshape(inputs, (-1, 1))
            else:
                inputs = np.reshape(inputs, (1, -1))
        assert inputs.ndim == 2, "bad shape for input"
        if hasattr(self, "_inputs"):
            assert inputs.shape[1] == self.D, (
                "second dimension of other inputs must match the number of "
                "input parameters"
            )
        return inputs

    # -- fitting ------------------------------------------------------------

    def _coerce_theta(self, theta):
        if isinstance(theta, GPParams):
            assert self._theta.same_shape(theta), "bad shape for hyperparameters"
            if theta.mean is not None and theta.n_mean > 0:
                warnings.warn(
                    "Setting mean parameters with a GPParams object is not "
                    "supported. The provided values will be overwritten with "
                    "the analytical mean solution."
                )
            raw = theta.get_data()
        else:
            raw = np.asarray(theta, dtype=np.float64)
            assert self._theta.same_shape(raw), "bad shape for hyperparameters"
        return raw

    def fit(self, theta):
        """Fit the emulator at hyperparameters ``theta``
        (``GaussianProcess.py:629-685``)."""
        raw = self._coerce_theta(theta)
        dtype = self._data.inputs.dtype
        arts = gp_fit(
            jnp.asarray(raw, dtype=dtype),
            self._data,
            self.kernel,
            self._nugget_type,
        )
        self._set_fit_artifacts(raw, arts)

    def _set_fit_artifacts(self, raw, arts):
        """Install precomputed fit artifacts (shared by ``fit`` and the
        batched multi-output refit, which computes artifacts for a whole
        emulator group in one vmapped program)."""
        self._artifacts = arts
        self._theta.set_data(np.asarray(raw, dtype=np.float64))
        self._theta.mean = np.asarray(arts.mean, dtype=np.float64)
        if self._nugget_type == "adaptive":
            self._theta.nugget = float(arts.nugget)
        self.current_logpost = float(arts.logpost)

    @property
    def Kinv(self):
        return None if self._artifacts is None else self._artifacts.Kinv

    @property
    def Ainv(self):
        return None if self._artifacts is None else self._artifacts.Ainv

    @property
    def Kinv_t_mean(self):
        return None if self._artifacts is None else self._artifacts.Kinv_t_mean

    def logposterior(self, theta):
        """Negative log posterior at ``theta`` (``GaussianProcess.py:688-709``)."""
        if self._refit(theta):
            self.fit(theta)
        return self.current_logpost

    def logpost_deriv(self, theta):
        """Gradient of the negative log posterior via ``jax.grad``
        (replaces ``GaussianProcess.py:711-782``)."""
        theta = np.asarray(theta, dtype=np.float64)
        if self._refit(theta):
            self.fit(theta)
        dtype = self._data.inputs.dtype
        g = _gp_nlp_grad(
            jnp.asarray(theta, dtype=dtype),
            self._data,
            self.kernel,
            self._nugget_type,
        )
        return np.asarray(g, dtype=np.float64)

    def logpost_hessian(self, theta):
        """Hessian of the negative log posterior via ``jax.hessian``.

        The reference raises ``NotImplementedError``
        (``GaussianProcess.py:784-816``); autodiff gives it for free here.
        """
        theta = np.asarray(theta, dtype=np.float64)
        if self._refit(theta):
            self.fit(theta)
        dtype = self._data.inputs.dtype
        h = _gp_nlp_hessian(
            jnp.asarray(theta, dtype=dtype),
            self._data,
            self.kernel,
            self._nugget_type,
        )
        return np.asarray(h, dtype=np.float64)

    def _refit(self, newtheta):
        """Refit check (``GaussianProcess.py:606-627``)."""
        current = self._theta.get_data()
        if current is None or self._artifacts is None:
            return True
        newtheta = np.asarray(newtheta)
        return not np.allclose(newtheta, current, rtol=1.0e-10, atol=1.0e-15)

    # -- prediction ---------------------------------------------------------

    def predict(
        self, testing, unc=True, deriv=False, include_nugget=True,
        full_cov=False, max_batch_size=None,
    ):
        """Predict mean/variance at query points
        (``GaussianProcess.py:818-927``).

        ``max_batch_size`` bounds device memory for very large query sets
        (the reference GPU class's batching knob,
        ``GaussianProcessGPU.py:608-626``): queries are processed in
        fixed-size tiles inside one program (``gp_predict_tiled``).
        Default ``None`` chunks automatically above
        ``_AUTO_PREDICT_TILE`` points; ignored with ``full_cov``.
        """
        if self._theta.get_data() is None or self._artifacts is None:
            raise ValueError(
                "hyperparameters have not been fit for this Gaussian Process"
            )
        testing = self._process_inputs(testing)
        dmtest = self.get_design_matrix(testing)
        dtype = self._data.inputs.dtype

        tile = 0 if full_cov else _predict_tile_size(
            testing.shape[0], max_batch_size, n_train=self.n
        )
        if tile:
            mu, var = gp_predict_tiled(
                self._artifacts,
                self._data,
                jnp.asarray(testing, dtype=dtype),
                jnp.asarray(dmtest, dtype=dtype),
                self.kernel,
                self._nugget_type,
                unc=bool(unc),
                include_nugget=bool(include_nugget),
                tile=tile,
            )
        else:
            mu, var = gp_predict(
                self._artifacts,
                self._data,
                jnp.asarray(testing, dtype=dtype),
                jnp.asarray(dmtest, dtype=dtype),
                self.kernel,
                self._nugget_type,
                unc=bool(unc),
                include_nugget=bool(include_nugget),
                full_cov=bool(full_cov),
            )

        if deriv:
            warnings.warn(
                "Prediction derivatives have been deprecated and are no "
                "longer supported",
                DeprecationWarning,
            )
        mu = np.asarray(mu, dtype=np.float64)
        var = None if var is None else np.asarray(var, dtype=np.float64)
        if self._standardize:
            mu = mu * self._t_std + self._t_mean
            if var is not None:
                var = var * self._t_std**2
        return PredictResult(mean=mu, unc=var, deriv=None)

    def __call__(self, testing):
        return self.predict(testing, unc=False, deriv=False)[0]

    # -- serialization ------------------------------------------------------

    def __getstate__(self):
        """Pickle by re-initialization (the reference GPU class's pattern,
        ``GaussianProcessGPU.py:656-667``): device-resident artifacts are
        dropped and rebuilt from the hyperparameters on unpickling."""
        return {
            "inputs": np.asarray(self._inputs),
            "targets": np.asarray(self._targets),
            "standardize": self._standardize,
            "mean": self._mean,
            "kernel": type(self.kernel).__name__,
            "priors": self._priors,
            "nugget": (
                self._nugget_value
                if self._nugget_type == "fixed"
                else self._nugget_type
            ),
            "theta": (
                None
                if self._theta.get_data() is None
                else np.asarray(self._theta.get_data())
            ),
        }

    def __setstate__(self, state):
        self.__init__(
            state["inputs"],
            state["targets"],
            mean=state["mean"],
            kernel=state["kernel"],
            priors=state["priors"],
            nugget=state["nugget"],
            standardize=state.get("standardize", False),
        )
        if state["theta"] is not None:
            self.fit(state["theta"])

    def __str__(self):
        return (
            "Gaussian Process with "
            + str(self.n)
            + " training examples and "
            + str(self.D)
            + " input variables"
        )


@partial(jax.jit, static_argnames=("kernel", "nugget_type"))
def _gp_nlp_grad(raw, data, kernel, nugget_type):
    return jax.grad(gp_nlp)(raw, data, kernel, nugget_type)


@partial(jax.jit, static_argnames=("kernel", "nugget_type"))
def _gp_nlp_hessian(raw, data, kernel, nugget_type):
    # the factor-reuse custom_vjp supports only first-order diff; the
    # Hessian path re-factorizes differentiably (reuse_factor=False)
    return jax.hessian(gp_nlp)(raw, data, kernel, nugget_type, False)
