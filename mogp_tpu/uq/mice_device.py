"""Fixed-shape, device-resident MICE sequential design.

The reference MICE loop refits a GP from scratch on a GROWING design
every acquisition step (``SequentialDesign.py:933-964``), so a naive
jitted port compiles a new program per step -- the recompile trap
SURVEY §7 "hard parts" calls out ("preallocated design arrays +
masking").  This engine keeps every device shape fixed across the whole
loop:

* The design lives in preallocated ``(n_max, D)`` buffers with a 0/1
  row mask; masked-out rows of the covariance are replaced by unit
  diagonal rows (``K~ = m m^T (*) K + diag(1 - m)``), whose Cholesky
  factor provably carries them as exact unit pivots -- zero
  log-determinant contribution, zero coupling into the observed block --
  so the masked negative log posterior EQUALS the reference's
  growing-shape value for the observed sub-design (adaptive jitter is
  restricted to observed rows via ``jitter_mask``).
* The per-step MAP refit is the same batched-restart L-BFGS as
  ``fit_GP_MAP`` (vmapped over restarts) on the masked objective: ONE
  compiled program for every step of the loop.
* Candidate scoring (the MICE criterion ``unc_base / unc_cand``,
  ``SequentialDesign.py:886-931``) runs as ONE ``lax.map`` over
  fixed-size candidate blocks computing the base-GP predictive variance
  and the Woodbury leave-one-out candidate variance
  (:func:`mogp_tpu.uq.sequential_design._loo_variances_all`) per block:
  a second compiled program, shared by every step.  With
  ``cand_block >= n_cand`` (the default for moderate ``n_cand``) the
  candidate GP is the reference's joint dense GP; for candidate sets
  too large for a dense ``(n_cand, n_cand)`` covariance (BASELINE
  config 4 asks for 1e5 candidates) the LOO variance is computed
  block-locally -- each candidate's variance conditions on its own
  block of ``cand_block`` candidates, a documented approximation whose
  quality grows with the block size.

Total: exactly TWO compiled program shapes for an entire MICE run of
any length, with flat per-step wall-clock.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..models.gp import _prior_logp, make_gp_data
from ..models.priors import GPPriors
from ..ops.kernels import get_kernel
from ..ops.cholesky import cholesky_factor, jit_cholesky
from ..ops.lbfgs import lbfgs_minimize
from ..ops.linalg import marginal_core, marginal_nlp
from .sequential_design import MICEDesign, _loo_variances_all

__all__ = ["DeviceMICEDesign", "masked_gp_nlp"]


def masked_gp_nlp(raw, data, mask, kernel, nugget_type, weak_mean=True,
                  sparse_ladder=False):
    """Negative log posterior of the masked fixed-shape design.

    Equals ``gp_nlp`` evaluated on the observed sub-design (rows with
    ``mask == 1``): masked rows enter the covariance as exact unit
    pivots and their targets/design rows are zeroed, so every term of
    the marginalized-mean math (``GaussianProcess.py:655-685``) reduces
    to the sub-problem's value; the ``n log 2pi`` normalization uses the
    traced observed count.
    """
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = raw[:n_corr]
    sigma2 = jnp.exp(raw[n_corr])
    dtype = data.inputs.dtype
    mask = mask.astype(dtype)

    if nugget_type == "fit":
        nugget = jnp.exp(raw[-1])
    elif nugget_type == "fixed":
        nugget = data.fixed_nugget
    else:
        nugget = jnp.zeros((), dtype=dtype)

    K = sigma2 * kernel.kernel_f(data.inputs, data.inputs, corr_raw)
    Kt = (mask[:, None] * mask[None, :]) * K + jnp.diag(1.0 - mask)
    Kinv, nugget = cholesky_factor(
        Kt, nugget, nugget_type, sparse_ladder=sparse_ladder,
        jitter_mask=mask, progressive_ok=False,
    )

    m = jnp.dot(data.dm, data.mean_mean, precision=jax.lax.Precision.HIGHEST)
    resid = mask * (data.targets - m)
    dm_m = mask[:, None] * data.dm
    core = marginal_core(Kinv, dm_m, resid, data.mean_inv_cov)

    M = data.dm.shape[1]
    n_obs = jnp.sum(mask)
    n_coeff = n_obs - M if weak_mean else n_obs
    nlp = marginal_nlp(core, Kinv, data.mean_logdet_cov, n_coeff)
    return nlp - _prior_logp(data, raw, n_corr, nugget_type)


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "nugget_type", "weak_mean", "maxiter", "gtol", "ftol",
        "ladder",
    ),
)
def _mice_fit_step(starts, data, mask, kernel, nugget_type, weak_mean,
                   maxiter, gtol, ftol, ladder):
    """All MAP restarts of the masked GP in one program (shape-stable
    across every MICE iteration)."""

    def one(x0):
        return lbfgs_minimize(
            lambda raw: masked_gp_nlp(
                raw, data, mask, kernel, nugget_type, weak_mean,
                sparse_ladder=ladder,
            ),
            x0,
            maxiter=maxiter,
            gtol=gtol,
            ftol=ftol,
        )

    res = jax.vmap(one)(starts)
    return res.fun, res.x


@partial(jax.jit, static_argnames=("kernel", "nugget_type", "weak_mean"))
def _mice_score_step(raw, data, mask, cand_blocks, cand_mask, fast_nugget,
                     nugget_s, kernel, nugget_type, weak_mean):
    """MICE criterion for every candidate, one ``lax.map`` over blocks.

    :param cand_blocks: ``(n_blocks, B, D)`` padded candidate blocks.
    :param cand_mask: ``(n_blocks, B)`` 0/1 -- padded candidate lanes
        enter the block's candidate covariance as unit pivots (the same
        masking lemma as the training buffer), so duplicate-padding the
        final partial block does NOT contaminate the block-local LOO
        variances of its real candidates.
    :param fast_nugget: smoothing-nugget floor of the candidate GP
                        (``nugget_s * base_nugget`` floored; traced).
    :param nugget_s: smoothing multiplier (traced).  The effective
        candidate nugget is ``max(realized_nugget * nugget_s,
        fast_nugget)``: with ``nugget="adaptive"`` the realized jitter is
        only known after the base factorization below, and host
        ``MICEDesign`` uses ``gp.theta.nugget * nugget_s`` -- matching
        that here keeps the two criteria aligned when the base fit
        selected nonzero jitter.
    :returns: ``(scores, mu)`` flattened over blocks -- the criterion
              ``unc_base / unc_cand`` and the base-GP predictive mean at
              every candidate (used for batch-mode target estimation,
              ``SequentialDesign.py:439-453``).
    """
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = raw[:n_corr]
    sigma2 = jnp.exp(raw[n_corr])
    dtype = data.inputs.dtype
    mask = mask.astype(dtype)

    if nugget_type == "fit":
        nugget = jnp.exp(raw[-1])
    elif nugget_type == "fixed":
        nugget = data.fixed_nugget
    else:
        nugget = jnp.zeros((), dtype=dtype)

    # exact reference jitter ladder for the realized fit (the optimizer
    # trajectory above may have used a reduced ladder)
    K = sigma2 * kernel.kernel_f(data.inputs, data.inputs, corr_raw)
    Kt = (mask[:, None] * mask[None, :]) * K + jnp.diag(1.0 - mask)
    Kinv, nugget = cholesky_factor(Kt, nugget, nugget_type, jitter_mask=mask)
    # effective smoothing nugget: the realized (possibly adaptive) base
    # nugget times nugget_s, floored at the host-computed fast_nugget --
    # host MICEDesign semantics (gp.theta.nugget * nugget_s)
    fast_nugget = jnp.maximum(nugget * nugget_s, fast_nugget)

    # zero-mean internal GP (the reference MICE GP default): M == 0
    resid = mask * data.targets
    Kinv_t = Kinv.solve(resid)

    B = cand_blocks.shape[1]
    eye_b = jnp.eye(B, dtype=dtype)

    def block(args):
        cand, cmask = args
        cmask = cmask.astype(dtype)
        # base-GP prediction at the block's candidates
        Kstar = (
            sigma2
            * kernel.kernel_f(data.inputs, cand, corr_raw)
            * mask[:, None]
        )
        mu = jnp.dot(Kstar.T, Kinv_t, precision=jax.lax.Precision.HIGHEST)
        half = Kinv.solve_L(Kstar)
        unc1 = jnp.maximum(
            sigma2 + nugget - jnp.sum(half**2, axis=0), 0.0
        )
        # candidate-GP LOO variance (Woodbury, one stacked half-solve;
        # SequentialDesign.py:705-748 vectorized).  Padded candidate
        # lanes are masked to unit pivots so they contribute nothing to
        # the real lanes' LOO.  The candidate covariance factorizes
        # through the adaptive jitter ladder on top of the smoothing
        # nugget: dense candidate clouds (1e5 points in a low-D box) are
        # numerically singular in f32 at any fixed nugget, and the
        # reference's answer -- catch LinAlgError and refit everything
        # (SequentialDesign.py:960) -- would throw away a good base fit
        C = (cmask[:, None] * cmask[None, :]) * (
            sigma2 * kernel.kernel_f(cand, cand, corr_raw)
        ) + jnp.diag(1.0 - cmask)
        Lq, _ = jit_cholesky(
            C + fast_nugget * jnp.diag(cmask), jitter_mask=cmask
        )
        WV = Lq.solve_L(jnp.concatenate([C, eye_b], axis=1))
        unc2 = _loo_variances_all(
            WV[:, :B], WV[:, B:], sigma2 + fast_nugget, sigma2
        )
        scores = unc1 / jnp.maximum(unc2, jnp.finfo(dtype).tiny)
        return scores, mu

    scores, mu = lax.map(block, (cand_blocks, cand_mask))
    return scores.reshape(-1), mu.reshape(-1)


def _mice_score_step_sharded(mesh, raw, data, mask, cand_blocks, cand_mask,
                             fast_nugget, nugget_s, kernel, nugget_type,
                             weak_mean):
    """Mesh-sharded candidate scoring: the BLOCKS axis is split over
    devices with ``shard_map`` (blocks are independent by construction),
    so a multi-chip mesh scores 1e7+ candidates with each chip running
    :func:`_mice_score_step` on its own block shard against replicated
    design buffers.  Fully-masked padding blocks make the block count a
    device multiple."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ax = mesh.axis_names[0]

    def body(cb, cm):
        return _mice_score_step(
            raw, data, mask, cb, cm, fast_nugget, nugget_s, kernel,
            nugget_type, weak_mean,
        )

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(ax, None, None), P(ax, None)),
        out_specs=(P(ax), P(ax)),
        check_vma=False,
    )
    return fn(cand_blocks, cand_mask)


class DeviceMICEDesign(MICEDesign):
    """MICE design whose acquisition loop runs in two fixed-shape device
    programs (see module docstring).

    Drop-in for :class:`MICEDesign` (same SequentialDesign state machine,
    save/load, batch points); differences:

    * ``n_samples`` (or an explicit ``n_max``) must be known up front to
      preallocate the design buffers.
    * ``cand_block`` controls the candidate-GP block size for very large
      candidate sets (default: dense up to 4096 candidates, 4096-blocks
      beyond -- block-local LOO approximation).  Measured quality of the
      approximation: at the production 4096-block the
      median relative score deviation vs the dense joint-candidate
      criterion is ~0.2% and the argmax regret (dense-criterion loss of
      the block-locally selected candidate) is 0; deviation shrinks with
      block size and is governed by per-block candidate density, so
      i.i.d./LHC candidate sets -- where every contiguous block is a
      representative subsample -- stay accurate at any ``n_cand``.
      Test-pinned: ``tests/test_mice_device.py::
      test_block_local_loo_bounded_deviation``.
    * ``mesh`` shards candidate BLOCKS over a ``jax.sharding.Mesh`` for
      the scoring step (blocks are independent; each device scores its
      shard against replicated design buffers), scaling the candidate
      sweep to multi-chip sizes.
    * The internal GP per-step refit uses the same batched-restart
      device L-BFGS as ``fit_GP_MAP`` (``n_tries``/``maxiter`` exposed
      here); a failed step redraws its restarts instead of re-entering a
      full host fit (the reference's 10x full-refit retry loop,
      ``SequentialDesign.py:933-964``).
    """

    def __init__(self, base_design, f=None, n_samples=None, n_init=10,
                 n_cand=50, nugget="adaptive", nugget_s=1.0, n_max=None,
                 n_tries=15, maxiter=200, cand_block=None,
                 kernel="SquaredExponential", mesh=None):
        super().__init__(base_design, f, n_samples, n_init, n_cand,
                         nugget, nugget_s)
        if nugget == "pivot":
            raise ValueError(
                "DeviceMICEDesign does not support nugget='pivot' (the "
                "masked fixed-shape covariance requires a jitter-masked "
                "factorization; pivoted Cholesky has no masked form) -- "
                "use MICEDesign for pivot-nugget designs"
            )
        self._kernel = get_kernel(kernel)
        if n_max is None:
            if n_samples is None:
                raise ValueError(
                    "DeviceMICEDesign needs n_samples or n_max to "
                    "preallocate the fixed-shape design buffers"
                )
            n_max = int(n_init) + int(n_samples)
        self.n_max = int(n_max)
        self.n_tries = int(n_tries)
        self.maxiter = int(maxiter)
        if cand_block is None:
            cand_block = min(self.n_cand, 4096)
        self.cand_block = int(cand_block)
        self.mesh = mesh
        # pad the BLOCK COUNT to a device multiple when scoring on a
        # mesh (padding blocks are fully masked)
        n_blocks = -(-self.n_cand // self.cand_block)
        if mesh is not None:
            n_dev = mesh.shape[mesh.axis_names[0]]
            n_blocks = -(-n_blocks // n_dev) * n_dev
        self._n_cand_pad = n_blocks * self.cand_block
        self._last_scores = None
        self._last_mu = None
        self._theta = None

    def get_current_theta(self):
        """Raw hyperparameters of the most recent per-step refit."""
        return self._theta

    def _nugget_type_and_value(self):
        if isinstance(self.nugget, str):
            return self.nugget, 0.0
        return "fixed", float(self.nugget)

    def _eval_metric(self):
        """Fixed-shape device acquisition (``SequentialDesign.py:933-964``)."""
        from ..config import default_dtype
        from ..models.fitting import _OPT_LADDER

        n_obs = self.inputs.shape[0]
        if n_obs > self.n_max:
            raise RuntimeError(
                "design grew past the preallocated n_max={} buffers; "
                "construct DeviceMICEDesign with a larger n_max".format(
                    self.n_max
                )
            )
        D = self.get_n_parameters()
        dtype = default_dtype()

        # standardized targets (scale-invariant criterion; keeps f32
        # factorizations conditioned -- see MICEDesign._eval_metric)
        self._t_mean = float(np.mean(self.targets))
        self._t_std = float(np.std(self.targets)) or 1.0
        targets_std = (self.targets - self._t_mean) / self._t_std

        # preallocated buffers: masked rows repeat the first point (any
        # finite value works; they are exactly decoupled by the mask)
        inputs_buf = np.tile(self.inputs[:1], (self.n_max, 1))
        inputs_buf[:n_obs] = self.inputs
        targets_buf = np.zeros(self.n_max)
        targets_buf[:n_obs] = targets_std
        mask = np.zeros(self.n_max)
        mask[:n_obs] = 1.0

        nugget_type, nugget_value = self._nugget_type_and_value()
        # data-driven priors from the OBSERVED design spacing
        # (Priors.py:85-152); shapes are n_obs-independent.  The
        # correlation-slot count comes from the KERNEL (uniform forms
        # have one shared length, not D)
        priors = GPPriors.default_priors(
            self.inputs, self._kernel.get_n_params(self.inputs),
            nugget_type=nugget_type,
        )
        data = make_gp_data(
            inputs_buf, targets_buf, np.zeros((self.n_max, 0)), priors,
            nugget_value=nugget_value, dtype=dtype,
        )
        mask_j = jnp.asarray(mask, dtype=dtype)

        # batched-restart MAP refit; a fully-failed draw redraws starts
        # (cheap -- no recompilation, same program).  With an ADAPTIVE
        # nugget, three failed draws escalate to the full reference
        # jitter ladder (problems genuinely needing large jitter NaN at
        # every start under the reduced trajectory ladder -- see
        # models/fitting.py ladder escalation); for fit/fixed nuggets
        # the ladder does not exist, so escalating would only force a
        # pointless recompile of an identical program
        best_raw = None
        for attempt in range(10):
            starts = jnp.asarray(
                np.asarray(priors.sample_n(self.n_tries)), dtype=dtype
            )
            ladder = (
                False if (attempt >= 3 and nugget_type == "adaptive")
                else _OPT_LADDER
            )
            fun, xs = _mice_fit_step(
                starts, data, mask_j, self._kernel, nugget_type, True,
                self.maxiter, None, None, ladder,
            )
            fun = np.asarray(fun, dtype=np.float64)
            finite = np.isfinite(fun)
            if finite.any():
                best_raw = np.asarray(xs, dtype=np.float64)[
                    int(np.nanargmin(np.where(finite, fun, np.inf)))
                ]
                break
        if best_raw is None:
            raise RuntimeError(
                "Unable to find parameters suitable for both GPs"
            )
        self._theta = best_raw

        # candidate blocks, padded to a block multiple; padded lanes are
        # masked out of the block covariance (unit pivots)
        cands = np.tile(self.candidates[:1], (self._n_cand_pad, 1))
        cands[: self.n_cand] = self.candidates
        cand_blocks = jnp.asarray(
            cands.reshape(-1, self.cand_block, D), dtype=dtype
        )
        cmask = np.zeros(self._n_cand_pad)
        cmask[: self.n_cand] = 1.0
        cand_mask = jnp.asarray(
            cmask.reshape(-1, self.cand_block), dtype=dtype
        )

        # smoothing nugget for the candidate GP, floored as in
        # MICEDesign._eval_metric (stabilized vs the reference's
        # LinAlgError retry)
        raw_j = jnp.asarray(best_raw, dtype=dtype)
        if nugget_type == "adaptive":
            # realized jitter is recomputed inside the score step, where
            # the effective smoothing nugget becomes max(realized *
            # nugget_s, floor) -- host MICEDesign semantics; the host
            # floor below only needs the fitted signal variance
            base_nugget = 0.0
        elif nugget_type == "fit":
            base_nugget = float(np.exp(best_raw[-1]))
        else:
            base_nugget = nugget_value
        n_corr = self._kernel.get_n_params(self.inputs)
        sigma2 = float(np.exp(best_raw[n_corr]))
        eps = float(np.finfo(np.dtype(dtype)).eps)
        fast_nugget = max(base_nugget * self.nugget_s, 1e3 * eps * sigma2)

        nugget_s_j = jnp.asarray(self.nugget_s, dtype=dtype)
        if self.mesh is not None:
            scores, mu = _mice_score_step_sharded(
                self.mesh, raw_j, data, mask_j, cand_blocks, cand_mask,
                jnp.asarray(fast_nugget, dtype=dtype), nugget_s_j,
                self._kernel, nugget_type, True,
            )
        else:
            scores, mu = _mice_score_step(
                raw_j, data, mask_j, cand_blocks, cand_mask,
                jnp.asarray(fast_nugget, dtype=dtype), nugget_s_j,
                self._kernel, nugget_type, True,
            )
        scores = np.asarray(scores, dtype=np.float64)[: self.n_cand]
        mu = np.asarray(mu, dtype=np.float64)[: self.n_cand]
        scores = np.where(np.isfinite(scores), scores, -np.inf)
        if not np.any(np.isfinite(scores)):
            raise RuntimeError(
                "Unable to find parameters suitable for both GPs"
            )
        self._last_scores = scores
        self._last_mu = mu
        self._last_index = int(np.argmax(scores))
        return self._last_index

    def _MICE_criterion(self, data_point):
        """Per-candidate criterion from the last acquisition step."""
        data_point = int(data_point)
        assert 0 <= data_point < self.n_cand, "test point index is out of range"
        assert self._last_scores is not None, "no acquisition step has run"
        return float(self._last_scores[data_point])

    def _estimate_next_target(self, next_point):
        """Batch-mode target estimate from the base GP's predictive mean
        at the chosen candidate (already computed in the score step)."""
        next_point = np.array(next_point)
        assert next_point.shape == (self.get_n_parameters(),), (
            "bad shape for next_point"
        )
        assert self._last_mu is not None, "no acquisition step has run"
        # the cached mean is only valid for the point the last
        # acquisition step selected; estimating any other point needs a
        # fresh prediction this class does not cache.  A ValueError (not
        # an assert) so the guard survives ``python -O`` -- this is a
        # documented narrowing of the base-class contract, which
        # predicts at any supplied point.
        if not np.allclose(
            next_point, self.candidates[self._last_index],
            rtol=1e-6, atol=1e-8,
        ):
            raise ValueError(
                "DeviceMICEDesign._estimate_next_target only supports "
                "the candidate selected by the last get_next_point "
                "(the cached predictive mean belongs to that point); "
                "use MICEDesign for arbitrary-point estimates"
            )
        return np.atleast_1d(
            self._last_mu[self._last_index] * self._t_std + self._t_mean
        )
