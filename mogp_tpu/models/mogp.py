"""Multi-output GP emulator with batched (vmapped) prediction and fitting.

Re-design of ``mogp_emulator/MultiOutputGP.py`` (GPU analogue
``mogp_gpu/src/multioutputgp_gpu.hpp``): the reference distributes its
independent per-output emulators over a ``multiprocessing.Pool``
(``MultiOutputGP.py:306-309``) or an OpenMP loop
(``multioutputgp_gpu.hpp:180-228``).  Here outputs are a *batch axis*:
emulators sharing a configuration signature (kernel, mean, nugget
handling, shapes) are stacked into one ``GPData`` pytree with a leading
outputs axis and pushed through ``vmap``-ed fit/predict cores in a single
XLA program -- which also gives the mesh-sharding story for free (see
``mogp_tpu.parallel``).

The public surface (``emulators`` list, ``get_indices_fit`` /
``get_indices_not_fit``, NaN predictions via ``allow_not_fit``) matches
the reference (``MultiOutputGP.py:19-546``).
"""

import warnings
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.kernels import KernelBase
from .gp import (
    GaussianProcess,
    PredictResult,
    _predict_tile_size,
    gp_predict,
    gp_predict_tiled,
)
from .priors import GPPriors

__all__ = ["MultiOutputGP", "MultiOutputGPBase"]


class MultiOutputGPBase:
    """Base class for multi-output GPs (``MultiOutputGP.py:13``)."""


def _stack_pytrees(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


class MultiOutputGP(MultiOutputGPBase):
    """Multiple independent GP emulators over shared inputs
    (``MultiOutputGP.py:19``)."""

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
    ):
        if inputdict:
            warnings.warn(
                "The inputdict interface for mean functions has been deprecated.",
                DeprecationWarning,
            )

        inputs = np.asarray(inputs, dtype=np.float64)
        targets = np.asarray(targets, dtype=np.float64)
        if inputs.ndim == 1:
            inputs = np.reshape(inputs, (-1, 1))
        if targets.ndim == 1:
            targets = np.reshape(targets, (1, -1))
        elif targets.ndim != 2:
            raise ValueError("targets must be either a 1D or 2D array")
        if inputs.ndim != 2:
            raise ValueError("inputs must be either a 1D or 2D array")
        if inputs.shape[0] != targets.shape[1]:
            raise ValueError(
                "the first dimension of inputs must be the same length as "
                "the second dimension of targets (or first if targets is 1D)"
            )

        self._n_emulators = targets.shape[0]
        self._n = inputs.shape[0]
        self._D = inputs.shape[1]

        if not isinstance(mean, list):
            mean = self.n_emulators * [mean]
        assert len(mean) == self.n_emulators

        if isinstance(kernel, str) or issubclass(type(kernel), KernelBase):
            kernel = self.n_emulators * [kernel]
        assert isinstance(kernel, list)
        assert len(kernel) == self.n_emulators

        if isinstance(priors, (GPPriors, dict)) or priors is None:
            priorslist = self.n_emulators * [priors]
        else:
            priorslist = list(priors)
            assert len(priorslist) == self.n_emulators, (
                "Bad length for list provided for priors to MultiOutputGP"
            )

        if isinstance(nugget, (str, float)):
            nugget = self.n_emulators * [nugget]
        assert isinstance(nugget, list)
        assert len(nugget) == self.n_emulators

        self.emulators = [
            GaussianProcess(inputs, single_target, m, k, p, n)
            for (single_target, m, k, p, n) in zip(
                targets, mean, kernel, priorslist, nugget
            )
        ]

    # -- properties ---------------------------------------------------------

    @property
    def inputs(self):
        return self.emulators[0].inputs

    @property
    def targets(self):
        return np.array([em.targets for em in self.emulators])

    @property
    def D(self):
        return self._D

    @property
    def n(self):
        return self._n

    @property
    def n_params(self):
        return [em.n_params for em in self.emulators]

    @property
    def n_emulators(self):
        return self._n_emulators

    def reset_fit_status(self):
        for em in self.emulators:
            em.theta = None

    def _process_inputs(self, inputs):
        return self.emulators[0]._process_inputs(inputs)

    # -- grouping for batched execution -------------------------------------

    @staticmethod
    def _mean_sig(em):
        """Hashable identity of an emulator's mean specification.  The
        mean must be part of the batch signature -- grouped prediction
        evaluates ONE design matrix (``em0.get_design_matrix``) for the
        whole group, so two emulators with different formulas that
        happen to share a column count (e.g. ``"x[0]"`` vs ``"x[1]"``)
        must NOT batch together.  Memoized on the emulator (``_mean`` is
        set once at construction): array means would otherwise be
        re-serialized on every ``_groups`` call."""
        key = getattr(em, "_mean_sig_cache", None)
        if key is None:
            mean = em._mean
            if mean is None or isinstance(mean, str):
                key = ("s", mean)
            elif callable(mean):
                key = ("c", id(mean))
            else:
                import hashlib

                key = ("a", hashlib.sha1(
                    np.ascontiguousarray(
                        np.asarray(mean, dtype=np.float64)
                    ).tobytes()
                ).hexdigest())
            em._mean_sig_cache = key
        return key

    def _signature(self, em):
        """Emulators with equal signatures can share one compiled batch."""
        return (
            em.kernel,
            em.nugget_type,
            em.n_mean,
            self._mean_sig(em),
            em._data.prior_codes.shape,
            tuple(np.asarray(em._data.prior_codes).tolist()),
        )

    def _groups(self, emulators=None):
        groups = {}
        emulators = self.emulators if emulators is None else emulators
        for idx, em in enumerate(emulators):
            groups.setdefault(self._signature(em), []).append(idx)
        return groups

    # -- prediction ---------------------------------------------------------

    def predict(
        self,
        testing,
        unc=True,
        deriv=False,
        include_nugget=True,
        full_cov=False,
        allow_not_fit=False,
        processes=None,
        max_batch_size=None,
    ):
        """Batched prediction over all emulators
        (``MultiOutputGP.py:182-324``).

        ``processes`` is accepted for API parity but ignored: outputs are
        a vmapped batch axis in one XLA program rather than a process
        pool.  ``max_batch_size`` bounds per-output device memory by
        tiling the query axis (reference GPU batching,
        ``MultiOutputGP_GPU.py:52`` ``batch_size=16000``); default
        ``None`` auto-chunks very large sweeps.
        """
        testing = np.asarray(testing, dtype=np.float64)
        if self.D == 1 and testing.ndim == 1:
            testing = np.reshape(testing, (-1, 1))
        elif testing.ndim == 1:
            testing = np.reshape(testing, (1, len(testing)))
        assert testing.ndim == 2, "testing must be a 2D array"
        n_testing, D = testing.shape
        assert D == self.D, (
            "second dimension of testing must be the same as the number of "
            "input parameters"
        )
        if deriv:
            warnings.warn(
                "Prediction derivatives have been deprecated and are no "
                "longer supported",
                DeprecationWarning,
            )

        unfit = self.get_indices_not_fit()
        if unfit and not allow_not_fit:
            raise ValueError(
                "hyperparameters have not been fit for emulators {}".format(unfit)
            )

        mean_out = np.full((self.n_emulators, n_testing), np.nan)
        if full_cov:
            unc_out = np.full((self.n_emulators, n_testing, n_testing), np.nan)
        else:
            unc_out = np.full((self.n_emulators, n_testing), np.nan)

        fit_indices = [i for i in range(self.n_emulators) if i not in set(unfit)]
        for sig, indices in self._groups([self.emulators[i] for i in fit_indices]).items():
            global_idx = [fit_indices[i] for i in indices]
            ems = [self.emulators[i] for i in global_idx]
            em0 = ems[0]
            dtype = em0._data.inputs.dtype
            arts = _stack_pytrees([em._artifacts for em in ems])
            data = _stack_pytrees([em._data for em in ems])
            dmtest = em0.get_design_matrix(testing)
            tile = 0 if full_cov else _predict_tile_size(
                n_testing, max_batch_size, n_train=self.n, n_lanes=len(ems)
            )
            if tile:
                mu, var = _batched_predict_tiled(
                    arts,
                    data,
                    jnp.asarray(testing, dtype=dtype),
                    jnp.asarray(dmtest, dtype=dtype),
                    em0.kernel,
                    em0.nugget_type,
                    bool(unc),
                    bool(include_nugget),
                    tile,
                )
            else:
                mu, var = _batched_predict(
                    arts,
                    data,
                    jnp.asarray(testing, dtype=dtype),
                    jnp.asarray(dmtest, dtype=dtype),
                    em0.kernel,
                    em0.nugget_type,
                    bool(unc),
                    bool(include_nugget),
                    bool(full_cov),
                )
            mean_out[global_idx] = np.asarray(mu, dtype=np.float64)
            if unc:
                unc_out[global_idx] = np.asarray(var, dtype=np.float64)

        return PredictResult(
            mean=mean_out, unc=(unc_out if unc else None), deriv=None
        )

    def __call__(self, testing, processes=None):
        return self.predict(testing, unc=False, deriv=False, processes=processes)[0]

    # -- fitting ------------------------------------------------------------

    def fit(self, thetas):
        """Fit all emulators at given hyperparameters
        (``MultiOutputGP.py:331-356``)."""
        for thetaval, em in zip(thetas, self.emulators):
            em.fit(thetaval)

    def fit_emulator(self, index, theta):
        self.emulators[index].fit(theta)

    # -- fit-status bookkeeping (``MultiOutputGP.py:362-460``) --------------

    def get_indices_fit(self):
        return [
            idx
            for idx, em in enumerate(self.emulators)
            if em.theta.get_data() is not None
        ]

    def get_indices_not_fit(self):
        return [
            idx
            for idx, em in enumerate(self.emulators)
            if em.theta.get_data() is None
        ]

    def get_emulators_fit(self):
        return [em for em in self.emulators if em.theta.get_data() is not None]

    def get_emulators_not_fit(self):
        return [em for em in self.emulators if em.theta.get_data() is None]

    def __str__(self):
        return (
            "Multi-Output Gaussian Process with:\n"
            + str(self.n_emulators)
            + " emulators\n"
            + str(self.n)
            + " training examples\n"
            + str(self.D)
            + " input variables"
        )


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "unc", "include_nugget", "full_cov"),
)
def _batched_predict(
    arts, data, testing, dmtest, kernel, nugget_type, unc, include_nugget, full_cov
):
    """vmap of the single-GP predict core over the outputs axis."""
    return jax.vmap(
        lambda a, d: gp_predict(
            a,
            d,
            testing,
            dmtest,
            kernel,
            nugget_type,
            unc=unc,
            include_nugget=include_nugget,
            full_cov=full_cov,
        )
    )(arts, data)


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "unc", "include_nugget", "tile"),
)
def _batched_predict_tiled(
    arts, data, testing, dmtest, kernel, nugget_type, unc, include_nugget, tile
):
    """Outputs-vmapped, query-tiled predict: per-output memory is bounded
    by the (n, tile) working set regardless of the sweep size."""
    return jax.vmap(
        lambda a, d: gp_predict_tiled(
            a,
            d,
            testing,
            dmtest,
            kernel,
            nugget_type,
            unc=unc,
            include_nugget=include_nugget,
            tile=tile,
        )
    )(arts, data)
