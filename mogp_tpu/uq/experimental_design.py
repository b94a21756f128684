"""One-shot experimental designs (Monte Carlo / Latin Hypercube / MaxiMin).

Re-design of ``mogp_emulator/ExperimentalDesign.py``: the API
(PPF-based parameter specification with the same five input conventions,
``ExperimentalDesign.py:32-188``) is preserved, but sampling is
vectorized:

* the PPF mapping applies per-column over the whole draw instead of the
  reference's per-element double loop (``ExperimentalDesign.py:276-280``);
* MaxiMin search (``ExperimentalDesign.py:628-668``: 1000 serial LHC
  draws, each scored with ``scipy.spatial.distance.pdist``) generates all
  candidate hypercubes at once and scores their min pairwise distances in
  one batched device computation -- the argmax over tries is a single
  reduction.
"""

from inspect import signature

import numpy as np
import scipy.stats

import jax
import jax.numpy as jnp

__all__ = [
    "ExperimentalDesign",
    "MonteCarloDesign",
    "LatinHypercubeDesign",
    "MaxiMinLHC",
]


def _as_count(value):
    """Interpret ``value`` as a parameter count, or return ``None``."""
    if isinstance(value, bool) or isinstance(value, str):
        return None
    try:
        return int(value)
    except (TypeError, ValueError):
        return None


def _as_list(value):
    """Materialize a non-string sequence as a list, or return ``None``."""
    if isinstance(value, str):
        return None
    try:
        return list(value)
    except TypeError:
        return None


def _is_bounds_pair(seq):
    """True when ``seq`` is two scalars, i.e. a ``(lo, hi)`` bounds pair."""
    if len(seq) != 2:
        return False
    for v in seq:
        if callable(v) or _as_list(v) is not None:
            return False
        try:
            float(v)
        except (TypeError, ValueError):
            return False
    return True


def _spec_to_ppf(spec):
    """Convert one parameter spec to a PPF callable.

    ``None`` -> uniform [0, 1]; ``(lo, hi)`` -> uniform [lo, hi] (requires
    ``lo < hi``); a callable must take exactly one argument.
    """
    if spec is None:
        return scipy.stats.uniform(loc=0.0, scale=1.0).ppf
    if callable(spec):
        if len(signature(spec).parameters) != 1:
            raise ValueError(
                "PPF distribution provided must accept a single argument"
            )
        return spec
    seq = _as_list(spec)
    if seq is None or not _is_bounds_pair(seq):
        raise TypeError("bounds for each parameter must be a tuple of two floats")
    lo, hi = float(seq[0]), float(seq[1])
    if hi <= lo:
        raise ValueError("bad value for parameter bounds in ExperimentalDesign")
    return scipy.stats.uniform(loc=lo, scale=hi - lo).ppf


class ExperimentalDesign:
    """Base one-shot design with uncorrelated parameters
    (``ExperimentalDesign.py:6-295``).

    Parameter space is specified by PPF (inverse-CDF) functions, one per
    parameter; sampling draws from ``[0,1]^n`` (method-specific) and maps
    through the PPFs.
    """

    def __init__(self, *args):
        """Accepts the reference's five input conventions
        (``ExperimentalDesign.py:32-188``) via a normalize-then-convert
        design: arguments are first reduced to a list of one spec per
        parameter, then each spec is turned into a PPF by
        :func:`_spec_to_ppf`.

        Conventions: ``ED(n)``, ``ED(list_of_specs)``, ``ED(n, (lo, hi))``,
        ``ED(n, ppf_callable)``, ``ED(n, list_of_specs)``; a spec is a
        ``(lo, hi)`` pair, a single-argument PPF callable, or ``None``
        (uniform on [0, 1]).
        """
        if not 1 <= len(args) <= 2:
            raise ValueError("bad inputs for ExperimentalDesign")

        specs = self._normalize_args(args)
        if len(specs) <= 0:
            raise ValueError(
                "number of parameters must be positive in Experimental Design"
            )
        self.n_parameters = len(specs)
        self.distributions = [_spec_to_ppf(spec) for spec in specs]

    @staticmethod
    def _normalize_args(args):
        """Reduce constructor args to a per-parameter spec list."""
        first = args[0]
        if _as_count(first) is not None:
            n = _as_count(first)
            shared = args[1] if len(args) == 2 else None
            if len(args) == 2 and not callable(shared):
                # a 2-sequence of scalars is (lo, hi) shared bounds; any
                # other sequence is a per-parameter spec list
                seq = _as_list(shared)
                if seq is None:
                    raise TypeError("bad input type for ExperimentalDesign")
                if _is_bounds_pair(seq):
                    shared = (float(seq[0]), float(seq[1]))
                else:
                    if len(seq) != n:
                        raise ValueError(
                            "list of parameter distributions must have the "
                            "same length"
                        )
                    return seq
            return [shared] * n
        if len(args) == 2:
            raise TypeError("bad input type for ExperimentalDesign")
        seq = _as_list(first)
        if seq is None:
            raise TypeError("bad input type for ExperimentalDesign")
        return seq

    def get_n_parameters(self):
        return self.n_parameters

    def get_method(self):
        try:
            return self.method
        except AttributeError:
            raise NotImplementedError(
                "base class of ExperimentalDesign does not implement a method"
            )

    def _draw_samples(self, n_samples):
        raise NotImplementedError

    def sample(self, n_samples, **kwargs):
        """Draw parameter samples (``ExperimentalDesign.py:239-284``).

        PPF application is vectorized per parameter column."""
        n_samples = int(n_samples)
        assert n_samples > 0, "number of samples must be positive"

        random_draws = self._draw_samples(n_samples, **kwargs)
        assert np.all(random_draws >= 0.0) and np.all(random_draws <= 1.0), (
            "error in generating random samples"
        )

        sample_values = np.empty((n_samples, self.get_n_parameters()))
        for index, dist in enumerate(self.distributions):
            try:
                sample_values[:, index] = np.asarray(
                    dist(random_draws[:, index])
                ).reshape(-1)
            except (TypeError, ValueError):
                # PPF that only accepts scalars
                sample_values[:, index] = [
                    dist(v) for v in random_draws[:, index]
                ]

        assert np.all(np.isfinite(sample_values)), (
            "error due to non-finite values of parameters"
        )
        return sample_values

    def __str__(self):
        try:
            method = self.get_method() + " "
        except NotImplementedError:
            method = ""
        return (
            method
            + "Experimental Design with "
            + str(self.get_n_parameters())
            + " parameters"
        )


class MonteCarloDesign(ExperimentalDesign):
    """Monte Carlo design (``ExperimentalDesign.py:297-430``)."""

    method = "Monte Carlo"

    def _draw_samples(self, n_samples, **kwargs):
        return np.random.random((int(n_samples), self.get_n_parameters()))


class LatinHypercubeDesign(ExperimentalDesign):
    """Latin Hypercube design (``ExperimentalDesign.py:432-584``): each
    sample occupies a unique stratum of each parameter's distribution."""

    method = "Latin Hypercube"

    def _draw_samples(self, n_samples, **kwargs):
        n_samples = int(n_samples)
        assert n_samples > 0, "number of samples must be positive"
        n_parameters = self.get_n_parameters()
        # shuffled strata + intra-stratum jitter (ExperimentalDesign.py:550-580)
        strata = np.argsort(
            np.random.random((n_samples, n_parameters)), axis=0
        ).astype(np.float64)
        samples = (strata + np.random.random((n_samples, n_parameters))) / float(
            n_samples
        )
        assert np.all(samples >= 0.0) and np.all(samples <= 1.0)
        return samples


def _use_device_scorer():
    """MaxiMin scoring runs on the device when an accelerator is active,
    or when the native host scorer cannot be built."""
    from .. import native
    from ..compat import gpu_usable

    return gpu_usable() or not native.native_usable()


@jax.jit
def _min_pdist_batch(candidates):
    """Minimum pairwise Euclidean distance per candidate design.

    ``candidates``: (n_tries, n_samples, D).  One batched device
    computation replacing the reference's 1000 serial ``pdist`` calls
    (``ExperimentalDesign.py:663-668``).
    """
    sq = jnp.sum(candidates**2, axis=-1)
    # full float32 operands: the distance form cancels (see
    # ops.kernels.squared_distance)
    cross = jnp.einsum("tnd,tmd->tnm", candidates, candidates,
                       precision=jax.lax.Precision.HIGHEST)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * cross
    n = candidates.shape[1]
    eye = jnp.eye(n, dtype=bool)
    d2 = jnp.where(eye[None], jnp.inf, d2)
    return jnp.sqrt(jnp.maximum(jnp.min(d2, axis=(1, 2)), 0.0))


class MaxiMinLHC(LatinHypercubeDesign):
    """MaxiMin Latin Hypercube (``ExperimentalDesign.py:586-674``): of
    ``n_tries`` LHC draws, keep the one maximizing the minimum pairwise
    distance.  All candidates are generated and scored in one batch."""

    method = "MaxiMinLHC"

    def _draw_samples(self, n_samples, n_tries=1000, **kwargs):
        n_samples = int(n_samples)
        n_tries = int(n_tries)
        assert n_samples > 0, "number of samples must be positive"
        assert n_tries > 0, "n_tries must be a positive integer"
        n_parameters = self.get_n_parameters()

        strata = np.argsort(
            np.random.random((n_tries, n_samples, n_parameters)), axis=1
        ).astype(np.float64)
        candidates = (
            strata + np.random.random((n_tries, n_samples, n_parameters))
        ) / float(n_samples)

        min_dists = self._score_candidates(candidates)
        best = int(np.argmax(min_dists))
        best_samples = candidates[best]
        assert np.all(best_samples >= 0.0) and np.all(best_samples <= 1.0)
        return best_samples

    @staticmethod
    def _score_candidates(candidates):
        """Min pairwise distance per candidate design.

        Device path (see :func:`_use_device_scorer`): one batched
        program, chunked so the (chunk, n, n) distance tensor stays
        bounded in memory.  Host path: the native OpenMP scorer
        (``mogp_tpu.native.maximin_score``), which on a CPU backend skips
        the per-chunk dispatch overhead of the jitted program, mirroring
        the reference's host-side ``pdist`` loop
        (``ExperimentalDesign.py:663-668``) at full thread count.
        """
        n_tries, n_samples, _ = candidates.shape
        if not _use_device_scorer():
            from .. import native

            return native.maximin_score(candidates)
        max_elems = 1 << 26
        chunk = max(1, int(max_elems // max(n_samples * n_samples, 1)))
        min_dists = np.empty(n_tries)
        for c0 in range(0, n_tries, chunk):
            block = candidates[c0 : c0 + chunk]
            min_dists[c0 : c0 + len(block)] = np.asarray(
                _min_pdist_batch(jnp.asarray(block))
            )
        return min_dists
