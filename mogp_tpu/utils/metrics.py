"""Timing, throughput metrics, and profiling utilities.

The reference has no built-in observability (SURVEY §5: ad-hoc
``time()`` calls in benchmark scripts).  This module provides the
framework's counters:

* ``Timer`` / ``PhaseTimer`` -- wall-clock timing with device
  synchronization (``block_until_ready``) so jitted work is measured
  honestly.
* FLOP estimators for the hot ops and derived ``tflops_per_sec``.
* ``fits_per_sec`` / ``ess_per_sec`` -- the framework's headline
  throughput metrics (BASELINE.json).
* ``profile_trace`` -- context manager around the JAX profiler for
  XPlane/TensorBoard traces.
"""

import contextlib
import logging
import time

import jax

__all__ = [
    "Timer",
    "PhaseTimer",
    "flops_kernel_matrix",
    "flops_cholesky",
    "flops_gp_nlp",
    "tflops_per_sec",
    "fits_per_sec",
    "ess_per_sec",
    "profile_trace",
    "get_logger",
]


def get_logger(name="mogp_tpu"):
    """Framework logger (the reference uses bare ``print``; SURVEY §5)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class Timer:
    """Context manager measuring wall time with device sync.

    >>> with Timer() as t:
    ...     out = jitted_fn(x)
    ...     t.sync(out)
    >>> t.elapsed
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.elapsed = None
        return self

    def sync(self, *outputs):
        """Wait until the device has finished computing ``outputs``."""
        jax.block_until_ready(outputs)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


class PhaseTimer:
    """Accumulating per-phase timings (K-build / factorize / solve /
    optimize ...); prints a table on demand."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        lines = ["{:<24} {:>10} {:>12}".format("phase", "calls", "seconds")]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                "{:<24} {:>10} {:>12.4f}".format(
                    name, self.counts[name], self.totals[name]
                )
            )
        return "\n".join(lines)


# -- FLOP estimators ---------------------------------------------------------

def flops_kernel_matrix(n, m, D):
    """FLOPs for one kernel-matrix build (matmul form + elementwise)."""
    return 2.0 * n * m * D + 10.0 * n * m


def flops_cholesky(n):
    """FLOPs for one n x n Cholesky factorization."""
    return n**3 / 3.0


def flops_gp_nlp(n, D, n_mean=0, adaptive_candidates=6):
    """Approximate FLOPs for one negative-log-posterior evaluation."""
    return (
        flops_kernel_matrix(n, n, D)
        + adaptive_candidates * flops_cholesky(n)
        + 2.0 * n * n * (2 + n_mean)  # solves
    )


def tflops_per_sec(flops, seconds):
    return flops / seconds / 1e12


def fits_per_sec(n_fits, seconds):
    """Emulator fits per second (the tsunami-benchmark headline metric)."""
    return n_fits / seconds


def ess_per_sec(ess, seconds):
    """Effective samples per second for MCMC runs (per parameter, use the
    minimum across parameters for a conservative figure)."""
    import numpy as np

    return float(np.min(ess)) / seconds


@contextlib.contextmanager
def profile_trace(logdir):
    """JAX profiler trace (view in TensorBoard / XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
