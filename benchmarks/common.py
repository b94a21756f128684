"""Shared helpers for the benchmark suite."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mogp_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

__all__ = ["branin", "rosenbrock", "print_table"]


def branin(x, a=1.0, b=5.1 / (4 * np.pi**2), c=5 / np.pi, r=6.0, s=10.0,
           t=1 / (8 * np.pi)):
    """Branin test function on [-5, 10] x [0, 15] (standard form)."""
    x1, x2 = x[..., 0], x[..., 1]
    return (
        a * (x2 - b * x1**2 + c * x1 - r) ** 2
        + s * (1 - t) * np.cos(x1)
        + s
    )


def rosenbrock(x):
    """Rosenbrock function in arbitrary dimension."""
    return np.sum(
        100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
        + (1.0 - x[..., :-1]) ** 2,
        axis=-1,
    )


def print_table(header, rows):
    print("  ".join("{:>14}".format(h) for h in header))
    for row in rows:
        print(
            "  ".join(
                "{:14.6g}".format(v) if isinstance(v, float) else "{:>14}".format(v)
                for v in row
            )
        )
