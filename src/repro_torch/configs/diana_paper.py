"""The paper's own experimental configurations (Sec. 6 / Sec. M), the port's
copy of ``repro.configs.diana_paper``.

Convex experiments: l2/l1-regularised logistic regression on synthetic data
at the scale of LIBSVM 'mushrooms', the parameter grids the paper sweeps, and
the Rosenbrock decomposition of Sec. M.1.  Used by
:mod:`repro_torch.benchmarks.common`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["LogRegProblem", "PAPER_GRIDS", "ROSENBROCK"]


@dataclass(frozen=True)
class LogRegProblem:
    """Synthetic stand-in for the paper's LIBSVM problems (no dataset
    downloads): n_samples x dim binary classification, the scale of
    'mushrooms' (8124 x 112) / 'a5a' (6414 x 122)."""

    name: str = "mushrooms-synthetic"
    n_samples: int = 8124
    dim: int = 112
    n_workers: int = 10
    l2: float = 1e-4           # order 1/N as in the paper
    l1: float = 2e-3           # the paper's l1 coefficient (sparse solutions)
    seed: int = 0


# Hyper-parameter grids from Sec. 6 (Cifar10/Mnist runs)
PAPER_GRIDS = {
    "learning_rates": (0.1, 0.2, 0.05),
    "bucket_sizes": (32, 128, 512),
    "momentum": (0.0, 0.95, 0.99),
    "alphas": ("0", "1/sqrt(bucket)"),
    "norms": (2.0, math.inf),
}


# Sec. M.1: f = average of f1, f2; each worker holds one piece.
# f(x, y) = (x-1)^2 + 10(y - x^2)^2
# f1 = (x+16)^2 + 10(y-x^2)^2 + 16y ; f2 = (x-18)^2 + 10(y-x^2)^2 - 16y + c
ROSENBROCK = {
    "f1": lambda x, y: (x + 16.0) ** 2 + 10.0 * (y - x * x) ** 2 + 16.0 * y,
    "f2": lambda x, y: (x - 18.0) ** 2 + 10.0 * (y - x * x) ** 2 - 16.0 * y,
    "optimum": (1.0, 1.0),
}
