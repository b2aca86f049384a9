"""Proximal operators for the regularizers R the paper supports (the port's
copy of ``repro.core.prox``).

DIANA's iterate is ``x^{k+1} = prox_{gamma R}(x^k - gamma v^k)`` (Alg. 1 line
9) for any proper closed convex R, which QSGD/TernGrad cannot do (their
quantization noise does not vanish, so prox steps oscillate).

Every operator is closed-form and elementwise, mapped over ``{path: tensor}``
trees; ``gamma`` and the coefficients are Python floats, so each product
rounds in the tensor's dtype as the JAX package's weak-typed scalars do.
Signed zeros follow XLA's: ``sign(-0.0) = -0.0`` (torch's is +0.0) and
``maximum(-0.0, 0.0) = 0.0`` (torch's ``maximum`` / ``clamp`` keep -0.0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping

import torch

__all__ = ["Regularizer", "none", "l1", "l2", "elastic_net", "box_indicator",
           "nonneg_indicator"]


@dataclass(frozen=True)
class Regularizer:
    """A regularizer given by its value and proximal operator:
    ``prox(u, gamma)`` solves ``argmin_v gamma*R(v) + 0.5*||v-u||^2`` per leaf."""

    name: str
    value: Callable[[torch.Tensor], torch.Tensor]
    prox: Callable[[torch.Tensor, float], torch.Tensor]

    def tree_value(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return sum(torch.sum(self.value(leaf)) for leaf in tree.values())

    def tree_prox(self, tree: Mapping[str, torch.Tensor], gamma: float) -> Dict[str, torch.Tensor]:
        return {p: self.prox(u, gamma) for p, u in tree.items()}


def _sign(u: torch.Tensor) -> torch.Tensor:
    """XLA's sign: a zero keeps its own sign."""
    return torch.where(u == 0, u, torch.sign(u))


def _max(a: torch.Tensor, b: float) -> torch.Tensor:
    """XLA's ``maximum(a, b)`` for a scalar b: ``b`` unless ``a > b`` or NaN."""
    return torch.where((a > b) | torch.isnan(a), a, torch.full_like(a, b))


def _min(a: torch.Tensor, b: float) -> torch.Tensor:
    return torch.where((a < b) | torch.isnan(a), a, torch.full_like(a, b))


def _soft(u: torch.Tensor, t: float) -> torch.Tensor:
    return _sign(u) * _max(torch.abs(u) - t, 0.0)


def none() -> Regularizer:
    return Regularizer("none", value=torch.zeros_like, prox=lambda u, g: u)


def l1(lam: float) -> Regularizer:
    """R(x) = lam * ||x||_1; prox = soft-thresholding."""
    return Regularizer("l1", value=lambda x: lam * torch.abs(x),
                       prox=lambda u, gamma: _soft(u, gamma * lam))


def l2(lam: float) -> Regularizer:
    """R(x) = (lam/2) * ||x||_2^2; prox = shrinkage u / (1 + gamma*lam)."""
    return Regularizer("l2", value=lambda x: 0.5 * lam * x * x,
                       prox=lambda u, gamma: u / (1.0 + gamma * lam))


def elastic_net(lam1: float, lam2: float) -> Regularizer:
    """R(x) = lam1*||x||_1 + (lam2/2)*||x||_2^2."""
    return Regularizer(
        "elastic_net",
        value=lambda x: lam1 * torch.abs(x) + 0.5 * lam2 * x * x,
        prox=lambda u, gamma: _soft(u, gamma * lam1) / (1.0 + gamma * lam2))


def box_indicator(lo: float, hi: float) -> Regularizer:
    """Indicator of the box [lo, hi]^d, the paper's 'indicator-like' R (the
    nonconvex analysis assumes R constant on its domain); prox = projection."""

    def _value(x):
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, 0.0, torch.inf).to(x.dtype)

    return Regularizer("box", value=_value, prox=lambda u, g: _min(_max(u, lo), hi))


def nonneg_indicator() -> Regularizer:
    return Regularizer("nonneg",
                       value=lambda x: torch.where(x >= 0, 0.0, torch.inf).to(x.dtype),
                       prox=lambda u, g: _max(u, 0.0))
