"""Inner optimizers + learning-rate schedules, optax-style pairs of functions
over ``{path: tensor}`` trees (the port's copy of ``repro.optim.optimizers``):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)

``updates`` are descent directions already scaled by lr (a float, or the
0-dim f32 tensor a schedule returns).  The momentum buffer and AdamW's
``mu`` / ``nu`` are updated in place (each is as large as the model in f32).

AdamW spells out every rounding of the JAX package's ``adamw`` as eager JAX
performs it: a product and a sum are two roundings (``b1 * m`` then
``+ (1 - b1) * g``), never one fused multiply-add, ``b1 ** count`` is an
f32 power of f32 operands, and the square root is correctly rounded.  Under
``jit`` XLA may contract a product into a sum, so the port is bitwise eager
JAX and within a few f32 roundings of jitted JAX
(``tests/test_torch_optim_tail.py``).  The schedules return 0-dim f32
tensors computed in f32 as JAX computes them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple

import torch

__all__ = ["Optimizer", "AdamState", "sgd", "momentum", "adamw", "constant_schedule",
           "diana_decreasing_schedule", "warmup_cosine_schedule"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


def sgd() -> Optimizer:
    def init(params):
        return {}

    def update(grads: Mapping[str, torch.Tensor], state, params, lr: float):
        return {p: -lr * g.float() for p, g in grads.items()}, state

    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    """Heavy-ball momentum — Algorithm 1's ``v^k = beta v^{k-1} + ghat^k``."""

    def init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {p: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                for p, x in params.items()}

    def update(grads: Mapping[str, torch.Tensor], v: Dict[str, torch.Tensor], params,
               lr: float):
        for p, g in grads.items():
            v[p].mul_(beta).add_(g.float())  # in place: v is model-sized f32
        return {p: -lr * v[p] for p in grads}, v

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's and CUDA's: torch's
    vectorised CPU ``sqrt`` of f32 is not correctly rounded, so the root is
    taken in float64 (exact enough that rounding it to f32 is the correctly
    rounded f32 root)."""
    return torch.sqrt(x.double()).float()


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay (``repro.optim.optimizers.adamw``):
    ``step = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd * p]``, update
    ``-lr * step``."""

    def init(params: Mapping[str, torch.Tensor]) -> AdamState:
        z = lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device)  # noqa: E731
        return AdamState(mu={p: z(x) for p, x in params.items()},
                         nu={p: z(x) for p, x in params.items()}, count=0)

    def update(grads: Mapping[str, torch.Tensor], state: AdamState, params, lr):
        c = state.count + 1
        bc1 = 1 - torch.pow(_f32(b1), _f32(c))
        bc2 = 1 - torch.pow(_f32(b2), _f32(c))
        out = {}
        for p, g in grads.items():
            g = g.float()
            m, n = state.mu[p], state.nu[p]
            m.mul_(b1).add_(g * (1 - b1))           # in place: mu, nu are model-sized f32
            n.mul_(b2).add_(torch.square(g) * (1 - b2))
            step = (m / bc1.to(m.device)) / (_sqrt32(n / bc2.to(n.device)) + eps)
            if weight_decay:
                step = step + params[p].float() * weight_decay
            out[p] = -lr * step
        return out, AdamState(mu=state.mu, nu=state.nu, count=c)

    return Optimizer(init, update)


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def diana_decreasing_schedule(mu: float, theta: float) -> Callable[[int], torch.Tensor]:
    """Theorems 3 and 5: ``gamma^k = 2 / (mu k + theta)``, O(1/k) to the
    exact optimum."""
    # f32(2) / x, one rounding (``2.0 / tensor`` would be 2 * reciprocal(x))
    return lambda step: _f32(2.0) / (_f32(step) * mu + theta)


def warmup_cosine_schedule(peak: float, warmup: int, total: int,
                           floor: float = 0.0) -> Callable[[int], torch.Tensor]:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor`` at ``total``."""
    def f(step):
        s = _f32(step)
        warm = s * peak / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = ((peak - floor) * 0.5) * (1 + torch.cos(prog * math.pi)) + floor
        return torch.where(s < warmup, warm, cos)

    return f
