"""Inner optimizers + learning-rate schedules, optax-style pairs of functions
over ``{path: tensor}`` trees (the port's copy of ``repro.optim.optimizers``):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)

``updates`` are descent directions already scaled by lr.  The momentum buffer
is updated in place (it is as large as the model in f32).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple

import torch

__all__ = ["Optimizer", "sgd", "momentum", "constant_schedule"]


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


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: lr
