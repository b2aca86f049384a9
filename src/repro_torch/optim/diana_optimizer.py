"""DianaOptimizer — the paper's iterate as one update rule.

Per step (Algorithm 1):
    1. per-worker grads g_i              (the trainer)
    2. ghat and the h memories           (the bucketed DIANA round: the
                                          in-turn round or
                                          ``core.diana.aggregate_distributed``)
    3. v = inner optimizer on ghat       (momentum beta -> paper's v^k)
    4. x = x + update, written back in the parameter dtype

This module owns steps 3-4 and the state plumbing (the port's copy of
``repro.optim.diana_optimizer`` for a flat compression config, no prox).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.core.compression import CompressionConfig
from repro_torch.core.diana import DianaState, init_state

from .optimizers import Optimizer, constant_schedule, momentum

__all__ = ["DianaOptimizer", "DianaOptState", "DianaState"]


class DianaOptState(NamedTuple):
    step: int
    inner: Any
    diana: DianaState


class DianaOptimizer:
    """A compression config + inner optimizer + learning-rate schedule."""

    def __init__(self, compression: Optional[CompressionConfig] = None,
                 inner: Optional[Optimizer] = None, schedule: Optional[Callable] = None,
                 lr: float = 1e-3):
        self.compression = compression or CompressionConfig(bucketed=True)
        if not self.compression.bucketed:
            raise NotImplementedError(
                "the trainer runs the bucketed layout; the per-leaf rounds are "
                "repro_torch.core.diana.reference_step and aggregate_distributed, and "
                "the per-leaf trainer is ROADMAP.md queue 1 item 1b")
        self.inner = inner or momentum()
        self.schedule = schedule or constant_schedule(lr)

    def init(self, params: Mapping[str, torch.Tensor], n_workers: int) -> DianaOptState:
        """Zero state; ``h_worker`` holds ``n_workers`` rows (n in turn, or
        the rank's own row under ``torch.distributed``)."""
        return DianaOptState(step=0, inner=self.inner.init(params),
                             diana=init_state(params, self.compression, n_workers))

    @torch.no_grad()
    def apply_direction(self, params: Mapping[str, torch.Tensor],
                        ghat: Mapping[str, torch.Tensor], state: DianaOptState,
                        new_diana: DianaState) -> DianaOptState:
        """Steps 3-4: inner update on ``ghat``, then ``p <- (p.float() + u)``
        rounded to the parameter dtype (written into the parameters)."""
        lr = self.schedule(state.step)
        updates, inner = self.inner.update(ghat, state.inner, params, lr)
        for p, u in updates.items():
            params[p].copy_((params[p].float() + u).to(params[p].dtype))
        return DianaOptState(step=state.step + 1, inner=inner, diana=new_diana)
