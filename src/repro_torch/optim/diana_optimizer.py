"""DianaOptimizer — the paper's iterate as one update rule.

Per step (Algorithm 1):
    1. per-worker grads g_i              (the trainer)
    2. ghat and the h memories           (the DIANA round: the in-turn round
                                          or ``core.diana.aggregate_distributed``)
    3. v = inner optimizer on ghat       (momentum beta -> paper's v^k)
    4. x = prox_{gamma R}(x + update)    (``core.prox``, gamma = the step's lr)

This module owns steps 3-4 and the state plumbing (the port's copy of
``repro.optim.diana_optimizer``).  Compression is ONE object: a
:class:`~repro_torch.core.policy.CompressionPolicy` (``policy=``), or a flat
:class:`~repro_torch.core.compression.CompressionConfig` (``compression=``),
which lifts to a uniform one-rule policy and runs the flat code path.  The
JAX optimizer's deprecated ``vr=`` / ``vr_p=`` / ``down_method=`` /
``down_k=`` keywords are not ported: ``policy.replace(vr=..., vr_p=...)``
and ``policy.with_down(...)`` say the same.  ``participation=`` (a
:class:`~repro_torch.core.participation.ParticipationSpec`) rides the policy
whole (``policy.replace(participation=...)``): the training step then feeds
the round its ``part_key`` and step counter.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.core.compression import CompressionConfig
from repro_torch.core.diana import DianaState, init_state
from repro_torch.core.policy import CompressionPolicy, as_policy
from repro_torch.core.prox import Regularizer, none as no_reg
from repro_torch.core.vr import refresh

from .optimizers import Optimizer, constant_schedule, momentum

__all__ = ["DianaOptimizer", "DianaOptState", "DianaState"]


class DianaOptState(NamedTuple):
    step: int
    inner: Any
    diana: DianaState


class DianaOptimizer:
    """A compression policy + inner optimizer + learning-rate schedule +
    regularizer.  ``compression`` (a flat config) and ``policy`` are
    exclusive; with neither, the flat default config."""

    def __init__(self, compression: Optional[CompressionConfig] = None,
                 inner: Optional[Optimizer] = None, schedule: Optional[Callable] = None,
                 regularizer: Optional[Regularizer] = None, lr: float = 1e-3,
                 policy: Optional[CompressionPolicy] = None, participation=None):
        if policy is not None and compression is not None:
            raise ValueError("pass either compression= (flat config) or policy= "
                             "(CompressionPolicy), not both")
        self.policy = as_policy(policy if policy is not None
                                else compression if compression is not None
                                else CompressionConfig())
        if participation is not None:
            # model-wide, like VR: one spec on the policy for every group
            self.policy = self.policy.replace(participation=participation)
        self.inner = inner or momentum()
        self.schedule = schedule or constant_schedule(lr)
        self.regularizer = regularizer or no_reg()

    @property
    def compression(self) -> CompressionConfig:
        """The flat view: exact for a uniform policy, the catch-all rule's
        with the model-wide fields for a grouped one."""
        return self.policy.representative_config()

    def init(self, params: Mapping[str, torch.Tensor], n_workers: int) -> DianaOptState:
        """Zero state in the policy's layout; ``h_worker`` holds
        ``n_workers`` rows (n in turn, or the rank's own row under
        ``torch.distributed``)."""
        return DianaOptState(step=0, inner=self.inner.init(params),
                             diana=init_state(params, self.policy, n_workers))

    def refresh_snapshot(self, state: DianaOptState, params: Mapping[str, torch.Tensor],
                         mu: Mapping[str, torch.Tensor]) -> DianaOptState:
        """Refresh EVERY worker's L-SVRG snapshot to ``params`` with control
        variate ``mu`` (leaves ``(n_workers, *shape)``): the epoch-mode
        refresh, or a warm start of ``mu`` right after :meth:`init`
        (``repro/optim/diana_optimizer.py:161``)."""
        vr = state.diana.vr
        if vr is None:
            raise ValueError("refresh_snapshot needs a VR-DIANA policy (vr=True)")
        n = next(iter(vr.mu.values())).shape[0]
        return state._replace(diana=state.diana._replace(
            vr=refresh(vr, [True] * n, params, mu)))

    @torch.no_grad()
    def apply_direction(self, params: Mapping[str, torch.Tensor],
                        ghat: Mapping[str, torch.Tensor], state: DianaOptState,
                        new_diana: DianaState) -> DianaOptState:
        """Steps 3-4: inner update on ``ghat``, then ``p <- prox_{lr R}(
        (p.float() + u))`` rounded to the parameter dtype, written into the
        parameters.  The schedule gives lr as a float or a 0-dim f32 tensor;
        the prox reads it as an f32 scalar, the JAX schedule's value, so
        ``lr * lam`` rounds in f32 as there."""
        lr = self.schedule(state.step)
        updates, inner = self.inner.update(ghat, state.inner, params, lr)
        gamma = (lr.float() if isinstance(lr, torch.Tensor)
                 else torch.tensor(lr, dtype=torch.float32))
        for p, u in updates.items():
            x = (params[p].float() + u).to(params[p].dtype)
            params[p].copy_(self.regularizer.prox(x, gamma))
        return DianaOptState(step=state.step + 1, inner=inner, diana=new_diana)
