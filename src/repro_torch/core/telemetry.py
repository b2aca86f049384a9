"""Per-group gradient telemetry: what the budget controller measures.

The port's copy of ``repro.core.telemetry``.  The variance an operator
injects into a policy group scales with the group's gradient energy, which
drifts over training; :mod:`repro_torch.core.controller` spends this
measurement.

* **Fixed shape.**  A policy's groups are a function of (rules, tree), so one
  model under one policy always gives ``(n_groups,)`` f32 tensors.
* **No collective.**  The statistics come from the aggregated direction
  ``ghat``, which every rank already holds.
* **Participation-aware.**  A degraded elastic step serves ``ghat = 0``; its
  sample carries ``ok=False`` and the EMAs freeze, as every DIANA memory.
* **A pure observer.**  ``telemetry=True`` on ``reference_step`` /
  ``aggregate_distributed`` returns the same ``ghat`` and state bits.

Per group: ``m2 = ||ghat_g||^2 / d_g`` (the per-coordinate second moment)
and ``var = m2 - mean^2`` (clamped at 0).  :func:`measure` sums each leaf with
torch reductions (``sum`` and a ``dot`` of the flat leaf with itself, on the
card when ``ghat`` is there), in another order than XLA's: it agrees with the
JAX package to f32 rounding, not bit for bit (``tests/test_torch_controller.py``
states the tolerance).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from . import tree as T
from .policy import CompressionPolicy, partition_for

__all__ = ["GroupTelemetry", "TelemetryEMA", "telemetry_group_names", "group_dims", "measure",
           "group_moments", "from_moments", "init_ema", "ema_update", "ema_read"]


class GroupTelemetry(NamedTuple):
    """One step's per-group sample: ``m2`` and ``var`` ``(n_groups,)`` f32
    tensors on ``ghat``'s device, and ``ok`` (a bool: False on a degraded
    elastic step, whose sample must not be folded in)."""

    m2: torch.Tensor
    var: torch.Tensor
    ok: bool


class TelemetryEMA(NamedTuple):
    """Exponential moving averages of the samples; ``count`` is the number
    of samples folded in (for :func:`ema_read`'s bias correction)."""

    m2: torch.Tensor
    var: torch.Tensor
    count: int


def _as_policy(spec) -> Optional[CompressionPolicy]:
    return spec if isinstance(spec, CompressionPolicy) else None


def telemetry_group_names(spec, tree: Mapping[str, torch.Tensor]) -> tuple:
    """The labels of the telemetry rows: a policy's group names, or
    ``("all",)`` for a flat config (or None)."""
    policy = _as_policy(spec)
    if policy is None:
        return ("all",)
    return partition_for(policy, tree).group_names


def group_dims(spec, tree: Mapping[str, torch.Tensor]) -> tuple:
    """Per-group coordinate counts ``d_g``, in the telemetry's order."""
    policy = _as_policy(spec)
    leaves = [tree[p] for p in T.paths(tree)]
    if policy is None:
        return (sum(l.numel() for l in leaves),)
    return tuple(sum(leaves[i].numel() for i in ids)
                 for ids in partition_for(policy, tree).group_leaf_ids)


def group_moments(leaves) -> tuple:
    """``(m2, var)`` of ONE group's leaves (0-d f32 tensors), summed leaf by
    leaf in the given order: the per-group term of :func:`measure`."""
    flats = [l.reshape(-1).float() for l in leaves]
    d = sum(f.numel() for f in flats)
    s1 = sum(f.sum() for f in flats)
    s2 = sum(torch.dot(f, f) for f in flats)
    m2 = s2 / d
    mean = s1 / d
    # a near-constant group can cancel below zero; the variance is >= 0
    return m2, torch.clamp(m2 - mean * mean, min=0.0)


def from_moments(moments, ok=None) -> GroupTelemetry:
    """A :class:`GroupTelemetry` from per-group ``(m2, var)`` pairs."""
    return GroupTelemetry(m2=torch.stack([m for m, _ in moments]).float(),
                          var=torch.stack([v for _, v in moments]).float(),
                          ok=True if ok is None else bool(ok))


def measure(spec, ghat: Mapping[str, torch.Tensor], ok=None) -> GroupTelemetry:
    """Per-group statistics of ``ghat`` (``repro/core/telemetry.py:116``): a
    pure function of replicated values.  ``ok=None`` is a healthy step; an
    elastic round passes ``part.ok``."""
    policy = _as_policy(spec)
    leaves = [ghat[p] for p in T.paths(ghat)]
    if policy is None:
        groups = [leaves]
    else:
        groups = [[leaves[i] for i in ids] for ids in partition_for(policy, ghat).group_leaf_ids]
    return from_moments([group_moments(grp) for grp in groups], ok)


def init_ema(n_groups: int, device=None) -> TelemetryEMA:
    return TelemetryEMA(m2=torch.zeros(n_groups, dtype=torch.float32, device=device),
                        var=torch.zeros(n_groups, dtype=torch.float32, device=device), count=0)


def ema_update(ema: TelemetryEMA, sample: GroupTelemetry, decay: float = 0.9) -> TelemetryEMA:
    """Fold one sample in, ``decay * old + (1 - decay) * new`` in f32 (two
    roundings and an add, as the JAX package computes it eagerly); frozen
    when ``sample.ok`` is False."""
    if not sample.ok:
        return ema

    def fold(old, new):
        return decay * old + (1.0 - decay) * new.float()

    return TelemetryEMA(m2=fold(ema.m2, sample.m2), var=fold(ema.var, sample.var),
                        count=ema.count + 1)


def ema_read(ema: TelemetryEMA, decay: float = 0.9):
    """Bias-corrected ``(m2, var)``: divided by ``1 - decay**count`` (zeros
    until the first sample).  ``decay**count`` of the f32 decay is taken in
    float64 and rounded once to f32: at decay 0.9 that is XLA's f32 ``pow``
    for every count the tests try (0-399)."""
    denom = 1.0
    if ema.count > 0:
        power = np.float32(np.float64(np.float32(decay)) ** ema.count)
        denom = np.float32(np.float32(1.0) - power)
    denom = torch.tensor(denom, dtype=torch.float32, device=ema.m2.device)
    return ema.m2 / denom, ema.var / denom
