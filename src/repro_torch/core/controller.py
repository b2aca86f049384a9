"""The bit-budget controller: spend a wire budget where the variance is.

The port's copy of ``repro.core.controller``.  An operator's injected
variance is priced by the paper (``1/alpha_p(d_l) - 1`` for the ternary
family, ``d/k - 1`` for the sparse ones, ``1/8`` for natural) and scales
with the group's gradient energy, which drifts.  :class:`BudgetController`
closes the loop:

    telemetry EMAs (repro_torch.core.telemetry)   measured, per group
        -> allocate (this module)                 argmin sum_g omega_g(c) * E_g
           s.t. policy_bits_per_dim <= budget     the wire accounting
        -> CompressionPolicy.with_rule_specs      same skeleton, new specs

* A finite per-rule lattice of :class:`~repro_torch.core.policy.ChannelSpec`
  candidates (:func:`default_lattice`), so a run meets few distinct steps.
* The skeleton stays: rule patterns, order and names (so group names, state
  keys and the GROUP_FOLD streams) never change.  A group whose memory shape
  changes (a bucketed group's padding follows its operator's alignment) is
  re-zeroed on both sides, which keeps ``h_server = mean_i h_i``
  (:func:`migrate_diana_state`).
* Dwell and hysteresis: at most one switch per ``interval`` steps, and only
  for a predicted improvement above ``hysteresis`` (relative).
* Dense warmup: the first ``warmup_dense_steps`` steps run the skeleton with
  every rule set to identity; every policy emitted after it is within the
  budget.

Host-side Python: decisions between steps, a small discrete search.  The
statistics are float64 Python numbers, as in the JAX package, so the
decisions equal its decisions on the same samples.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Mapping, Optional, Sequence, Tuple

import torch

from .compression import CompressionConfig
from .compressors.registry import canonical_name
from .diana import DianaState, init_state
from .policy import ChannelSpec, CompressionPolicy, grouped_bucket_layout, partition_for
from .quantization import alpha_p

__all__ = ["BudgetController", "ControllerState", "default_lattice", "spec_omega",
           "init_controller_state", "observe", "allocate", "maybe_reallocate",
           "migrate_diana_state", "controller_metadata", "state_from_metadata"]

# Beyond this many candidate combinations the greedy allocation runs.
_EXHAUSTIVE_LIMIT = 4096


def spec_omega(cfg: CompressionConfig, sizes: Sequence[int]) -> float:
    """The group's variance factor, ``E||C(x) - x||^2 <= omega ||x||^2``,
    size-weighted over its leaves (``repro/core/controller.py:88``): ternary
    ``1/alpha_p(p, min(block, d)) - 1``, randk and topk_ef ``d/k - 1``,
    natural ``1/8``, identity 0."""
    name = canonical_name(cfg.method)
    num = 0.0
    den = 0
    for s in sizes:
        s = int(s)
        if name == "identity":
            w = 0.0
        elif name in ("randk", "topk_ef"):
            k = min(cfg.k, s)
            w = max(s / k - 1.0, 0.0)
        elif name == "natural":
            w = 1.0 / 8.0
        else:  # the ternary family
            w = 1.0 / alpha_p(cfg.p, min(cfg.block_size, s)) - 1.0
        num += w * s
        den += s
    return num / max(den, 1)


def _dedup(specs) -> Tuple[ChannelSpec, ...]:
    out = []
    for s in specs:
        if s not in out:
            out.append(s)
    return tuple(out)


def default_lattice(policy: CompressionPolicy) -> Tuple[Tuple[ChannelSpec, ...], ...]:
    """Per rule: its own spec first, then k / 4 and 4k (sparse) or block / 4
    and 4 * block (ternary), then natural and identity, each in the rule's
    layout (``:133``)."""
    lattice = []
    for rule in policy.rules:
        spec = rule.spec
        lay = spec.layout
        name = canonical_name(spec.method)
        cands = [spec]
        if name in ("randk", "topk_ef"):
            k0 = spec.k if spec.k is not None else 64
            for k in (max(1, k0 // 4), k0 * 4):
                cands.append(_dc_replace(spec, k=k))
        elif name == "ternary":
            b0 = spec.block_size if spec.block_size is not None else 2048
            for b in (max(4, b0 // 4), b0 * 4):
                if b % 4 == 0:
                    cands.append(_dc_replace(spec, block_size=b))
        cands.append(ChannelSpec("natural", layout=lay))
        cands.append(ChannelSpec("identity", layout=lay))
        lattice.append(_dedup(cands))
    return tuple(lattice)


@dataclass(frozen=True)
class BudgetController:
    """The fixed knobs (``:173``); the evolving part is
    :class:`ControllerState`.

    base:     the author's policy, the skeleton of every emitted policy.
    budget_bits_per_dim: the wire budget in :func:`policy_bits_per_dim`'s
              units; every emitted policy after warmup is within it.
    lattice:  per-rule candidate tuples (None: :func:`default_lattice`).
    interval: at most one switch per this many steps.
    warmup_dense_steps: steps of all-identity aggregation first.
    hysteresis: the relative predicted improvement a switch needs.
    ema_decay: the telemetry EMA's decay."""

    base: CompressionPolicy
    budget_bits_per_dim: float
    lattice: Optional[Tuple[Tuple[ChannelSpec, ...], ...]] = None
    interval: int = 50
    warmup_dense_steps: int = 0
    hysteresis: float = 0.1
    ema_decay: float = 0.9

    def __post_init__(self):
        if self.budget_bits_per_dim <= 0:
            raise ValueError(f"budget_bits_per_dim must be > 0, got {self.budget_bits_per_dim}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if self.warmup_dense_steps < 0:
            raise ValueError("warmup_dense_steps must be >= 0")
        if not 0.0 <= self.hysteresis < 1.0:
            raise ValueError(f"hysteresis must be in [0, 1), got {self.hysteresis}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {self.ema_decay}")
        lat = default_lattice(self.base) if self.lattice is None else self.lattice
        lat = tuple(tuple(c) for c in lat)
        object.__setattr__(self, "lattice", lat)
        if len(lat) != len(self.base.rules):
            raise ValueError(f"lattice needs one candidate tuple per rule "
                             f"({len(self.base.rules)}), got {len(lat)}")
        for i, cands in enumerate(lat):
            if not cands:
                raise ValueError(f"rule {i} has an empty candidate tuple")

    def policy_for(self, choice: Sequence[int]) -> CompressionPolicy:
        """The lattice assignment ``choice`` (one index per rule) on the
        base skeleton."""
        return self.base.with_rule_specs([self.lattice[i][c] for i, c in enumerate(choice)])

    def warmup_policy(self) -> CompressionPolicy:
        """Every rule's spec set to identity (layout kept), same skeleton."""
        return self.base.with_rule_specs([ChannelSpec("identity", layout=r.spec.layout)
                                          for r in self.base.rules])


@dataclass
class ControllerState:
    """The dwell clock, the current lattice choice and the EMAs (one slot
    per partition group, float64), as JSON through
    :func:`controller_metadata` / :func:`state_from_metadata`."""

    step: int = 0
    last_switch: int = -(10 ** 9)
    choice: Optional[Tuple[int, ...]] = None
    ema_m2: Tuple[float, ...] = field(default_factory=tuple)
    ema_var: Tuple[float, ...] = field(default_factory=tuple)
    count: int = 0


def init_controller_state(controller: BudgetController, tree) -> ControllerState:
    n = partition_for(controller.base, tree).n_groups
    return ControllerState(ema_m2=(0.0,) * n, ema_var=(0.0,) * n)


def _host_floats(x) -> list:
    if isinstance(x, torch.Tensor):
        return [float(v) for v in x.detach().to("cpu", torch.float64).reshape(-1).tolist()]
    return [float(v) for v in (x if isinstance(x, (list, tuple)) else [x])]


def observe(controller: BudgetController, state: ControllerState, sample) -> ControllerState:
    """Fold one step's :class:`~repro_torch.core.telemetry.GroupTelemetry`
    (or any ``(m2, var, ok)`` triple) into the EMAs and advance the clock;
    a degraded sample (``ok`` False) only advances the clock."""
    ok = bool(sample.ok) if hasattr(sample, "ok") else True
    new_step = state.step + 1
    if not ok:
        return _dc_replace(state, step=new_step)
    m2, var = _host_floats(sample.m2), _host_floats(sample.var)
    if len(m2) != len(state.ema_m2):
        raise ValueError(f"telemetry has {len(m2)} groups, controller tracks "
                         f"{len(state.ema_m2)}: the policy skeleton must not change")
    d = controller.ema_decay
    return _dc_replace(state, step=new_step,
                       ema_m2=tuple(d * o + (1 - d) * n for o, n in zip(state.ema_m2, m2)),
                       ema_var=tuple(d * o + (1 - d) * n for o, n in zip(state.ema_var, var)),
                       count=state.count + 1)


def _debiased(values, decay: float, count: int):
    if count <= 0:
        return list(values)
    denom = 1.0 - decay ** count
    return [v / denom for v in values]


def _group_tables(controller: BudgetController, tree):
    """Per group: ``(rule_ids, dims, bits, omegas)``, ``bits[g][c]`` the
    group's wire bits per step under candidate ``c`` (summed as
    :func:`policy_bits_per_dim` sums them) and ``omegas[g][c]`` its
    variance factor."""
    part = partition_for(controller.base, tree)
    layout = grouped_bucket_layout(controller.base, tree)
    dims, bits, omegas = [], [], []
    for g, ri in enumerate(part.rule_ids):
        sizes = layout.layouts[g].sizes
        row_bits, row_omega = [], []
        for cand in controller.lattice[ri]:
            cfg = controller.base.with_rule_specs(
                [cand if j == ri else None for j in range(len(controller.base.rules))]
            ).rule_config(ri)
            comp = cfg.make()
            row_bits.append(sum(comp.bits_per_dim(int(s)) * int(s) for s in sizes))
            row_omega.append(spec_omega(cfg, sizes))
        dims.append(sum(int(s) for s in sizes))
        bits.append(row_bits)
        omegas.append(row_omega)
    return part.rule_ids, dims, bits, omegas


def allocate(controller: BudgetController, state: ControllerState, tree) -> Tuple[int, ...]:
    """Per-rule candidate indices minimising ``sum_g omega_g(c) * m2_g *
    d_g`` with ``sum_g bits_g(c) <= budget * sum_g d_g`` (``:306``):
    exhaustive up to 4096 combinations, greedy above; rules that match no
    leaf keep candidate 0.  Raises if the cheapest assignment is over."""
    rule_ids, dims, bits, omegas = _group_tables(controller, tree)
    energy = _debiased(state.ema_m2, controller.ema_decay, state.count)
    if len(energy) != len(dims):
        raise ValueError("controller state group count does not match tree")
    obj = [[om * e * d for om in row] for row, e, d in zip(omegas, energy, dims)]
    budget_total = controller.budget_bits_per_dim * sum(dims)
    floor_bits = sum(min(row) for row in bits)
    if floor_bits > budget_total + 1e-9:
        raise ValueError(f"budget {controller.budget_bits_per_dim} bits/dim is infeasible: "
                         f"the cheapest lattice assignment needs "
                         f"{floor_bits / max(sum(dims), 1):.3f} bits/dim")
    if math.prod(len(row) for row in bits) <= _EXHAUSTIVE_LIMIT:
        group_choice = _allocate_exhaustive(obj, bits, omegas, budget_total)
    else:
        group_choice = _allocate_greedy(obj, bits, omegas, budget_total)
    choice = [0] * len(controller.base.rules)
    for g, ri in enumerate(rule_ids):
        choice[ri] = group_choice[g]
    return tuple(choice)


def _allocate_exhaustive(obj, bits, omegas, budget_total):
    best = None
    for combo in itertools.product(*[range(len(row)) for row in bits]):
        b = sum(row[c] for row, c in zip(bits, combo))
        if b > budget_total + 1e-9:
            continue
        o = sum(row[c] for row, c in zip(obj, combo))
        w = sum(row[c] for row, c in zip(omegas, combo))
        # ties: the objective, then the total omega (all-zero telemetry at
        # the first decision), then fewer bits, then the first combination
        key = (o, w, b, combo)
        if best is None or key < best[0]:
            best = (key, combo)
    return list(best[1])


def _allocate_greedy(obj, bits, omegas, budget_total):
    # from each group's cheapest candidate, take the best objective gain per
    # extra bit that still fits, until none does
    choice = [min(range(len(row)), key=lambda c: (row[c], obj[g][c], c))
              for g, row in enumerate(bits)]
    spent = sum(row[c] for row, c in zip(bits, choice))
    while True:
        best = None
        for g, row in enumerate(bits):
            cur = choice[g]
            for c in range(len(row)):
                extra = row[c] - row[cur]
                gain = (obj[g][cur] - obj[g][c], omegas[g][cur] - omegas[g][c])
                if gain <= (0.0, 0.0):
                    continue
                if spent + extra > budget_total + 1e-9:
                    continue
                ratio = (gain[0] + 1e-12 * gain[1]) / max(extra, 1e-9)
                key = (ratio, -g, -c)
                if best is None or key > best[0]:
                    best = (key, g, c, extra)
        if best is None:
            return choice
        _, g, c, extra = best
        choice[g] = c
        spent += extra


def maybe_reallocate(controller: BudgetController, state: ControllerState, tree):
    """The decision after :func:`observe` (``:421``): ``(state, policy)``
    with a policy only on the step the emitted policy changes (the first
    allocation after warmup, or an improvement past the dwell and the
    hysteresis), else ``(state, None)``."""
    if state.step < controller.warmup_dense_steps:
        return state, None
    if state.choice is not None and state.step - state.last_switch < controller.interval:
        return state, None
    new_choice = allocate(controller, state, tree)
    if state.choice is None:
        state = _dc_replace(state, choice=new_choice, last_switch=state.step)
        return state, controller.policy_for(new_choice)
    if new_choice == tuple(state.choice):
        return state, None
    _, dims, bits, omegas = _group_tables(controller, tree)
    energy = _debiased(state.ema_m2, controller.ema_decay, state.count)
    rule_ids = partition_for(controller.base, tree).rule_ids

    def objective(choice):
        return sum(omegas[g][choice[ri]] * e * d
                   for g, (ri, e, d) in enumerate(zip(rule_ids, energy, dims)))

    if objective(new_choice) > (1.0 - controller.hysteresis) * objective(state.choice):
        return state, None
    state = _dc_replace(state, choice=new_choice, last_switch=state.step)
    return state, controller.policy_for(new_choice)


# ---------------------------------------------------------------------------
# State migration across a policy switch
# ---------------------------------------------------------------------------

def _release(old) -> None:
    """Free the device memory of every tensor in ``old`` (a tensor or a
    tree of them): its storage is resized to nothing."""
    if isinstance(old, torch.Tensor):
        old.untyped_storage().resize_(0)
    elif isinstance(old, Mapping):
        for v in old.values():
            _release(v)
    elif isinstance(old, (list, tuple)):
        for v in old:
            _release(v)


def _migrate(tmpl, old, device, path: str, carried: list, fresh: list):
    if tmpl is None:
        if old is not None:
            _release(old)
        return None
    if isinstance(tmpl, torch.Tensor):
        if (isinstance(old, torch.Tensor) and tuple(old.shape) == tuple(tmpl.shape)
                and old.dtype == tmpl.dtype):
            carried.append(path)
            return old
        if old is not None:
            _release(old)   # before the zeros are allocated
        fresh.append(path)
        return torch.zeros(tmpl.shape, dtype=tmpl.dtype, device=device)
    if isinstance(tmpl, Mapping):
        olds = old if isinstance(old, Mapping) else {}
        if old is not None and not isinstance(old, Mapping):
            _release(old)
        return {k: _migrate(v, olds.get(k), device, f"{path}/{k}", carried, fresh)
                for k, v in tmpl.items()}
    fields = getattr(tmpl, "_fields", None)
    if fields is not None:   # a NamedTuple (DianaState, VRState)
        return type(tmpl)(*(_migrate(getattr(tmpl, f), getattr(old, f, None), device,
                                     f"{path}/{f}".lstrip("/"), carried, fresh)
                            for f in fields))
    olds = list(old) if isinstance(old, (list, tuple)) else []
    if old is not None and not isinstance(old, (list, tuple)):
        _release(old)
    for extra in olds[len(tmpl):]:
        _release(extra)
    return [_migrate(v, olds[i] if i < len(olds) else None, device, f"{path}/{i}", carried,
                     fresh) for i, v in enumerate(tmpl)]


def migrate_diana_state(old: DianaState, params: Mapping[str, torch.Tensor],
                        new_policy: CompressionPolicy, n_workers: int,
                        carried: Optional[list] = None,
                        fresh: Optional[list] = None) -> DianaState:
    """DIANA memories across a skeleton-preserving switch (``:474``): every
    memory whose key path (``h_worker/<group>[/<leaf index>]``, ...), shape
    and dtype survive is carried; the others restart from zeros, on both
    sides, so ``h_server = mean_i h_i`` holds at the seam.

    ``old`` is consumed: a memory that does not carry is released (its
    storage freed) BEFORE its zeros are allocated, so a full-width group's
    switch never holds both.  The new state's shapes come from
    :func:`~repro_torch.core.diana.init_state` on meta tensors.  ``carried``
    and ``fresh`` (lists), when given, receive the key paths carried and
    restarted from zeros."""
    meta = {p: torch.empty(t.shape, dtype=t.dtype, device="meta") for p, t in params.items()}
    template = init_state(meta, new_policy, n_workers)
    device = next(iter(params.values())).device
    kept, zeroed = [], []
    state = _migrate(template, old, device, "", kept, zeroed)
    if carried is not None:
        carried.extend(kept)
    if fresh is not None:
        fresh.extend(zeroed)
    return state


# ---------------------------------------------------------------------------
# Checkpoint metadata (JSON)
# ---------------------------------------------------------------------------

def controller_metadata(controller: BudgetController, state: ControllerState) -> dict:
    """The JSON document a checkpoint carries under
    ``metadata["controller"]`` (``:521``): the evolving state and the
    schedule knobs a resume validates."""
    return {
        "step": state.step,
        "last_switch": state.last_switch,
        "choice": None if state.choice is None else list(state.choice),
        "ema_m2": list(state.ema_m2),
        "ema_var": list(state.ema_var),
        "count": state.count,
        "budget_bits_per_dim": controller.budget_bits_per_dim,
        "interval": controller.interval,
        "warmup_dense_steps": controller.warmup_dense_steps,
        "ema_decay": controller.ema_decay,
    }


def state_from_metadata(doc: dict) -> ControllerState:
    return ControllerState(
        step=int(doc["step"]), last_switch=int(doc["last_switch"]),
        choice=None if doc.get("choice") is None else tuple(int(c) for c in doc["choice"]),
        ema_m2=tuple(float(v) for v in doc.get("ema_m2", ())),
        ema_var=tuple(float(v) for v in doc.get("ema_var", ())),
        count=int(doc.get("count", 0)))
