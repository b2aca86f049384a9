"""Elastic participation: client sampling, stragglers, churn, fault injection.

The port's copy of ``repro.core.participation``.  DIANA's Algorithm 1
assumes all ``n`` workers report every step; this module generalises the
round to a sampled participant set ``S_t`` and keeps two promises:

* **an unbiased direction** — the server direction takes the RESCALED sum,
  ``(1/|S_t|) * sum_{i in S_t} dhat_i`` (or the a-priori ``1/(n q)`` rule,
  :attr:`ParticipationSpec.rescale`);
* **memory correctness** — ``h_server`` advances with the UNRESCALED
  ``sum_{S_t} dhat_i / n`` and only participants' ``h_i`` rows advance, so
  ``h = mean_i h_i`` survives.

The PRNG contract (the :data:`PART_FOLD` stream): ``part_key =
fold_in(step_key, PART_FOLD)`` is derived from the step key before any
worker fold, and worker ``i``'s draws come from ``split(fold_in(part_key,
i), 3)`` (sampling coin, straggler coin, deadline latency).  Every path
draws the whole ``(n,)`` mask from it once per step, before any policy-group
fold, so the mask is the same on every rank and never meets a compression,
VR or downlink draw.

Churn is a static schedule (:class:`ChurnEvent`): a worker that ``leave``s
at step ``s`` is absent from every mask at ``t >= s``; a ``join`` at ``s``
brings it back with its ``h_worker`` row reset to zero at ``t == s``.

Where the JAX package traces every draw against a scalar ``step`` so that
one compiled program serves every mask, the port decides on the host: the
mask is a CPU ``(n,)`` bool tensor computed once per step, ``ok`` a Python
bool, and the rounds branch on them.

The fault harness (:class:`FaultPlan`) perturbs the bucketed layout's fused
uint8 wire per (step, worker): ``corrupt`` XORs a payload byte,
``drop``/``delay`` break the appended checksum
(:func:`repro_torch.core.bucket.add_checksum`), and the receivers exclude
the payload instead of letting its bytes reach ``h_server``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import torch

from . import prng

__all__ = [
    "PART_FOLD",
    "ChurnEvent",
    "ParticipationSpec",
    "PartCtx",
    "presence",
    "participation_mask",
    "latency",
    "reinit_rows",
    "direction_scale",
    "expected_rate",
    "step_ctx",
    "FaultEvent",
    "FaultPlan",
    "parse_faults",
    "apply_faults",
    "fault_flips",
]

# Folded into the step key before any worker fold (``repro/core/
# participation.py:71``): disjoint from the worker folds, VR_FOLD, DOWN_FOLD
# and GROUP_FOLD, so the mask stream is the same on every worker.
PART_FOLD = 0x5041  # 'PA'


@dataclass(frozen=True)
class ChurnEvent:
    """One scheduled membership change: ``worker`` leaves or (re-)joins at
    ``step``; a ``join`` resets the worker's ``h_worker`` row to zero at
    exactly that step."""

    step: int
    worker: int
    kind: str  # "leave" | "join"

    def __post_init__(self):
        if self.kind not in ("leave", "join"):
            raise ValueError(f"ChurnEvent kind must be leave|join, got {self.kind!r}")
        if self.step < 0 or self.worker < 0:
            raise ValueError("ChurnEvent step and worker must be >= 0")


@dataclass(frozen=True)
class ParticipationSpec:
    """Who participates each step (hashable: it lives on the configs).

    q:           client-sampling probability, one Bernoulli(q) coin per
                 present worker per step.
    dropout:     straggler probability: a sampled worker still misses the
                 step with this probability (its own coin).
    deadline:    each worker draws a latency ~ Exp(1) and misses the step
                 when ``latency > deadline``; None: no timeout draw.
    churn:       the :class:`ChurnEvent` schedule (sorted by step, worker).
    min_workers: below this many participants the step degrades: ``ghat =
                 0`` and every memory frozen.
    rescale:     "sampled" divides the participant sum by ``|S_t|``;
                 "expected" by ``n * E[participation rate]``.

    A trivial spec (:attr:`is_trivial`) keeps the exact pre-elastic path.
    """

    q: float = 1.0
    dropout: float = 0.0
    deadline: Optional[float] = None
    churn: Tuple[ChurnEvent, ...] = ()
    min_workers: int = 1
    rescale: str = "sampled"

    def __post_init__(self):
        if not (0.0 < self.q <= 1.0):
            raise ValueError(f"participation q must be in (0, 1], got {self.q}")
        if not (0.0 <= self.dropout < 1.0):
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        if self.deadline is not None and self.deadline <= 0.0:
            raise ValueError(f"deadline must be positive, got {self.deadline}")
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.rescale not in ("sampled", "expected"):
            raise ValueError(f"rescale must be sampled|expected, got {self.rescale}")
        object.__setattr__(self, "churn",
                           tuple(sorted(self.churn, key=lambda e: (e.step, e.worker))))

    @property
    def is_trivial(self) -> bool:
        """Every scheduled mask is all workers: the round takes the exact
        pre-elastic path (``min_workers`` is then vacuous)."""
        return (self.q >= 1.0 and self.dropout == 0.0
                and self.deadline is None and not self.churn)

    def to_json_dict(self) -> dict:
        return {
            "q": self.q, "dropout": self.dropout, "deadline": self.deadline,
            "min_workers": self.min_workers, "rescale": self.rescale,
            "churn": [[e.step, e.worker, e.kind] for e in self.churn],
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "ParticipationSpec":
        d = dict(d)
        d["churn"] = tuple(ChurnEvent(int(s), int(w), k) for s, w, k in d.get("churn", ()))
        return cls(**d)


def presence(spec: ParticipationSpec, step: int, n: int) -> torch.Tensor:
    """(n,) bool: cohort membership at ``step`` under the churn schedule
    (all present before any event, events applied in step order)."""
    pres = torch.ones(n, dtype=torch.bool)
    for ev in spec.churn:
        if ev.worker < n and step >= ev.step:
            pres[ev.worker] = ev.kind == "join"
    return pres


def reinit_rows(spec: ParticipationSpec, step: int, n: int) -> torch.Tensor:
    """(n,) bool: workers whose ``join`` fires at exactly ``step``; their
    ``h_worker`` rows reset to zero this step, before the round, degraded
    or not."""
    r = torch.zeros(n, dtype=torch.bool)
    for ev in spec.churn:
        if ev.kind == "join" and ev.worker < n and step == ev.step:
            r[ev.worker] = True
    return r


def latency(part_key: torch.Tensor, i: int) -> torch.Tensor:
    """Worker ``i``'s Exp(1) deadline draw (f32, 0-d) from the PART_FOLD
    stream: the third of ``split(fold_in(part_key, i), 3)``."""
    return prng.exponential(prng.split(prng.fold_in(part_key, i), 3)[2])


def participation_mask(spec: ParticipationSpec, part_key: torch.Tensor, n: int,
                       step: int = 0) -> torch.Tensor:
    """The (n,) bool participant mask ``S_t`` (``repro/core/participation.py
    :188``).  ``part_key`` is ``fold_in(step_key, PART_FOLD)``; the coins are
    drawn whichever knobs are set, so one knob never moves another's
    stream."""
    bits = []
    for i in range(n):
        k_q, k_drop, k_lat = prng.split(prng.fold_in(part_key, i), 3)
        b = bool(prng.bernoulli(k_q, spec.q)) and not bool(prng.bernoulli(k_drop, spec.dropout))
        if spec.deadline is not None:
            b = b and bool(prng.exponential(k_lat) <= torch.tensor(spec.deadline,
                                                                  dtype=torch.float32))
        bits.append(b)
    return torch.tensor(bits, dtype=torch.bool) & presence(spec, step, n)


def expected_rate(spec: ParticipationSpec) -> float:
    """A-priori participation probability per worker (churn ignored):
    ``q * (1 - dropout) * P[Exp(1) <= deadline]``."""
    rate = spec.q * (1.0 - spec.dropout)
    if spec.deadline is not None:
        rate *= 1.0 - math.exp(-spec.deadline)
    return rate


def direction_scale(spec: ParticipationSpec, mask: torch.Tensor, ok: bool) -> torch.Tensor:
    """The f32 scalar the participant SUM is multiplied by for the server
    direction (``:217``): ``1 / max(|S_t|, 1)`` in f32 (sampled) or the
    Python float ``1 / (n E[rate])`` rounded to f32 (expected); exactly 0 on
    a degraded step."""
    if not ok:
        return torch.tensor(0.0, dtype=torch.float32)
    if spec.rescale == "expected":
        return torch.tensor(1.0 / (mask.shape[0] * expected_rate(spec)), dtype=torch.float32)
    count = max(int(mask.sum()), 1)
    return torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(count),
                                                                 dtype=torch.float32)


class PartCtx(NamedTuple):
    """One step's participation, resolved once per step before any group
    fold and shared by every group.  ``mask`` and ``reinit`` are CPU (n,)
    bools; ``m_own`` / ``reinit_own`` / ``widx`` are the calling rank's own
    bits on the distributed path (None in the reference)."""

    spec: Any
    mask: torch.Tensor      # (n,) bool: scheduled participants S_t
    reinit: torch.Tensor    # (n,) bool: h rows reset this step
    ok: bool                # |S_t| >= min_workers
    dir_scale: torch.Tensor  # () f32: multiplies the participant sum (0 if degraded)
    m_own: Any = None
    reinit_own: Any = None
    widx: Any = None


def step_ctx(spec: ParticipationSpec, part_key: torch.Tensor, n: int, step: int = 0,
             worker_index: Optional[int] = None) -> PartCtx:
    """One step's mask, resets, degraded gate and scale from the PART_FOLD
    stream (``:250``); ``worker_index`` fills the ``*_own`` bits."""
    mask = participation_mask(spec, part_key, n, step)
    reinit = reinit_rows(spec, step, n)
    ok = int(mask.sum()) >= spec.min_workers
    m_own = reinit_own = widx = None
    if worker_index is not None:
        widx = int(worker_index)
        m_own, reinit_own = bool(mask[widx]), bool(reinit[widx])
    return PartCtx(spec=spec, mask=mask, reinit=reinit, ok=ok,
                   dir_scale=direction_scale(spec, mask, ok), m_own=m_own,
                   reinit_own=reinit_own, widx=widx)


# ---------------------------------------------------------------------------
# Fault injection on the fused uint8 wire, per (step, worker)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultEvent:
    """One scheduled wire fault for ``worker`` at ``step``.

    kind="corrupt": XOR ``bits`` into payload byte ``byte``: the checksum
    fails and the payload is excluded.  kind="drop": break the checksum
    (the payload never arrives); kind="delay": a drop lasting ``delay``
    consecutive steps.
    """

    step: int
    worker: int
    kind: str = "corrupt"  # "corrupt" | "drop" | "delay"
    byte: int = 0
    bits: int = 0xFF
    delay: int = 1

    def __post_init__(self):
        if self.kind not in ("corrupt", "drop", "delay"):
            raise ValueError(f"FaultEvent kind must be corrupt|drop|delay, got {self.kind!r}")
        if self.kind == "corrupt" and not (1 <= self.bits <= 0xFF):
            raise ValueError("corrupt bits must be a non-zero byte")
        if self.kind == "delay" and self.delay < 1:
            raise ValueError("delay must be >= 1 steps")


@dataclass(frozen=True)
class FaultPlan:
    """A static fault schedule.  Any plan, even an empty one, turns the wire
    checksum on: the bucketed round fuses each payload into one uint8
    buffer, appends the 8-byte checksum and excludes payloads whose checksum
    fails on the receivers."""

    events: Tuple[FaultEvent, ...] = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))


def parse_faults(text: Optional[str]) -> Optional[FaultPlan]:
    """The CLI's fault syntax -> :class:`FaultPlan` (None passes through):
    events separated by ';', each ``kind:key=value,...``, e.g.
    ``corrupt:step=3,worker=1,byte=7;drop:step=5,worker=2`` or
    ``delay:step=6,worker=0,delay=2``; the bare word ``checksum`` is an
    empty plan (checksums on, no faults)."""
    if text is None or not text.strip():
        return None
    if text.strip() == "checksum":
        return FaultPlan()
    events = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kw = {}
        for item in rest.split(","):
            item = item.strip()
            if not item:
                continue
            k, _, v = item.partition("=")
            kw[k.strip()] = int(v, 0)
        events.append(FaultEvent(kind=kind.strip(), **kw))
    return FaultPlan(events=tuple(events))


def fault_flips(plan: FaultPlan, step: int, widx: int, total: int, byte_offset: int = 0,
                body_total: Optional[int] = None):
    """The ``(position, xor byte)`` pairs that :func:`apply_faults` applies
    to worker ``widx``'s wire of ``total`` bytes at ``step``, in event order
    (a position may repeat: the XORs compose)."""
    from .bucket import CHECKSUM_BYTES

    own_body = total - CHECKSUM_BYTES
    body = own_body if body_total is None else body_total
    flips = []
    for ev in plan.events:
        if widx != ev.worker:
            continue
        if ev.kind == "delay":
            hit = ev.step <= step < ev.step + ev.delay
        else:
            hit = step == ev.step
        if not hit:
            continue
        if ev.kind == "corrupt":
            local = ev.byte % body - byte_offset
            if 0 <= local < own_body:
                flips.append((local, ev.bits))
        else:  # drop / delay: break the checksum tail
            flips.append((total - 1, 0xFF))
    return flips


def apply_faults(wire: torch.Tensor, plan: FaultPlan, step: int, widx: int,
                 byte_offset: int = 0, body_total: Optional[int] = None) -> torch.Tensor:
    """Inject ``plan``'s faults for ``(step, widx)`` into this worker's 1-D
    wire (payload bytes, then the checksum tail), in place; returns it
    (``repro/core/participation.py:344``).

    A ``corrupt`` event XORs ``bits`` into byte ``byte % body`` of the body,
    ``body`` being this wire's own body or, for a chunked wire, the round's
    ``body_total`` with this chunk at ``byte_offset`` (the chunked schedule
    is a later slice; the defaults are the single wire).  ``drop`` and
    ``delay`` XOR 0xFF into the tail's last byte."""
    for pos, b in fault_flips(plan, step, widx, wire.shape[-1], byte_offset, body_total):
        wire[pos] ^= b
    return wire
