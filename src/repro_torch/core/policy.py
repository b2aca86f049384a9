"""Compression policies: per-parameter-group operator rules (the port's copy
of ``repro.core.policy``).

* :class:`ChannelSpec` — ONE direction's operator for one group of leaves:
  ``method`` plus its knobs (``k``, ``block_size``, ``p``, ``alpha``) and the
  execution ``layout`` (``"bucketed"``: the group aggregates as one flat
  buffer; ``"perleaf"``; or ``None``: the policy's default).  Unset knobs
  inherit the flat config's defaults, and a downlink spec's inherit the
  uplink spec's first.
* :class:`CompressionPolicy` — an ORDERED tuple of :class:`Rule` s mapping
  path patterns (``re.search`` over ``/``-joined leaf paths) to specs, first
  match wins, plus the model-wide knobs: ``bucketed`` (the default layout),
  ``h_dtype``, VR (``vr`` / ``vr_p``, applied to the parameter-shaped
  gradients before any grouping) and ``participation`` (a worker is in or
  out of the whole step, so one mask serves every group).

A uniform policy (one catch-all rule) is the flat
:class:`~repro_torch.core.compression.CompressionConfig`:
``uniform(cfg).flat_config() == cfg``, and every entry point of
:mod:`repro_torch.core.diana` runs it through the flat code path, draw for
draw.  A grouped policy runs one sub-round per group, group ``g`` drawing
from ``fold_in(worker_key, GROUP_FOLD + g)`` (DESIGN.md §Policy).

Group ``g`` holds the leaves of rule ``rule_ids[g]`` in the tree's leaf
order (:func:`repro_torch.core.tree.paths`, the ``jax.tree_util`` order),
and is named ``g<rule:02d>_<label>``, so names, group order and leaf order
are the JAX package's on the same tree.

The JAX policy's ``worker_axes`` and ``use_kernel`` have no counterpart here
(one worker axis; the kernels run wherever the tensors are on the card).
Its ``chunk_bytes``, ``topology`` and ``node_size`` are model-wide, like
``vr``: the rule configs of bucketed groups carry them, and a per-leaf group
keeps the flat topology.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from . import tree as T
from .bucket import BucketLayout, GroupedBucketLayout, checksum_tail_bits_per_dim
from .compression import CompressionConfig
from .compressors.registry import canonical_name
from .participation import ParticipationSpec

__all__ = ["ChannelSpec", "Rule", "CompressionPolicy", "as_policy", "parse_rules",
           "load_policy", "partition_for", "PolicyPartition", "grouped_bucket_layout",
           "policy_bits_per_dim", "tree_paths"]

# Unset ChannelSpec knobs take the flat config's own defaults (k=64,
# block_size=2048, p=inf).
_FLAT_DEFAULTS = CompressionConfig()

_LAYOUTS = ("bucketed", "perleaf")
_CATCH_ALL = ("", ".*")   # the catch-all rule's patterns (parse_rules spells it ``*``)
_H_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_H_NAMES = {v: k for k, v in _H_DTYPES.items()}


@dataclass(frozen=True)
class ChannelSpec:
    """One direction's operator for one parameter group.

    method:     any registry name or alias.
    k:          kept coordinates of the sparse operators (None inherits:
                a downlink the uplink's ``k``, else the flat default 64).
    block_size: quantization block of the ternary family.
    p:          norm power of the ternary family.
    alpha:      memory-rate override (None: the operator's default).
    layout:     ``"bucketed"`` | ``"perleaf"`` | None (the policy's default).
    """

    method: str = "diana"
    k: Optional[int] = None
    block_size: Optional[int] = None
    p: Optional[float] = None
    alpha: Optional[float] = None
    layout: Optional[str] = None

    def __post_init__(self):
        canonical_name(self.method)  # raises on unknown methods
        if self.layout is not None and self.layout not in _LAYOUTS:
            raise ValueError(f"layout must be one of {_LAYOUTS} or None, got {self.layout!r}")
        if self.block_size is not None and self.block_size % 4:
            raise ValueError("block_size must be a multiple of 4 for 2-bit packing")
        if self.k is not None and self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")


def _pick(spec: ChannelSpec, base: Optional[ChannelSpec], fld: str, default):
    """One spec field: its own value, else the base (uplink) spec's, else
    the flat default."""
    v = getattr(spec, fld)
    if v is None and base is not None:
        v = getattr(base, fld)
    return default if v is None else v


@dataclass(frozen=True)
class Rule:
    """Leaves whose path matches ``pattern`` use ``spec`` uplink and, when
    set, ``down`` for the server broadcast; ``name`` labels the group
    (default: the spec's canonical method name)."""

    pattern: str
    spec: ChannelSpec
    down: Optional[ChannelSpec] = None
    name: Optional[str] = None

    def __post_init__(self):
        re.compile(self.pattern)  # raises on invalid regexes

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None

    @property
    def is_catch_all(self) -> bool:
        return self.pattern in _CATCH_ALL

    def label(self) -> str:
        return self.name or canonical_name(self.spec.method)


@dataclass(frozen=True)
class CompressionPolicy:
    """Ordered path-pattern -> :class:`ChannelSpec` rules + model-wide knobs.

    rules:    first match wins; the last should be a catch-all.  Group
              identity is the rule, so the state layout is a function of
              (policy, tree).
    bucketed: the layout of specs with ``layout=None``.
    h_dtype:  dtype of every DIANA memory.
    vr, vr_p: VR-DIANA, model-wide (:mod:`repro_torch.core.vr`).
    participation: elastic participation
              (:class:`~repro_torch.core.participation.ParticipationSpec`),
              model-wide: the rule configs never carry it.
    chunk_bytes, topology, node_size: the wire schedule, model-wide
              (:class:`~repro_torch.core.compression.CompressionConfig`).
    """

    rules: Tuple[Rule, ...] = (Rule(".*", ChannelSpec()),)
    bucketed: bool = False
    h_dtype: Any = torch.float32
    vr: bool = False
    vr_p: Optional[float] = None
    participation: Optional[ParticipationSpec] = None
    chunk_bytes: int = 0
    topology: str = "flat"
    node_size: int = 1

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        if not self.rules:
            raise ValueError("a CompressionPolicy needs at least one rule")
        if len(self.rules) > 100:
            raise ValueError("at most 100 rules (group names are zero-padded to two digits)")
        if self.vr_p is not None and not 0.0 < self.vr_p <= 1.0:
            raise ValueError(f"vr_p must be in (0, 1], got {self.vr_p}")
        if self.participation is not None and not isinstance(self.participation,
                                                             ParticipationSpec):
            raise TypeError("participation must be a ParticipationSpec")
        if self.chunk_bytes < 0:
            raise ValueError(f"chunk_bytes must be >= 0, got {self.chunk_bytes}")
        if self.topology not in ("flat", "hierarchical"):
            raise ValueError(
                f"topology must be 'flat' or 'hierarchical', got {self.topology!r}")
        if self.node_size < 1:
            raise ValueError(f"node_size must be >= 1, got {self.node_size}")

    def match(self, path: str) -> int:
        """The index of the first rule matching ``path``."""
        for i, rule in enumerate(self.rules):
            if rule.matches(path):
                return i
        raise KeyError(f"no rule matches leaf path {path!r}: policies must end with a "
                       f"catch-all rule ('.*'); patterns {[r.pattern for r in self.rules]}")

    # ------------------------------------------------- flat-config round trip

    @property
    def is_uniform(self) -> bool:
        """One catch-all rule that a flat config can express (a flat config
        cannot give the downlink its own block, p or alpha)."""
        if len(self.rules) != 1 or not self.rules[0].is_catch_all:
            return False
        d = self.rules[0].down
        return d is None or all(getattr(d, f) is None for f in ("block_size", "p", "alpha"))

    @classmethod
    def uniform(cls, cfg: CompressionConfig) -> "CompressionPolicy":
        """A flat config as a one-rule policy: ``uniform(cfg).flat_config()
        == cfg``."""
        spec = ChannelSpec(method=cfg.method, k=cfg.k, block_size=cfg.block_size, p=cfg.p,
                           alpha=cfg.alpha)
        down = None
        if cfg.down_method is not None:
            down = ChannelSpec(method=cfg.down_method, k=cfg.down_k,
                               layout=None if cfg.down_bucketed is None
                               else _LAYOUTS[0] if cfg.down_bucketed else _LAYOUTS[1])
        return cls(rules=(Rule(".*", spec, down=down),), bucketed=cfg.bucketed,
                   h_dtype=cfg.h_dtype, vr=cfg.vr, vr_p=cfg.vr_p,
                   participation=cfg.participation, chunk_bytes=cfg.chunk_bytes,
                   topology=cfg.topology, node_size=cfg.node_size)

    def flat_config(self) -> CompressionConfig:
        """The flat config of a uniform policy; raises for a grouped one."""
        if not self.is_uniform:
            raise ValueError("grouped policies have no flat CompressionConfig; use "
                             "rule_config() (or representative_config() for the model-wide "
                             "fields)")
        s, d = self.rules[0].spec, self.rules[0].down
        return CompressionConfig(
            method=s.method, p=_pick(s, None, "p", _FLAT_DEFAULTS.p),
            block_size=_pick(s, None, "block_size", _FLAT_DEFAULTS.block_size),
            alpha=s.alpha, k=_pick(s, None, "k", _FLAT_DEFAULTS.k), h_dtype=self.h_dtype,
            bucketed=self._spec_bucketed(s), vr=self.vr, vr_p=self.vr_p,
            down_method=None if d is None else d.method, down_k=None if d is None else d.k,
            down_bucketed=None if d is None or d.layout is None else d.layout == "bucketed",
            participation=self.participation, chunk_bytes=self.chunk_bytes,
            topology=self.topology, node_size=self.node_size)

    def representative_config(self) -> CompressionConfig:
        """A flat view of the catch-all rule with the model-wide fields,
        for call sites that read only those."""
        if self.is_uniform:
            return self.flat_config()
        catch = next((i for i, r in enumerate(self.rules) if r.is_catch_all),
                     len(self.rules) - 1)
        return _dc_replace(_rule_config(self, catch), vr=self.vr, vr_p=self.vr_p,
                           participation=self.participation)

    # -------------------------------------------------------- per-rule configs

    def _spec_bucketed(self, spec: ChannelSpec) -> bool:
        return self.bucketed if spec.layout is None else spec.layout == "bucketed"

    def rule_config(self, i: int) -> CompressionConfig:
        """Rule ``i``'s UPLINK config (no VR, no downlink)."""
        return _rule_config(self, i)

    def rule_down_config(self, i: int) -> Optional[CompressionConfig]:
        """Rule ``i``'s DOWNLINK config, or None; unset knobs inherit the
        uplink spec's."""
        return _rule_down_config(self, i)

    def any_bucketed(self) -> bool:
        """Whether any group, in either direction, runs the bucketed layout."""
        for i, rule in enumerate(self.rules):
            if self._spec_bucketed(rule.spec):
                return True
            d = self.rule_down_config(i)
            if d is not None and d.bucketed:
                return True
        return False

    # -------------------------------------------------------------- rewriting

    def with_rule_specs(self, specs, downs=None) -> "CompressionPolicy":
        """New per-rule specs on the same skeleton (patterns, order, count
        and group names): unnamed rules get their current label pinned, so
        a new method never renames a group or moves its PRNG stream.
        ``None`` entries keep a rule's spec; ``downs`` may swap a live
        downlink spec but not add one (that changes the state layout)."""
        specs = tuple(specs)
        if len(specs) != len(self.rules):
            raise ValueError(f"with_rule_specs needs one spec per rule ({len(self.rules)}), "
                             f"got {len(specs)}")
        if downs is not None:
            downs = tuple(downs)
            if len(downs) != len(self.rules):
                raise ValueError(f"with_rule_specs downs needs one entry per rule "
                                 f"({len(self.rules)}), got {len(downs)}")

        def upd(i: int, rule: Rule) -> Rule:
            spec = specs[i] if specs[i] is not None else rule.spec
            down = rule.down
            if downs is not None and downs[i] is not None:
                if rule.down is None:
                    raise ValueError(f"rule {i} ({rule.pattern!r}) has no downlink channel: "
                                     "adding one changes the h_down state layout; build a "
                                     "new policy instead")
                down = downs[i]
            return _dc_replace(rule, spec=spec, down=down, name=rule.label())

        return _dc_replace(self, rules=tuple(upd(i, r) for i, r in enumerate(self.rules)))

    @classmethod
    def size_adaptive(cls, tree: Mapping[str, torch.Tensor], threshold_dims: int = 2 ** 16,
                      small: Optional[ChannelSpec] = None, large: Optional[ChannelSpec] = None,
                      **policy_kw) -> "CompressionPolicy":
        """Leaves with fewer than ``threshold_dims`` coordinates take
        ``small`` (default identity), the rest ``large`` (default the
        paper's ternary operator): one anchored alternation rule named
        ``small`` ahead of the catch-all named ``bulk``.  ``tree`` is a
        ``{path: tensor}`` dict (meta tensors will do)."""
        small = small if small is not None else ChannelSpec("identity")
        large = large if large is not None else ChannelSpec("diana")
        small_paths = tuple(p for p in tree_paths(tree) if tree[p].numel() < threshold_dims)
        rules = []
        if small_paths:
            pattern = "^(?:" + "|".join(re.escape(p) for p in small_paths) + ")$"
            rules.append(Rule(pattern, small, name="small"))
        rules.append(Rule(".*", large, name="bulk"))
        return cls(rules=tuple(rules), **policy_kw)

    def replace(self, **kw) -> "CompressionPolicy":
        return _dc_replace(self, **kw)

    def with_down(self, method: Optional[str] = None, k: Optional[int] = None
                  ) -> "CompressionPolicy":
        """Attach or override the downlink channel on EVERY rule; ``k``
        without a method (given or present) is inert."""

        def upd(rule: Rule) -> Rule:
            m = method if method is not None else (
                rule.down.method if rule.down is not None else None)
            if m is None:
                return rule
            base = rule.down if rule.down is not None else ChannelSpec(method=m)
            return _dc_replace(rule, down=_dc_replace(base, method=m,
                                                      k=k if k is not None else base.k))

        return _dc_replace(self, rules=tuple(upd(r) for r in self.rules))

    def force_perleaf(self) -> "CompressionPolicy":
        """Every group, both directions, in the per-leaf layout: the same
        results bit for bit, more collectives.  The two-level topology rides
        the fused wire, so it falls back to the flat exchange."""

        def fix(rule: Rule) -> Rule:
            spec = (_dc_replace(rule.spec, layout="perleaf")
                    if rule.spec.layout == "bucketed" else rule.spec)
            down = None if rule.down is None else _dc_replace(rule.down, layout="perleaf")
            return _dc_replace(rule, spec=spec, down=down)

        return _dc_replace(self, bucketed=False, topology="flat",
                           rules=tuple(fix(r) for r in self.rules))

    # ---------------------------------------------------------- serialization

    def to_json_dict(self) -> dict:
        def spec_dict(s: ChannelSpec) -> dict:
            d = {"method": s.method}
            for f in ("k", "block_size", "alpha", "layout"):
                if getattr(s, f) is not None:
                    d[f] = getattr(s, f)
            if s.p is not None:
                d["p"] = "inf" if s.p == math.inf else s.p
            return d

        rules = []
        for r in self.rules:
            rd = {"pattern": r.pattern, **spec_dict(r.spec)}
            if r.down is not None:
                rd["down"] = spec_dict(r.down)
            if r.name is not None:
                rd["name"] = r.name
            rules.append(rd)
        doc = {"rules": rules, "bucketed": self.bucketed}
        if self.h_dtype is not torch.float32:
            doc["h_dtype"] = _H_NAMES[self.h_dtype]
        if self.vr:
            doc["vr"] = True
        if self.vr_p is not None:
            doc["vr_p"] = self.vr_p
        if self.participation is not None:
            doc["participation"] = self.participation.to_json_dict()
        if self.chunk_bytes:
            doc["chunk_bytes"] = self.chunk_bytes
        if self.topology != "flat":
            doc["topology"] = self.topology
        if self.node_size != 1:
            doc["node_size"] = self.node_size
        return doc

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), indent=1)

    @classmethod
    def from_json_dict(cls, doc: dict, **defaults) -> "CompressionPolicy":
        """From a JSON document (the JAX package's format); ``defaults``
        seed the model-wide fields and the document's keys win.  Its
        ``worker_axes`` and ``use_kernel`` are read and dropped (no
        counterpart here)."""

        def spec_of(d: dict) -> ChannelSpec:
            kw = {"method": d["method"]}
            for f in ("k", "block_size", "alpha", "layout"):
                if f in d:
                    kw[f] = d[f]
            if "block" in d:  # the inline syntax's alias
                kw["block_size"] = d["block"]
            if "p" in d:
                kw["p"] = math.inf if d["p"] in ("inf", "Infinity") else float(d["p"])
            return ChannelSpec(**kw)

        rules = tuple(Rule(pattern=rd["pattern"], spec=spec_of(rd),
                           down=spec_of(rd["down"]) if rd.get("down") else None,
                           name=rd.get("name"))
                      for rd in doc["rules"])
        kw = dict(defaults)
        for f in ("bucketed", "vr", "vr_p", "chunk_bytes", "topology", "node_size"):
            if f in doc:
                kw[f] = doc[f]
        if "participation" in doc:
            kw["participation"] = (None if doc["participation"] is None
                                   else ParticipationSpec.from_json_dict(doc["participation"]))
        if "h_dtype" in doc:
            kw["h_dtype"] = _H_DTYPES[doc["h_dtype"]]
        return cls(rules=rules, **kw)

    @classmethod
    def from_json(cls, text: str, **defaults) -> "CompressionPolicy":
        return cls.from_json_dict(json.loads(text), **defaults)


@functools.lru_cache(maxsize=None)
def _rule_config(policy: CompressionPolicy, i: int) -> CompressionConfig:
    spec = policy.rules[i].spec
    bucketed = policy._spec_bucketed(spec)
    # the two-level exchange rides the fused wire: a per-leaf group runs the
    # flat one, and its node_size is inert
    topology = policy.topology if bucketed else "flat"
    return CompressionConfig(
        method=spec.method, p=_pick(spec, None, "p", _FLAT_DEFAULTS.p),
        block_size=_pick(spec, None, "block_size", _FLAT_DEFAULTS.block_size),
        alpha=spec.alpha, k=_pick(spec, None, "k", _FLAT_DEFAULTS.k), h_dtype=policy.h_dtype,
        bucketed=bucketed, chunk_bytes=policy.chunk_bytes, topology=topology,
        node_size=policy.node_size if topology == "hierarchical" else 1)


@functools.lru_cache(maxsize=None)
def _rule_down_config(policy: CompressionPolicy, i: int) -> Optional[CompressionConfig]:
    rule = policy.rules[i]
    if rule.down is None:
        return None
    up, d = rule.spec, rule.down
    return CompressionConfig(
        method=d.method, p=_pick(d, up, "p", _FLAT_DEFAULTS.p),
        block_size=_pick(d, up, "block_size", _FLAT_DEFAULTS.block_size),
        alpha=d.alpha if d.alpha is not None else up.alpha,
        k=_pick(d, up, "k", _FLAT_DEFAULTS.k), h_dtype=policy.h_dtype,
        bucketed=policy._spec_bucketed(up) if d.layout is None else d.layout == "bucketed",
        # the broadcast chunks as the uplink does; it has no topology
        chunk_bytes=policy.chunk_bytes)


def as_policy(spec) -> CompressionPolicy:
    """A :class:`CompressionConfig` or :class:`CompressionPolicy` as a
    policy (the config as a uniform one-rule policy)."""
    if isinstance(spec, CompressionPolicy):
        return spec
    if isinstance(spec, CompressionConfig):
        return CompressionPolicy.uniform(spec)
    raise TypeError(f"expected a CompressionConfig or CompressionPolicy, got "
                    f"{type(spec).__name__}")


# ---------------------------------------------------------------------------
# Tree partitioning: leaves -> groups by rule
# ---------------------------------------------------------------------------

def tree_paths(tree: Mapping[str, Any]) -> Tuple[str, ...]:
    """The leaf paths in ``jax.tree_util`` flatten order: what rule
    patterns match against."""
    return tuple(T.paths(tree))


class PolicyPartition:
    """The partition of one tree's paths under a policy (cached per
    (policy, paths)).  Group ``g`` holds the leaves of rule ``rule_ids[g]``
    in tree order, named ``g<rule:02d>_<label>``; ``configs`` /
    ``down_configs`` are each group's uplink and downlink configs."""

    def __init__(self, policy: CompressionPolicy, paths: Tuple[str, ...]):
        self.policy = policy
        self.paths = paths
        leaf_rule = tuple(policy.match(p) for p in paths)
        active = sorted(set(leaf_rule))
        self.rule_ids: Tuple[int, ...] = tuple(active)
        self.group_names: Tuple[str, ...] = tuple(
            f"g{ri:02d}_{policy.rules[ri].label()}" for ri in active)
        self.group_leaf_ids: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(i for i, r in enumerate(leaf_rule) if r == ri) for ri in active)
        self.group_paths: Tuple[Tuple[str, ...], ...] = tuple(
            tuple(paths[i] for i in ids) for ids in self.group_leaf_ids)
        self.configs: Tuple[CompressionConfig, ...] = tuple(
            policy.rule_config(ri) for ri in active)
        self.down_configs: Tuple[Optional[CompressionConfig], ...] = tuple(
            policy.rule_down_config(ri) for ri in active)

    @property
    def n_groups(self) -> int:
        return len(self.rule_ids)

    def split(self, tree: Mapping[str, Any]):
        """Per-group ``{path: leaf}`` dicts of ``tree`` (any tree on the same
        paths: grads, params, stacked per-worker trees), in group order."""
        if len(tree) != len(self.paths):
            raise ValueError(f"tree has {len(tree)} leaves, the partition {len(self.paths)}")
        return [{p: tree[p] for p in ps} for ps in self.group_paths]

    def merge(self, group_parts: Sequence[Any]):
        """Inverse of :meth:`split`: per-group dicts, or leaf lists in the
        group's path order, back into one ``{path: leaf}`` tree."""
        out = {}
        for ps, part in zip(self.group_paths, group_parts):
            leaves = [part[p] for p in ps] if isinstance(part, Mapping) else list(part)
            if len(leaves) != len(ps):
                raise ValueError(f"a group of {len(ps)} leaves got {len(leaves)}")
            out.update(zip(ps, leaves))
        return {p: out[p] for p in self.paths}


@functools.lru_cache(maxsize=None)
def _partition_cached(policy: CompressionPolicy, paths: Tuple[str, ...]) -> PolicyPartition:
    return PolicyPartition(policy, paths)


def partition_for(policy: CompressionPolicy, tree: Mapping[str, Any]) -> PolicyPartition:
    """The (cached) partition of ``tree``'s paths under ``policy``."""
    return _partition_cached(policy, tree_paths(tree))


# ---------------------------------------------------------------------------
# Grouped bucket layout + policy-aware wire accounting
# ---------------------------------------------------------------------------

def grouped_bucket_layout(policy: CompressionPolicy, tree) -> GroupedBucketLayout:
    """One :class:`~repro_torch.core.bucket.BucketLayout` per group, each
    aligned to its own operator's ``bucket_align()``."""
    part = partition_for(policy, tree)
    layouts = tuple(BucketLayout.for_tree(leaves, align=cfg.make().bucket_align())
                    for leaves, cfg in zip(part.split(tree), part.configs))
    return GroupedBucketLayout(names=part.group_names, rule_ids=part.rule_ids,
                               layouts=layouts)


def policy_bits_per_dim(policy: CompressionPolicy, layout, *,
                        checksum: bool = False) -> float:
    """Size-weighted mean UPLINK wire cost per coordinate across groups;
    ``layout`` is a :class:`~repro_torch.core.bucket.GroupedBucketLayout` or
    a ``{path: tensor}`` tree.  ``checksum=True`` (faults armed) adds the
    8-byte tail each wire buffer of a bucketed group carries, one per chunk
    (:func:`~repro_torch.core.bucket.checksum_tail_bits_per_dim`); per-leaf
    groups carry none."""
    if not isinstance(layout, GroupedBucketLayout):
        layout = grouped_bucket_layout(policy, layout)
    bits = total = 0.0
    for ri, lay in zip(layout.rule_ids, layout.layouts):
        cfg = policy.rule_config(ri)
        comp = cfg.make()
        for s in lay.sizes:
            bits += comp.bits_per_dim(s) * s
            total += s
        if checksum and cfg.bucketed:
            bits += checksum_tail_bits_per_dim(lay, cfg.chunk_bytes) * lay.size
    return bits / max(total, 1.0)


# ---------------------------------------------------------------------------
# Inline rule syntax + file loading (the trainer's --comp-policy)
# ---------------------------------------------------------------------------

_SPEC_FIELDS = {"k": int, "block_size": int, "alpha": float}
_FIELD_ALIASES = {"block": "block_size"}


def _parse_spec(text: str) -> ChannelSpec:
    parts = [b.strip() for b in text.strip().split(":") if b.strip()]
    if not parts:
        raise ValueError("empty operator spec")
    kw: dict = {"method": parts[0]}
    for item in parts[1:]:
        fld, sep, val = item.partition("=")
        if not sep:
            raise ValueError(f"spec option {item!r} is not field=value")
        fld = _FIELD_ALIASES.get(fld, fld)
        if fld == "layout":
            kw[fld] = val
        elif fld == "p":
            kw[fld] = math.inf if val in ("inf", "Inf", "INF") else float(val)
        elif fld in _SPEC_FIELDS:
            kw[fld] = _SPEC_FIELDS[fld](val)
        else:
            raise ValueError(f"unknown spec field {fld!r} in {text!r}")
    return ChannelSpec(**kw)


def parse_rules(text: str) -> Tuple[Rule, ...]:
    """The inline rule syntax
    ``pattern=method[:field=value...][/down_method[:field=value...]], ...``,
    e.g. ``scale|bias=identity,embed=topk_ef:k=256,*=diana:block=1024/natural``:
    ``*`` is the catch-all, ``block`` aliases ``block_size``, and the ``/``
    after the first ``=`` attaches the downlink.  Patterns are ``re.search``
    regexes without ``,`` or ``=``."""
    rules = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        pattern, sep, spec_txt = part.partition("=")
        if not sep or not spec_txt:
            raise ValueError(f"rule {part!r} is not pattern=method[...]")
        up_txt, _, down_txt = spec_txt.partition("/")
        pattern = pattern.strip()
        rules.append(Rule(pattern=".*" if pattern == "*" else pattern,
                          spec=_parse_spec(up_txt),
                          down=_parse_spec(down_txt) if down_txt.strip() else None))
    if not rules:
        raise ValueError(f"no rules in {text!r}")
    return tuple(rules)


def load_policy(source, **globals_kw) -> CompressionPolicy:
    """A policy from any of the trainer's surfaces: a policy (as it is), a
    flat config (uniform), a ``.json`` path (its model-wide keys override
    ``globals_kw``) or an inline rule string (``globals_kw`` give the
    model-wide fields)."""
    if isinstance(source, (CompressionPolicy, CompressionConfig)):
        return as_policy(source)
    if isinstance(source, str) and source.endswith(".json"):
        if not os.path.exists(source):
            raise FileNotFoundError(f"policy file {source!r} does not exist")
        with open(source) as f:
            return CompressionPolicy.from_json_dict(json.load(f), **globals_kw)
    return CompressionPolicy(rules=parse_rules(source), **globals_kw)
