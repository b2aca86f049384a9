"""DIANA's aggregation round (paper Algorithm 1) — single-process reference.

The port's copy of ``repro.core.diana``'s reference path for the flat
(uniform, uplink-only) config: ``reference_init`` / ``reference_step`` with
the bucketed (``_reference_agg_bucketed``) and per-leaf
(``_reference_agg_perleaf``) layouts, and the momentum tail of
``_reference_finish``.  Worker ``w`` draws from ``fold_in(key, w)``, each leaf
(or bucket segment) ``i`` from ``split(worker_key, n_leaves)[i]``, and the
server decodes the stacked payloads with ONE fused ``decode_sum_apply`` — so
for ternary p = inf ``ghat``, ``h_worker`` and ``h_server`` equal the jitted
JAX ``reference_step`` bit for bit, in both layouts.  For ``natural`` the
codes do; the decoded powers of two are exact here, where the JAX package's
CPU ``exp2`` is off by up to 4.05e-6 (``tests/test_torch_natural.py``).
``randk`` (per-segment rates ``k/d`` in the bucketed layout), ``topk_ef``
(the error-feedback rule) and ``none`` (identity) are bitwise the jitted JAX
round for n a power of two; at other n the jitted reference divides by n as
``s * f32(1/n)`` (``tests/test_torch_sparse.py``,
``tests/test_torch_identity.py``).  The round has no operator branches: each
operator's hooks carry its format and its memory rule.

The distributed round, :func:`aggregate_distributed`, is the port's
``aggregate_shardmap`` (``repro/core/diana.py:891``) for the flat config on
``torch.distributed``: each rank is one worker, encodes with its own key,
and ONE all-gather of the fused payload (one per field per leaf in the
per-leaf layout) brings every rank the same payloads, which every rank
decodes to the same ``ghat`` and ``h_server``.  ``none`` (identity) takes
one all-reduce instead.  Given the same keys it is bitwise
:func:`reference_step`'s round, as the JAX package's distributed round is its
reference's (``tests/test_torch_distributed.py``).

VR-DIANA (``cfg.vr``, :mod:`repro_torch.core.vr`) control-variates the
gradients against each worker's (snapshot, mu) before any layout decision
and refreshes the snapshots on each worker's coin; the compressed downlink
(``cfg.down_method``, :func:`downlink_round`) passes the f32 ``ghat``
through the downlink operator with its own memory ``h_down``, drawing from
``fold_in(key, DOWN_FOLD)`` (the step key before any worker fold).  Both
reach every path above with the same draws and the same arithmetic, so the
bitwise contracts extend to them (``tests/test_torch_vr.py``,
``tests/test_torch_downlink.py``).

Every entry point takes a flat :class:`CompressionConfig` or a
:class:`~repro_torch.core.policy.CompressionPolicy`.  A uniform policy runs
the flat code path above, draw for draw (``_split_spec``).  A grouped policy
runs one sub-round per group of its partition, each in the group's own
layout (one ``(n, Dp_g)`` buffer, or one memory per leaf), group ``g``
drawing from ``fold_in(worker_key, GROUP_FOLD + g)`` and its downlink from
``fold_in(fold_in(key, DOWN_FOLD), GROUP_FOLD + g)``; the grouped state is
a dict keyed by group name, holding a tensor for a bucketed group and a list
of per-leaf tensors (in the group's leaf order) for a per-leaf one.  VR
stays model-wide, applied before the grouping.  Distributed, identity
groups take the all-reduce, bucketed groups one fused all-gather each, and
per-leaf groups the per-leaf round (DESIGN.md §Policy).

Elastic participation (``participation`` on the config or the policy,
:mod:`repro_torch.core.participation`) makes the round a sampled sum: the
``(n,)`` mask is drawn once per step from ``fold_in(key, PART_FOLD)``, before
any worker or group fold; every worker still encodes, the non-participants'
gathered rows are zeroed (:meth:`Payload.mask_workers`) before the
operator's ``decode_sum``, the direction takes the rescaled sum and
``h_server`` the unrescaled ``sum / n`` (:func:`_masked_server_tail`), and
only participants' memory rows advance, by select, never by adding zero.  A
degraded step (fewer than ``min_workers``) gives ``ghat = 0`` and freezes
every memory; a rejoining worker's row is reset first and stays reset.
Identity leaves the all-reduce for the gather under participation.  A
fault plan (``faults``, bucketed flat configs only) puts each fused payload
on the checksummed wire (:func:`~repro_torch.core.bucket.add_checksum`) and
excludes the payloads whose checksum fails, as if their workers had left.

The wire schedule (``chunk_bytes``, ``topology``, ``node_size``; bucketed
layouts only).  With ``chunk_bytes > 0`` the flat buffer splits into
whole-leaf chunks (:class:`~repro_torch.core.bucket.ChunkedSchedule`): each
worker compresses chunk ``c`` with chunk ``c``'s slice of its monolithic
per-leaf keys, its own decode is the chunks' decodes joined, and the server
decodes chunk by chunk against that chunk's slice of ``h_server``;
distributed, chunk ``c+1``'s all-gather is issued (``async_op=True``) before
chunk ``c``'s decode, which waits on chunk ``c``'s gather alone.  Every
recurrence is per coordinate, so the chunked round is bitwise the monolithic
one.  :data:`CHUNK_FOLD` stays unused: the JAX package feeds it only to its
compiled-TPU in-kernel-PRNG encodes, which draw one stream per launch and are
equal to the monolithic round in distribution only; the port's
in-kernel-PRNG encodes draw the per-segment streams of the plain route, so
chunk keys are slices of the monolithic schedule and chunked equals
monolithic bit for bit on the card too.  With ``topology="hierarchical"``
the round is two-level: each node's ``node_size`` workers average their flat
f32 gradients uncompressed, in worker order (:func:`_ordered_node_sum`),
then one compressed round runs between the nodes, node ``b`` keyed
``fold_in(key, b)`` and holding one memory row, which each of its workers
stores.  It composes with neither participation, faults nor VR, and a
grouped policy keeps the flat topology.

Trees are ``{path: tensor}`` dicts (:mod:`repro_torch.core.tree`); stacked
per-worker grads carry a leading worker axis on every leaf.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

from . import prng
from . import transport
from . import tree as T
from .bucket import (BucketLayout, ChunkedSchedule, add_checksum, bucketed_compressor,
                     fuse_payload, payload_recipe, unfuse_payload, verify_checksum,
                     wire_roundtrip)
from .compression import CompressionConfig
from .compressors.base import Payload
from .numerics import div_n, fma32
from .participation import (PART_FOLD, ParticipationSpec, apply_faults, direction_scale,
                            step_ctx)
from .policy import CompressionPolicy, partition_for
from .telemetry import measure
from .vr import control_variate, init_vr, reference_coins, refresh, vr_coin

__all__ = [
    "DOWN_FOLD", "GROUP_FOLD", "CHUNK_FOLD", "PART_FOLD",
    "ReferenceState", "reference_init", "reference_step", "bucket_layout",
    "worker_key", "DianaState", "init_state", "init_downlink", "downlink_round",
    "aggregate_distributed",
]

# The JAX package's fold constants (repro/core/diana.py:79-98): the downlink
# stream, per-group streams of grouped policies (folded after the worker
# fold, and never by a uniform policy), and the JAX package's chunk streams
# for its compiled-TPU in-kernel-PRNG encodes, which the port never draws
# (see the module docstring).
DOWN_FOLD = 0x444E  # 'DN'
GROUP_FOLD = 0x4750  # 'GP'
CHUNK_FOLD = 0x434B  # 'CK'


class DianaState(NamedTuple):
    """The DIANA memories one process holds: ``h_worker`` with one row per
    worker it runs — ``(rows, Dp)`` bucketed or ``{path: (rows, d_leaf)}``
    per leaf; under ``torch.distributed`` the rank's own row, as shard_map's
    ``P(worker)`` gives it — and the replicated ``h_server``, ``(Dp,)`` or
    ``{path: (d_leaf,)}``.  ``vr`` (a :class:`~repro_torch.core.vr.VRState`
    with the same rows, or None) and ``h_down`` (the replicated downlink
    memory in the downlink's layout, or None) are there when the config
    asks for them."""

    h_worker: Any
    h_server: Any
    vr: Any = None
    h_down: Any = None


class ReferenceState(NamedTuple):
    h_worker: Any  # (n, Dp) bucketed, or {path: (n, d_leaf)} per leaf
    h_server: Any  # (Dp,) bucketed, or {path: (d_leaf,)} per leaf
    v: Any         # momentum buffer {path: f32 tensor shaped like the param}
    vr: Any = None      # VRState (cfg.vr), as DianaState.vr
    h_down: Any = None  # downlink memory (cfg.down_method), as DianaState.h_down


def bucket_layout(cfg: CompressionConfig, tree: Mapping[str, torch.Tensor]) -> BucketLayout:
    """The flat-buffer layout of ``tree`` under ``cfg``'s operator."""
    return BucketLayout.for_tree(tree, align=cfg.make().bucket_align())


def _split_spec(spec):
    """``(policy, flat_cfg)``, exactly one of them set (``repro/core/diana.py
    :101``): a uniform policy collapses to its flat config (the flat code
    path, draw for draw); a grouped policy stays itself."""
    if isinstance(spec, CompressionPolicy):
        if spec.is_uniform:
            return None, spec.flat_config()
        return spec, None
    if isinstance(spec, CompressionConfig):
        return None, spec
    raise TypeError(f"expected a CompressionConfig or CompressionPolicy, got "
                    f"{type(spec).__name__}")


def _zero_memories(params, cfg: CompressionConfig, n_workers: int, dt: torch.dtype,
                   as_list: bool = False):
    """``(h_worker, h_server)`` zeros in ``cfg``'s layout; per leaf, dicts
    by path, or lists in leaf order with ``as_list`` (a group's state)."""
    dev = next(iter(params.values())).device
    if cfg.bucketed:
        dp = bucket_layout(cfg, params).padded_size
        return (torch.zeros((n_workers, dp), dtype=dt, device=dev),
                torch.zeros((dp,), dtype=dt, device=dev))
    paths = T.paths(params)
    h_w = {p: torch.zeros((n_workers, params[p].numel()), dtype=dt, device=dev) for p in paths}
    h_s = {p: torch.zeros((params[p].numel(),), dtype=dt, device=dev) for p in paths}
    if as_list:
        return list(h_w.values()), list(h_s.values())
    return h_w, h_s


def init_downlink(params: Mapping[str, torch.Tensor], cfg: CompressionConfig, dtype=None,
                  dcfg: Optional[CompressionConfig] = None, as_list: bool = False):
    """``h_down^0 = 0`` in the downlink operator's own layout, one replicated
    copy (``repro/core/diana.py:235``); None without a downlink.  ``dcfg``
    overrides ``cfg.down_config()`` (a policy rule's downlink)."""
    dcfg = cfg.down_config() if dcfg is None else dcfg
    if dcfg is None:
        return None
    return _zero_memories(params, dcfg, 1, cfg.h_dtype if dtype is None else dtype,
                          as_list)[1]


def _init_grouped(params, policy: CompressionPolicy, n_workers: int, dtype=None):
    """A grouped policy's memories (``repro/core/diana.py:249``): dicts keyed
    by group name, each in its group's layout, a ``(n, Dp_g)`` / ``(Dp_g,)``
    pair for a bucketed group and lists of per-leaf memories otherwise;
    ``h_down`` per group with a downlink rule (None when no rule has one)."""
    part = partition_for(policy, params)
    dtype = policy.h_dtype if dtype is None else dtype
    h_w, h_s, h_d = {}, {}, {}
    for gname, leaves, cfg_g, dcfg in zip(part.group_names, part.split(params), part.configs,
                                          part.down_configs):
        h_w[gname], h_s[gname] = _zero_memories(leaves, cfg_g, n_workers, dtype, as_list=True)
        if dcfg is not None:
            h_d[gname] = init_downlink(leaves, cfg_g, dtype, dcfg, as_list=True)
    return h_w, h_s, (h_d or None)


def init_state(params: Mapping[str, torch.Tensor], cfg, n_workers: int) -> DianaState:
    """Zero memories in the config's ``h_dtype`` for ``n_workers`` rows (1 on
    a rank); the VR slot (``w_i^0 = x^0``, zero ``mu``) and ``h_down^0 = 0``
    when the config asks for them.  ``cfg`` is a flat config or a policy."""
    policy, cfg = _split_spec(cfg)
    if policy is not None:
        h_w, h_s, h_down = _init_grouped(params, policy, n_workers)
        return DianaState(h_worker=h_w, h_server=h_s,
                          vr=init_vr(params, n_workers) if policy.vr else None, h_down=h_down)
    h_w, h_s = _zero_memories(params, cfg, n_workers, cfg.h_dtype)
    return DianaState(h_worker=h_w, h_server=h_s,
                      vr=init_vr(params, n_workers) if cfg.vr else None,
                      h_down=init_downlink(params, cfg))


def reference_init(params: Mapping[str, torch.Tensor], cfg, n_workers: int) -> ReferenceState:
    """``h_i^0 = 0``, ``h^0 = 0``, ``v^0 = 0`` (f32), and the VR slot and
    ``h_down`` (f32) as :func:`init_state`."""
    policy, cfg = _split_spec(cfg)
    dev = next(iter(params.values())).device
    v = {p: torch.zeros(x.shape, dtype=torch.float32, device=dev) for p, x in params.items()}
    if policy is not None:
        h_w, h_s, h_down = _init_grouped(params, policy, n_workers, torch.float32)
        return ReferenceState(h_worker=h_w, h_server=h_s, v=v,
                              vr=init_vr(params, n_workers) if policy.vr else None,
                              h_down=h_down)
    h_w, h_s = _zero_memories(params, cfg, n_workers, torch.float32)
    return ReferenceState(h_worker=h_w, h_server=h_s, v=v,
                          vr=init_vr(params, n_workers) if cfg.vr else None,
                          h_down=init_downlink(params, cfg, torch.float32))


def worker_key(key: torch.Tensor, w: int) -> torch.Tensor:
    """The per-worker compression key ``fold_in(key, w)``."""
    return prng.fold_in(key, w)


def _worker_key(key: torch.Tensor, w: int, gfold: Optional[int]) -> torch.Tensor:
    """``fold_in(key, w)``, then a grouped policy's group fold (``:1515``):
    the distributed side folds the worker at the caller, the group in
    :func:`_aggregate_grouped`."""
    k = worker_key(key, w)
    return k if gfold is None else prng.fold_in(k, gfold)


def _vr_check(vr_p, vr_aux, params) -> None:
    if vr_p is None:
        raise ValueError("VR aggregation needs a concrete vr_p "
                         "(repro_torch.core.vr.resolve_vr_p)")
    if vr_aux is None or params is None:
        raise ValueError("VR aggregation needs vr_aux=(grads_at_snapshot, mu_candidate) "
                         "and the current parameters")


# ---------------------------------------------------------------------------
# Elastic participation plumbing (repro/core/diana.py:120-180)
# ---------------------------------------------------------------------------

def _resolve_participation(policy, cfg) -> Optional[ParticipationSpec]:
    """The active spec, or None: a trivial spec keeps the pre-elastic path."""
    spec = policy.participation if policy is not None else cfg.participation
    if spec is None or spec.is_trivial:
        return None
    return spec


def check_faults(spec) -> None:
    """A fault plan needs the flat bucketed layout: the checksum rides the
    fused wire (``:1008-1011``)."""
    policy, cfg = _split_spec(spec)
    if policy is not None or not cfg.bucketed:
        raise ValueError("fault injection rides the bucketed fused wire: use a flat config "
                         "with bucketed=True")


def step_part(spec, faults, part_key: torch.Tensor, n: int, step=None, worker_index=None):
    """One step's :class:`~repro_torch.core.participation.PartCtx`, or None
    for the pre-elastic round: ``spec`` (a flat config or a policy) names
    the participation; a fault plan without one runs the checksum alone
    over an all-workers mask.  ``part_key`` is ``fold_in(step_key,
    PART_FOLD)``."""
    policy, cfg = _split_spec(spec)
    pspec = _resolve_participation(policy, cfg)
    if faults is not None:
        check_faults(spec)
        pspec = pspec or ParticipationSpec()
    if pspec is None:
        return None
    if (pspec.churn or faults is not None) and step is None:
        raise ValueError("a churn schedule or a fault plan needs the step counter (step=)")
    if part_key is None:
        raise ValueError("elastic aggregation needs part_key = fold_in(step_key, PART_FOLD), "
                         "folded before the worker fold")
    return step_ctx(pspec, part_key, n, 0 if step is None else int(step), worker_index)


def _where_rows(cond, new, old):
    """Advance where ``cond``, keep ``old`` elsewhere, by SELECT (``:133``):
    ``x + 0.0`` would turn -0.0 into +0.0.  ``cond`` is a Python bool or a
    (n,) bool tensor over the leading rows; ``new`` / ``old`` a tensor or a
    ``{path: tensor}`` tree."""
    if isinstance(new, Mapping):
        return {k: _where_rows(cond, new[k], old[k]) for k in new}
    if isinstance(cond, bool):
        return new if cond else old
    c = cond.to(new.device).reshape(cond.shape + (1,) * (new.ndim - cond.ndim))
    return torch.where(c, new, old)


def _reinit_zero(reinit, h):
    """Zero the rows of the workers whose churn ``join`` fires this step,
    before the round (``:146``); the freeze selects back to this state, so a
    fresh row survives a degraded step."""
    zeros = ({k: torch.zeros_like(v) for k, v in h.items()} if isinstance(h, Mapping)
             else torch.zeros_like(h))
    return _where_rows(reinit, zeros, h)


def _participant_gate(part, valid=None) -> torch.Tensor:
    """The (n,) bool of the workers whose memory rows advance (``:154``):
    scheduled participants, on a non-degraded step, whose wire checksum
    verified (when faults are armed)."""
    gate = part.mask & part.ok
    return gate if valid is None else gate & valid


def _masked_server_tail(comp, h_f: torch.Tensor, total: torch.Tensor, n: int, part,
                        m_eff: torch.Tensor, inplace: bool = False, defer: bool = False):
    """The sampled-sum server tail on ONE flat f32 buffer (``:167``):
    ``ghat = server_direction(h, total * scale)`` with the rescale of the
    effective set ``m_eff`` (as the jitted reference rounds it,
    :meth:`~repro_torch.core.compressors.base.Compressor.scaled_direction`),
    ``h_server`` advanced with the unrescaled ``total / n``, both frozen
    (``ghat = 0``) on a degraded step.  ``inplace`` lets a memoryless
    operator scale ``total`` in place (the in-turn trainer's buffer; the
    same bits).  Returns ``(ghat, new_h, scale)``: ``scale`` is None unless
    ``defer`` (a downlink follows) and the operator's direction feeds the
    downlink's input unrounded
    (:attr:`~repro_torch.core.compressors.base.Compressor.fused_downlink_input`,
    top-k EF), when ``ghat`` is ``total`` itself and the direction is
    ``total * scale``: the caller hands ``scale`` to :func:`downlink_round`,
    which contracts the product into its input in one rounding, as the
    jitted reference does."""
    if not part.ok:
        return torch.zeros_like(h_f), h_f, None
    scale = float(direction_scale(part.spec, m_eff, part.ok))
    if defer and comp.fused_downlink_input:
        return total, comp.next_server_memory(h_f, div_n(total, n)), scale
    if not comp.carries_state:
        return (comp.server_direction(h_f, total.mul_(scale) if inplace else total * scale), h_f,
                None)
    return (comp.scaled_direction(h_f, total, scale),
            comp.next_server_memory(h_f, div_n(total, n)), None)


def _wire_exchange(payload: Payload, faults, step: int, widx: int, byte_offset: int = 0,
                   body_total: Optional[int] = None):
    """One worker's payload on the checksummed wire (``:675-681``): fused
    into one uint8 buffer, the checksum appended, this worker's scheduled
    faults injected.  A chunk's wire passes its ``byte_offset`` into the
    round's concatenated body and the ``body_total`` (``_chunk_wire_meta``,
    ``:694``).  Returns ``(wire, fused shape, recipe)``."""
    buf = fuse_payload(payload)
    wire = apply_faults(add_checksum(buf), faults, step, widx, byte_offset=byte_offset,
                        body_total=body_total)
    return wire, tuple(buf.shape), payload_recipe(payload)


def _chunk_wire_meta(pays):
    """Each chunk payload's byte offset into the round's concatenated wire
    body, and the body's total (``:694``): the window a corrupt event maps
    through, so it lands in exactly one chunk."""
    offs, acc = [], 0
    for pay in pays:
        offs.append(acc)
        acc += sum(f.numel() * f.element_size() for f in pay if f is not None)
    return offs, acc


# ---------------------------------------------------------------------------
# The wire schedule: chunks and the two-level topology (:499-587)
# ---------------------------------------------------------------------------

def _hier_node_size(cfg) -> int:
    """The active node size: > 1 exactly when the two-level round runs."""
    return cfg.node_size if cfg.topology == "hierarchical" else 1


def _node_scale(acc: torch.Tensor, s: int) -> torch.Tensor:
    """The node sum's ``/ s`` as the jitted JAX round computes it: XLA
    rewrites the division by a constant into ``acc * f32(1/s)``, which
    torch's CUDA division by a Python scalar also does, and its CPU one does
    not; so the port multiplies by the rounded reciprocal explicitly, the
    same bits on every device (exact for s a power of two)."""
    return acc.mul_(float(torch.tensor(1.0 / s, dtype=torch.float32)))


def _ordered_node_sum(rows, s: int) -> torch.Tensor:
    """The ascending f32 sum over one node's ``s`` > 1 worker rows, then
    ``/ s`` (``:519``): an explicit recurrence, never the backend's
    reduction."""
    acc = rows[0] + rows[1]
    for i in range(2, s):
        acc = acc + rows[i]
    return _node_scale(acc, s)


def _node_pool_tree(grads_per_worker, node_size: int):
    """Stacked per-worker grads ``(n, ...)`` -> per-node means ``(n / s,
    ...)`` in f32 with :func:`_ordered_node_sum` per leaf (``:541``)."""
    out = {}
    for p, x in grads_per_worker.items():
        xr = x.float().reshape(-1, node_size, *x.shape[1:])
        out[p] = _ordered_node_sum([xr[:, i] for i in range(node_size)], node_size)
    return out


def _check_topology(policy, cfg, pspec, faults, vr, n: int) -> None:
    """The two-level round's gates (``:1012-1030``, ``:1402-1418``): flat
    configs only, no participation, faults or VR, and ``node_size`` divides
    the worker count.  (The JAX package asserts the last three; the port
    raises ``ValueError``, as for its other assertions.)"""
    if policy is not None and policy.topology == "hierarchical":
        raise NotImplementedError("hierarchical topology runs only on flat (uniform) bucketed "
                                  "configs: grouped policies keep topology='flat'")
    if cfg is None or _hier_node_size(cfg) == 1:
        return
    if pspec is not None or faults is not None or vr is not None:
        raise ValueError("topology='hierarchical' composes with neither participation/faults "
                         "nor VR")
    if n % cfg.node_size:
        raise ValueError(f"node_size={cfg.node_size} must divide n_workers={n}")


def _chunk_payloads(cfg, sched: ChunkedSchedule, delta: torch.Tensor, key: torch.Tensor,
                    outs=None):
    """One worker's delta buffer compressed chunk by chunk (``:560``), chunk
    ``c`` with its slice of the monolithic keys ``split(key, n_leaves)``, so
    every leaf draws its monolithic bits; into ``outs[c]`` (a row of chunk
    ``c``'s stacked buffer) when given."""
    base = cfg.make()
    keys = prng.split(key, sched.layout.n_leaves)
    return [base.compress_bucketed_keys(cl, dseg, sched.chunk_keys(keys, c),
                                        out=None if outs is None else outs[c])
            for c, (cl, dseg) in enumerate(zip(sched.chunk_layouts, sched.split(delta)))]


def _chunk_decode_own(cfg, sched: ChunkedSchedule, pays) -> torch.Tensor:
    """A worker's own ``dhat`` over the whole buffer: the chunks' decodes
    written side by side into one ``(Dp,)`` buffer (``:578``; per
    coordinate, so bitwise the monolithic decode)."""
    dhat = views = None
    for c, (cl, pay) in enumerate(zip(sched.chunk_layouts, pays)):
        d = bucketed_compressor(cfg, cl).decode(pay, cl.padded_size)
        if dhat is None:
            dhat = torch.empty(sched.layout.padded_size, dtype=d.dtype, device=d.device)
            views = sched.split(dhat)
        views[c].copy_(d)
        del d
    return dhat


def _server_chunks(cfg, sched: ChunkedSchedule, take, n: int, h_server=None, *, mask=None,
                   hs_out=None):
    """The server side of a bucketed round, chunk by chunk (``:578``,
    ``:707``): ``take(c)`` hands over chunk ``c``'s stacked payload just
    before its decode (the distributed round's waits on that chunk's
    gather).  Without ``mask``, ``decode_sum_apply`` against each chunk's
    slice of ``h_server``; returns ``(ghat, new h_server)``, the memory
    written into ``hs_out`` when given (the trainer's held buffer; a chunk's
    slice once that chunk is decoded).  With ``mask`` (the (n,) effective
    rows), the masked ``decode_sum``, the other rows zeroed in place in the
    stacked payload; returns the sum.  One chunk returns the kernel's
    outputs as they are; more write their slices of ``(Dp,)`` buffers."""
    hs_in = None if mask is not None else sched.split(h_server)
    outs = None
    for c, cl in enumerate(sched.chunk_layouts):
        comp = bucketed_compressor(cfg, cl)
        st = take(c)
        if mask is None:
            res = comp.decode_sum_apply(st, n, cl.padded_size, hs_in[c])
        else:
            res = (comp.decode_sum(st.mask_workers_(mask), n, cl.padded_size),)
        del st
        if sched.n_chunks == 1:
            outs = list(res)
        else:
            if outs is None:
                outs = [torch.empty(sched.layout.padded_size, dtype=r.dtype, device=r.device)
                        for r in res]
                if hs_out is not None:
                    outs[1] = hs_out
            for o, r in zip(outs, res):
                sched.split(o)[c].copy_(r)
        del res
    if mask is not None:
        return outs[0]
    if hs_out is not None and outs[1] is not hs_out:
        hs_out.copy_(outs[1])
        outs[1] = hs_out
    return outs[0], outs[1]


def _taker(items: list):
    """``take(c)`` over a list that drops each item as it is handed over."""
    def take(c):
        item, items[c] = items[c], None
        return item
    return take


def reference_step(grads_per_worker: Mapping[str, torch.Tensor], state: ReferenceState,
                   key: torch.Tensor, cfg, *, beta: float = 0.0,
                   vr_aux=None, params=None, vr_force_refresh: bool = False,
                   step: Optional[int] = None, faults=None, telemetry: bool = False):
    """Aggregate stacked per-worker grads ``{path: (n, *shape)}`` exactly as
    Algorithm 1; returns ``(v, new_state)`` with ``v = beta * v + ghat``.

    With ``state.vr`` (the config's ``vr``) the round is VR-DIANA
    (``repro/core/diana.py:1419-1438``): the grads are control-variated
    against each worker's (snapshot, mu) first, ``vr_aux = (grads at the
    snapshots, mu candidates)`` stacked like the grads and ``params`` the
    current iterate, and the rows whose coin (or ``vr_force_refresh``) is set
    refresh.  With ``state.h_down`` (a downlink) ``ghat`` passes through
    :func:`downlink_round` before the momentum.  A grouped policy runs
    :func:`_reference_grouped`.

    With a non-trivial ``participation`` the round is elastic
    (``:1390-1412``): the mask is drawn from ``fold_in(key, PART_FOLD)``,
    ``step`` (default 0) drives the churn schedule, VR's coins are gated on
    the scheduled mask and a degraded step freezes ``h_down`` and zeroes
    ``ghat``.  ``faults`` (a
    :class:`~repro_torch.core.participation.FaultPlan`, flat bucketed
    configs only) puts each worker's payload on the checksummed wire.

    ``telemetry=True`` returns ``(v, new_state, telem)``, ``telem`` the
    :class:`~repro_torch.core.telemetry.GroupTelemetry` of the served f32
    direction (after the downlink, before the momentum): a pure observer,
    ``v`` and the state are the same bits."""
    n = next(iter(grads_per_worker.values())).shape[0]
    part = step_part(cfg, faults, prng.fold_in(key, PART_FOLD), n, step)
    policy, cfg = _split_spec(cfg)
    _check_topology(policy, cfg, _resolve_participation(policy, cfg), faults, state.vr, n)
    new_vr = state.vr
    if state.vr is not None:
        vr_p = policy.vr_p if policy is not None else cfg.vr_p
        _vr_check(vr_p, vr_aux, params)
        g_snap, mu_cand = vr_aux
        grads_per_worker = control_variate(grads_per_worker, g_snap, state.vr.mu)
        coins = reference_coins(key, vr_p, n) | bool(vr_force_refresh)
        if part is not None:
            # the scheduled mask only, never the wire verdict (:1434-1437)
            coins = coins & _participant_gate(part)
        new_vr = refresh(state.vr, coins, params, mu_cand)
    if policy is not None:
        ghat, new_hw, new_hs, new_h_down = _reference_grouped(grads_per_worker, state, key,
                                                              policy, part)
    else:
        defer = state.h_down is not None
        if cfg.bucketed:
            ghat, new_hw, new_hs, scale = _reference_agg_bucketed(
                grads_per_worker, state.h_worker, state.h_server, key, cfg, part=part,
                faults=faults, step=step, defer=defer)
        else:
            ghat, new_hw, new_hs, scale = _reference_agg_perleaf(
                grads_per_worker, state.h_worker, state.h_server, key, cfg, part=part,
                defer=defer)
        new_h_down = None
        if state.h_down is not None:
            # _reference_finish's downlink (:1605-1626): the distributed path's
            # downlink_round and key, its memory in f32
            ghat, new_h_down = _frozen_downlink(
                part, state.h_down, ghat,
                lambda: downlink_round(ghat, state.h_down, prng.fold_in(key, DOWN_FOLD), cfg,
                                       h_dtype=torch.float32, scale=scale))
    # The momentum accumulate as one FMA: XLA contracts it so for most
    # leaves (beta = 0 makes the choice moot).
    v = {p: fma32(beta, state.v[p], ghat[p]) for p in ghat}
    new_state = ReferenceState(h_worker=new_hw, h_server=new_hs, v=v, vr=new_vr,
                               h_down=new_h_down)
    if telemetry:
        return v, new_state, measure(policy, ghat, ok=None if part is None else part.ok)
    return v, new_state


def _frozen_downlink(part, h_down, ghat, run):
    """``run()`` (a downlink round -> ``(ghat, new_h_down)``), except on a
    degraded step, which broadcasts nothing: ``ghat`` stays zero and
    ``h_down`` frozen (``:1082-1092``; the JAX round computes the downlink
    and selects it away, the same bits)."""
    if part is None or part.ok:
        return run()
    return ghat, h_down


def _reference_grouped(grads_per_worker, state, key, policy: CompressionPolicy, part=None):
    """The grouped reference round (``repro/core/diana.py:1474``): per
    group, the group's own layout's round with ``gfold = GROUP_FOLD + g``,
    then its downlink (when its rule has one) keyed
    ``fold_in(fold_in(key, DOWN_FOLD), GROUP_FOLD + g)``; returns ``(ghat,
    h_worker, h_server, h_down)``, the memories keyed by group name.  The
    one participation context ``part`` serves every group."""
    groups = partition_for(policy, grads_per_worker)
    ghat, new_hw, new_hs, new_hd = [], {}, {}, {}
    for g, (gname, grads, paths) in enumerate(zip(groups.group_names,
                                                  groups.split(grads_per_worker),
                                                  groups.group_paths)):
        cfg_g, dcfg = groups.configs[g], groups.down_configs[g]
        hw, hs = state.h_worker[gname], state.h_server[gname]
        if cfg_g.bucketed:
            ghat_g, new_hw[gname], new_hs[gname], scale = _reference_agg_bucketed(
                grads, hw, hs, key, cfg_g, gfold=GROUP_FOLD + g, part=part,
                defer=dcfg is not None)
        else:
            ghat_g, hw_d, hs_d, scale = _reference_agg_perleaf(
                grads, dict(zip(paths, hw)), dict(zip(paths, hs)), key, cfg_g,
                gfold=GROUP_FOLD + g, part=part, defer=dcfg is not None)
            new_hw[gname], new_hs[gname] = [hw_d[p] for p in paths], [hs_d[p] for p in paths]
        if dcfg is not None:
            dkey = prng.fold_in(prng.fold_in(key, DOWN_FOLD), GROUP_FOLD + g)
            ghat_g, new_hd[gname] = _frozen_downlink(
                part, state.h_down[gname], ghat_g,
                lambda: _group_downlink(ghat_g, state.h_down[gname], dkey, cfg_g, dcfg,
                                        torch.float32, scale))
        ghat.append(ghat_g)
    return groups.merge(ghat), new_hw, new_hs, (new_hd or None)


def _group_downlink(ghat_g, h_down_g, down_key, cfg_g, dcfg, h_dtype, scale=None):
    """A group's downlink round (``scale`` the round's deferred one); a
    grouped state's per-leaf downlink memory is a list in the group's leaf
    order (a flat state's, a dict)."""
    if dcfg.bucketed or isinstance(h_down_g, Mapping):
        return downlink_round(ghat_g, h_down_g, down_key, cfg_g, h_dtype=h_dtype, dcfg=dcfg,
                              scale=scale)
    out, new_h = downlink_round(ghat_g, dict(zip(T.paths(ghat_g), h_down_g)), down_key, cfg_g,
                                h_dtype=h_dtype, dcfg=dcfg, scale=scale)
    return out, [new_h[p] for p in T.paths(ghat_g)]


# ---------------------------------------------------------------------------
# Downlink: the compressed server broadcast
# ---------------------------------------------------------------------------

def downlink_round(ghat: Mapping[str, torch.Tensor], h_down, down_key: torch.Tensor,
                   cfg: CompressionConfig, *, h_dtype=None,
                   dcfg: Optional[CompressionConfig] = None, scale: Optional[float] = None):
    """Pass the aggregated direction ``ghat`` (f32 leaves) through the
    DOWNLINK operator (``repro/core/diana.py:802-888``): the server encodes
    ``delta = compress_input(ghat, h_down)``, every receiver decodes the
    payload, takes ``server_direction(h_down, dhat)`` and advances the
    shared memory with ``next_memory``.  ``ghat``, ``h_down`` and
    ``down_key`` are the same on every worker, so the broadcast needs no
    collective: each rank runs the same replicated round.

    The layout is the downlink's own (``cfg.down_config().bucketed``): ONE
    compress of the flat buffer keyed ``down_key``, its payload through
    :func:`~repro_torch.core.bucket.wire_roundtrip` (with ``chunk_bytes``,
    chunk by chunk, each chunk its own wire object); or per leaf, leaf ``i``
    keyed ``split(down_key, n_leaves)[i]``, payloads unfused.  ``down_key``
    is the step key folded with :data:`DOWN_FOLD` before any worker fold.

    With ``scale`` (an elastic top-k EF uplink's deferred one,
    :func:`_masked_server_tail`) ``ghat`` holds the participant sums and the
    direction is ``ghat * scale``: the server encodes
    ``compress_input_scaled(ghat, scale, h_down)``, one rounding.

    Returns ``(ghat_hat, new_h_down)``, ``ghat_hat`` shaped and typed like
    ``ghat`` and the memory in ``h_dtype`` (default ``cfg.h_dtype``).
    ``dcfg`` overrides ``cfg.down_config()``: a policy rule's downlink,
    which may carry its own block size or norm power."""
    dcfg = cfg.down_config() if dcfg is None else dcfg
    if dcfg is None:
        raise ValueError("downlink_round needs cfg.down_method")
    h_dtype = cfg.h_dtype if h_dtype is None else h_dtype
    if dcfg.bucketed:
        layout = bucket_layout(dcfg, ghat)
        comp = bucketed_compressor(dcfg, layout)
        h = h_down.float()
        # compress_input computed in the freshly flattened buffer (the same
        # bits as g - h, or g + h for error feedback)
        if scale is None:
            delta = comp.compress_input_(layout.flatten(ghat), h)
        else:
            delta = comp.compress_input_scaled(layout.flatten(ghat), scale, h)
        sched = ChunkedSchedule.for_layout(layout, dcfg.chunk_bytes)
        if sched.n_chunks > 1:
            # the chunked broadcast (:841-849): each chunk its own wire object
            pays = [wire_roundtrip(p) for p in _chunk_payloads(dcfg, sched, delta, down_key)]
            dhat = _chunk_decode_own(dcfg, sched, pays)
            del pays
        else:
            pay = wire_roundtrip(comp.compress(delta, down_key))
            dhat = comp.decode(pay, layout.padded_size)
            del pay
        new_h = comp.next_memory(h, dhat, delta).to(h_dtype)
        del delta
        return layout.unflatten(comp.server_direction(h, dhat), cast=True), new_h
    comp = dcfg.make()
    paths = T.paths(ghat)
    ghat_hat, new_h = {}, {}
    for p, k in zip(paths, prng.split(down_key, len(paths))):
        g, h = ghat[p].reshape(-1).float(), h_down[p].float()
        delta = (comp.compress_input(g, h) if scale is None
                 else comp.compress_input_scaled(g, scale, h))
        dhat = comp.decode(comp.compress(delta, k), g.numel())
        ghat_hat[p] = comp.server_direction(h, dhat).reshape(ghat[p].shape).to(ghat[p].dtype)
        new_h[p] = comp.next_memory(h, dhat, delta).to(h_dtype)
    return ghat_hat, new_h


def _reference_agg_perleaf(grads_per_worker, h_worker, h_server, key, cfg, gfold=None,
                           part=None, defer=False):
    """Per-leaf round: each worker encodes every leaf with its own key
    (``split(_worker_key(key, w, gfold), n_leaves)``), the server runs one
    fused ``decode_sum_apply`` per leaf.  With a participation context
    (``:1526-1600``): rejoining rows reset first, the stacked rows masked
    before ``decode_sum``, :func:`_masked_server_tail`, and only the
    :func:`_participant_gate` rows advance.  Returns ``(ghat, h_worker,
    h_server, scale)``, ``scale`` the tail's deferred one (or None)."""
    comp = cfg.make()
    paths = T.paths(grads_per_worker)
    n = grads_per_worker[paths[0]].shape[0]
    if part is not None:
        h_worker = _reinit_zero(part.reinit, h_worker)
    payloads = {p: [] for p in paths}
    new_hw = {p: [] for p in paths}
    for w in range(n):
        keys = prng.split(_worker_key(key, w, gfold), len(paths))
        for p, k in zip(paths, keys):
            g = grads_per_worker[p][w].float().reshape(-1)
            h = h_worker[p][w].float()
            delta = comp.compress_input(g, h)
            pay = comp.compress(delta, k)
            dhat = comp.decode(pay, g.numel())
            payloads[p].append(pay)
            new_hw[p].append(comp.next_memory(h, dhat, delta))
    ghat, new_hs, scale = {}, {}, None
    for p in paths:
        d = grads_per_worker[p].shape[1:].numel()
        stacked = Payload.stack(payloads[p])
        if part is None:
            g_flat, new_hs[p] = comp.decode_sum_apply(stacked, n, d, h_server[p].float())
        else:
            g_flat, new_hs[p], scale = _masked_server_tail(
                comp, h_server[p].float(), comp.decode_sum(stacked.mask_workers(part.mask), n, d),
                n, part, part.mask, defer=defer)
        ghat[p] = g_flat.reshape(grads_per_worker[p].shape[1:])
    new_hw = {p: torch.stack(rows) for p, rows in new_hw.items()}
    if part is not None:
        new_hw = _where_rows(_participant_gate(part), new_hw, h_worker)
    return ghat, new_hw, new_hs, scale


def _reference_agg_bucketed(grads_per_worker, h_worker, h_server, key, cfg, gfold=None,
                            part=None, faults=None, step=None, defer=False):
    """Bucketed round: each worker ONE compress of the flattened model (or
    policy group) keyed ``_worker_key(key, w, gfold)``; ONE fused
    ``decode_sum_apply`` over the stacked payloads.  With a participation
    context (``:1629-1760``) the masked ``decode_sum`` and
    :func:`_masked_server_tail` instead; with ``faults`` each worker's
    payload crosses the checksummed wire first (:func:`_wire_exchange`),
    and the payloads that fail verification are excluded like
    non-participants, their bytes decoded as received.

    Chunked (``cfg.chunk_bytes``): each worker compresses chunk by chunk
    (:func:`_chunk_payloads`), its own decode joins the chunks', and the
    server decodes per chunk against that chunk's ``h_server`` slice; under
    faults each chunk is its own checksummed wire, and a worker whose wire
    fails in any chunk is excluded whole.  Hierarchical: the grads pool to
    node means (:func:`_node_pool_tree`), the round runs over the nodes with
    the leader rows (node ``b`` keyed ``fold_in(key, b)``), and each node
    row is repeated over its workers."""
    node_size = _hier_node_size(cfg)
    if node_size > 1:
        grads_per_worker = _node_pool_tree(grads_per_worker, node_size)
        # the rows of a node are equal by construction: the leaders' rows
        # are the node memories
        h_worker = h_worker[::node_size]
    layout = bucket_layout(cfg, {p: g[0] for p, g in grads_per_worker.items()})
    comp = bucketed_compressor(cfg, layout)
    dp = layout.padded_size
    n = h_worker.shape[0]
    sched = ChunkedSchedule.for_layout(layout, cfg.chunk_bytes)
    chunked = sched.n_chunks > 1
    if part is not None:
        h_worker = _reinit_zero(part.reinit, h_worker)
    payloads, new_h = [], []   # payloads[w]: the worker's list of chunk payloads
    for w in range(n):
        flat_g = layout.flatten({p: g[w] for p, g in grads_per_worker.items()})
        delta = comp.compress_input(flat_g, h_worker[w])
        wkey = _worker_key(key, w, gfold)
        if chunked:
            pays = _chunk_payloads(cfg, sched, delta, wkey)
            dhat = _chunk_decode_own(cfg, sched, pays)
        else:
            pays = [comp.compress(delta, wkey)]
            dhat = comp.decode(pays[0], dp)
        payloads.append(pays)
        new_h.append(comp.next_memory(h_worker[w], dhat, delta))
    new_h = torch.stack(new_h)
    stacked = [Payload.stack([pays[c] for pays in payloads]) for c in range(sched.n_chunks)]
    if part is None:
        ghat_flat, new_hs = _server_chunks(cfg, sched, _taker(stacked), n, h_server.float())
        if node_size > 1:
            # every worker of a node stores the node's memory row
            new_h = torch.repeat_interleave(new_h, node_size, dim=0)
        # f32 leaves, like the per-leaf reference
        return layout.unflatten(ghat_flat, cast=False), new_h, new_hs, None
    valid = None
    if faults is not None:
        # the receivers' view: every worker's wire per chunk, verified after
        # the gather; a worker is excluded whole if any of its wires fails
        offs, body_total = _chunk_wire_meta(payloads[0])
        for c in range(sched.n_chunks):
            wires = [_wire_exchange(pays[c], faults, step, w, offs[c],
                                    body_total if chunked else None)
                     for w, pays in enumerate(payloads)]
            flat, v_c = verify_checksum(torch.stack([wire for wire, _, _ in wires]))
            _, shape, recipe = wires[0]
            stacked[c] = unfuse_payload(flat.reshape(n, *shape), recipe)
            valid = v_c if valid is None else valid & v_c
    m_eff = part.mask if valid is None else part.mask & valid
    total = _server_chunks(cfg, sched, _taker(stacked), n, mask=m_eff)
    ghat_flat, new_hs, scale = _masked_server_tail(comp, h_server.float(), total, n, part, m_eff,
                                                   defer=defer)
    new_h = _where_rows(_participant_gate(part, valid), new_h, h_worker)
    return layout.unflatten(ghat_flat, cast=False), new_h, new_hs, scale


# ---------------------------------------------------------------------------
# Distributed aggregation (one worker per torch.distributed rank)
# ---------------------------------------------------------------------------

class _Pending:
    """An issued all-gather and what its received bytes become: :meth:`wait`
    blocks on the collective alone (for NCCL, it orders the compute stream
    after it; the host does not synchronize) and returns the result.  The
    output buffers stay alive until then."""

    def __init__(self, works, result):
        self.works, self.result = [w for w in works if w is not None], result

    def wait(self):
        for w in self.works:
            w.wait()
        self.works = []
        return self.result()


def _gather_field_async(a: torch.Tensor, n: int, group=None, async_op: bool = True) -> _Pending:
    """Issue the all-gather of ONE payload field over the ranks of ``group``
    (the default group when None): ``(n, *a.shape)`` in group-rank order
    once waited on (``repro/core/diana.py:311``).  ``async_op=False`` runs
    it in place (the one-collective rounds).

    The field travels as its bytes (``view(torch.uint8)``, exact), ``(lead,
    W)``, into ONE preallocated ``(n * lead, W)`` buffer viewed as ``(n,
    lead, W)``: every dtype of the wire format (uint16/uint32 indices, int16
    codes) crosses gloo and NCCL alike."""
    src = a.contiguous().view(torch.uint8).reshape(a.shape[0], -1)
    out = torch.empty((n * src.shape[0], src.shape[1]), dtype=torch.uint8, device=src.device)
    work = transport.all_gather_into_tensor(out, src, group=group, async_op=async_op)
    return _Pending([work], lambda: out.view(n, *src.shape).view(a.dtype).reshape(n, *a.shape))


def _gather_field(a: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """:func:`_gather_field_async` run in place."""
    return _gather_field_async(a, n, group, async_op=False).wait()


def _gather_payload(pay: Payload, n: int, group=None) -> Payload:
    """All-gather every field of one leaf's payload over ``group`` (one
    collective per field, ``:336``)."""
    return Payload(*(None if f is None else _gather_field(f, n, group) for f in pay))


def _gather_payloads(payloads: Mapping[str, Payload], n: int, group=None):
    """:func:`_gather_payload` for every leaf, in leaf order."""
    return {p: _gather_payload(pay, n, group) for p, pay in payloads.items()}


def _gathered_mean(pay: Payload, d: int, n: int, comp, group=None) -> torch.Tensor:
    """``mean_i decode(payload_i)`` of one leaf of ``d`` coordinates, flat
    f32: the gathered payloads through the operator's ``decode_sum``, then
    ``/ n`` (``:347``, ``:372``)."""
    return div_n(comp.decode_sum(_gather_payload(pay, n, group), n, d), n).reshape(d).to(
        torch.float32)


def _gather_fused_async(payload: Payload, n: int, group=None, async_op: bool = True) -> _Pending:
    """Issue the all-gather of ONE fused uint8 buffer instead of one
    collective per field (``:474``): the populated fields byte-cast into one
    ``(lead, W)`` buffer (:func:`~repro_torch.core.bucket.fuse_payload`),
    gathered once, split back locally once waited on.  One populated field
    is gathered as itself: it already is one collective, and the fuse would
    only copy it."""
    populated = [i for i, f in enumerate(payload) if f is not None]
    if len(populated) == 1:
        pend = _gather_field_async(payload[populated[0]], n, group, async_op)

        def one():
            fields = [None] * len(Payload._fields)
            fields[populated[0]] = pend.result()
            return Payload(*fields)
        return _Pending(pend.works, one)
    recipe = payload_recipe(payload)
    pend = _gather_field_async(fuse_payload(payload), n, group, async_op)
    return _Pending(pend.works, lambda: unfuse_payload(pend.result(), recipe))


def _gather_fused(payload: Payload, n: int, group=None) -> Payload:
    """:func:`_gather_fused_async` run in place."""
    return _gather_fused_async(payload, n, group, async_op=False).wait()


_TOPOLOGY_GROUPS: dict = {}


def _topology_groups(node_size: int):
    """This rank's ``(intra-node group, inter-node group)`` of the default
    group's ranks (``_node_groups`` / ``_internode_groups``, ``:502-516``):
    node ``b`` is ranks ``b*s .. b*s + s - 1``; the inter-node group of
    intra-node rank ``r`` holds rank ``r`` of every node, ascending, so its
    gathered rows arrive in node order.  ``dist.new_group`` is collective:
    every rank builds every group, in the same order, once per world."""
    world = dist.group.WORLD
    n, rank = dist.get_world_size(), dist.get_rank()
    cached = _TOPOLOGY_GROUPS.get(node_size)
    if cached is not None and cached[0] is world:
        return cached[1]
    nodes = [list(range(b * node_size, (b + 1) * node_size)) for b in range(n // node_size)]
    intra = [dist.new_group(r) for r in nodes]
    inter = [dist.new_group([b * node_size + r for b in range(n // node_size)])
             for r in range(node_size)]
    mine = (intra[rank // node_size], inter[rank % node_size])
    _TOPOLOGY_GROUPS[node_size] = (world, mine)
    return mine


def _intranode_mean(g_flat: torch.Tensor, node_size: int, group) -> torch.Tensor:
    """Level 1 of the two-level round (``:530``): the node's flat f32
    gradients all-gathered over the intra-node group, then
    :func:`_ordered_node_sum`, the same on every rank of the node."""
    rows = _gather_field(g_flat[None], node_size, group)[:, 0]
    return _ordered_node_sum([rows[i] for i in range(node_size)], node_size)


def _aggregate_local(grads_local, h_worker, h_server, key, cfg, n, part=None, defer=False,
                     group=None):
    """The per-leaf Algorithm-1 round on this rank's leaves (``:381``): leaf
    ``i`` encodes with ``split(key, n_leaves)[i]``, each payload field is
    gathered on its own, and the server side is ``_gathered_mean``, then
    ``next_server_memory`` and ``server_direction`` (not the fused
    ``decode_sum_apply``), as the JAX package composes it.  ``ghat`` comes
    back f32, shaped like the grads.  With a participation context the
    masked sum and :func:`_masked_server_tail`; the rank's row advances
    only if it participates on a non-degraded step.  ``group`` is the
    workers' process group (the default group when None)."""
    comp = cfg.make()
    paths = T.paths(grads_local)
    keys = prng.split(key, len(paths))
    if part is not None:
        g_flat = {p: grads_local[p].reshape(-1).float() for p in paths}
        h_local = _reinit_zero(part.reinit_own, {p: h_worker[p][0].float() for p in paths})
        delta = {p: comp.compress_input(g_flat[p], h_local[p]) for p in paths}
        payloads = {p: comp.compress(delta[p], k) for p, k in zip(paths, keys)}
        return _aggregate_local_masked(grads_local, g_flat, h_local, delta, payloads, h_server,
                                       comp, cfg, n, part, defer)
    # Leaf by leaf, so that one leaf's f32 input and decodes live at a time
    # (the values are those of the whole-tree order): each encode, then the
    # rank's own estimate, decoded from its payload (bitwise the transmitted
    # value; memoryless rules ignore it, as XLA drops the decode).
    payloads, new_hw = {}, {}
    for p, k in zip(paths, keys):
        h = h_worker[p][0].float()
        delta = comp.compress_input(grads_local[p].reshape(-1).float(), h)
        payloads[p] = comp.compress(delta, k)
        new_hw[p] = h_worker[p]
        if comp.carries_state:
            new_hw[p] = comp.next_memory(h, comp.decode(payloads[p], delta.numel()),
                                         delta).to(cfg.h_dtype)[None]
        del delta
    ghat, new_hs = {}, {}
    for p in paths:
        hs = h_server[p].float()
        dhat_mean = _gathered_mean(payloads.pop(p), hs.numel(), n, comp, group)
        new_hs[p] = comp.next_server_memory(hs, dhat_mean).to(cfg.h_dtype)
        ghat[p] = comp.server_direction(hs, dhat_mean).reshape(grads_local[p].shape)
    return ghat, new_hw, new_hs, None


def _aggregate_local_masked(grads_local, g_flat, h_local, delta, payloads, h_server, comp,
                            cfg, n, part, defer=False):
    """:func:`_aggregate_local`'s sampled sum (``:446-470``): per-leaf
    payloads carry no checksum, so the effective set is the scheduled
    mask."""
    gathered = _gather_payloads(payloads, n)
    advance = part.m_own and part.ok
    ghat, new_hw, new_hs, scale = {}, {}, {}, None
    for p in T.paths(grads_local):
        total = comp.decode_sum(gathered.pop(p).mask_workers(part.mask), n, g_flat[p].numel())
        g, hs, scale = _masked_server_tail(comp, h_server[p].float(), total, n, part, part.mask,
                                           defer=defer)
        ghat[p] = g.reshape(grads_local[p].shape)
        new_hs[p] = hs.to(cfg.h_dtype)
        h = h_local[p]
        if comp.carries_state and advance:
            h = comp.next_memory(h, comp.decode(payloads[p], g_flat[p].numel()), delta[p])
        new_hw[p] = h.to(cfg.h_dtype)[None]
    return ghat, new_hw, new_hs, scale


def _aggregate_bucketed(grads_local, h_worker, h_server, key, cfg, n, part=None, faults=None,
                        step=None, defer=False):
    """Algorithm-1 round on the WHOLE model as one flat buffer (``:589``):
    ONE compress with the rank's key, its own decode for ``next_memory`` on
    the rank's ``(1, Dp)`` row, ONE fused all-gather, ONE
    ``decode_sum_apply`` over the ``n`` gathered rows, replicated on every
    rank.  ``ghat`` comes back f32.  With a participation context the masked
    round (:func:`_aggregate_bucketed_masked`); with ``cfg.chunk_bytes``
    the chunked wire (:func:`_chunked_wire`).

    Hierarchical (``:613-636``): the flat gradient is first averaged over
    the rank's node (:func:`_intranode_mean`), then the compressed round
    runs over the inter-node group, ``n / node_size`` payloads in node
    order.  The caller folds ``key`` with the node index."""
    layout = bucket_layout(cfg, grads_local)
    comp = bucketed_compressor(cfg, layout)
    dp = layout.padded_size
    g_flat = layout.flatten(grads_local)
    node_size = _hier_node_size(cfg)
    n_eff, group = n, None
    if node_size > 1:
        intra, group = _topology_groups(node_size)
        g_flat = _intranode_mean(g_flat, node_size, intra)
        n_eff = n // node_size
    h_local = h_worker[0].float()
    if part is not None:
        h_local = _reinit_zero(part.reinit_own, h_local)
    delta = comp.compress_input_(g_flat, h_local)
    del g_flat
    sched = ChunkedSchedule.for_layout(layout, cfg.chunk_bytes)
    if sched.n_chunks > 1:
        pays = _chunk_payloads(cfg, sched, delta, key)
        if part is not None:
            return _aggregate_bucketed_masked(layout, comp, h_local, delta, pays, h_server, cfg,
                                              n_eff, part, faults, step, sched, defer)
        # the memory once over the whole buffer ("only the wire is
        # chunked"), and the input freed before the wire's buffers exist
        new_hw = h_local.to(cfg.h_dtype)[None]
        if comp.carries_state:
            new_hw = comp.next_memory(h_local, _chunk_decode_own(cfg, sched, pays),
                                      delta).to(cfg.h_dtype)[None]
        del delta
        ghat_flat, new_hs = _chunked_wire(cfg, sched, pays, h_server, n_eff, group)
        return layout.unflatten(ghat_flat, cast=False), new_hw, new_hs.to(cfg.h_dtype), None
    payload = comp.compress(delta, key)
    if part is not None:
        return _aggregate_bucketed_masked(layout, comp, h_local, delta, [payload], h_server,
                                          cfg, n, part, faults, step, sched, defer)
    # The memory update before the gather, so that the own decode and the
    # input are freed before the server tail allocates (the values are the
    # same in either order).
    if comp.carries_state:
        new_hw = comp.next_memory(h_local, comp.decode(payload, dp), delta).to(cfg.h_dtype)[None]
    else:
        new_hw = h_worker
    del delta
    gathered = _gather_fused(payload, n_eff, group)    # ONE collective
    del payload
    ghat_flat, new_hs = comp.decode_sum_apply(gathered, n_eff, dp, h_server.float())
    return layout.unflatten(ghat_flat, cast=False), new_hw, new_hs.to(cfg.h_dtype), None


def _chunked_wire(cfg, sched, pays, h_server, n_eff, group):
    """The chunked wire of :func:`_aggregate_bucketed` (``:707``), software
    pipelined: chunk ``c+1``'s all-gather is issued before chunk ``c``'s
    ``decode_sum_apply``, which waits on chunk ``c``'s gather alone and
    writes its slice of ``ghat`` and ``h_server``.  ``pays`` (the rank's
    chunk payloads) is consumed: each chunk is dropped once gathered.
    Returns ``(ghat, new h_server)``, flat f32."""
    pending = [_gather_fused_async(pays[0], n_eff, group)]

    def take(c):
        if c + 1 < sched.n_chunks:
            pending.append(_gather_fused_async(pays[c + 1], n_eff, group))
        gathered = pending[c].wait()
        pending[c] = pays[c] = None
        return gathered
    return _server_chunks(cfg, sched, take, n_eff, h_server.float())


def _aggregate_bucketed_masked(layout, comp, h_local, delta, pays, h_server, cfg, n, part,
                               faults, step, sched, defer=False):
    """The bucketed sampled-sum round (``:653-691``, chunked ``:749-800``):
    ``pays`` holds one payload per chunk of ``sched``.  Every chunk's
    gather is issued before any verify or decode.  With ``faults`` each
    chunk's fused payload crosses the checksummed wire (:func:`_wire_exchange`,
    one all-gather of the wires per chunk) and every rank verifies every
    wire; a worker is excluded whole if any of its chunk wires fails.  The
    effective set is the scheduled mask AND the verdicts, and the rank's row
    advances only if it participates, the step is not degraded and its own
    wires verified (the verdict is the same on every rank)."""
    dp = layout.padded_size
    chunked = sched.n_chunks > 1
    new_h = h_local
    if comp.carries_state:
        dhat = _chunk_decode_own(cfg, sched, pays) if chunked else comp.decode(pays[0], dp)
        new_h = comp.next_memory(h_local, dhat, delta)
        del dhat
    del delta
    valid = None
    if faults is not None:
        offs, body_total = _chunk_wire_meta(pays)
        wires = [_wire_exchange(pay, faults, step, part.widx, offs[c],
                                body_total if chunked else None)
                 for c, pay in enumerate(pays)]
        pending = [_gather_field_async(wire, n, async_op=chunked) for wire, _, _ in wires]
        gathered = []
        for pend, (_, shape, recipe) in zip(pending, wires):
            flat, v_c = verify_checksum(pend.wait())
            gathered.append(unfuse_payload(flat.reshape(n, *shape), recipe))
            valid = v_c if valid is None else valid & v_c
        del wires, pending, flat
    else:
        pending = [_gather_fused_async(pay, n, async_op=chunked) for pay in pays]
        gathered = [pend.wait() for pend in pending]
        del pending
    del pays
    m_eff = part.mask if valid is None else part.mask & valid
    total = _server_chunks(cfg, sched, _taker(gathered), n, mask=m_eff)
    ghat_flat, new_hs, scale = _masked_server_tail(comp, h_server.float(), total, n, part, m_eff,
                                                   defer=defer)
    gate = part.m_own and part.ok and (valid is None or bool(valid[part.widx]))
    new_hw = (new_h if gate else h_local).to(cfg.h_dtype)[None]
    return layout.unflatten(ghat_flat, cast=False), new_hw, new_hs.to(cfg.h_dtype), scale


def _allreduce_mean(grads_local, cfg, n, group=None):
    """Identity's round (``prefers_allreduce``, ``:1206-1214``): the
    gathered mean IS an all-reduce.  f32, as every other round: ONE
    ``all_reduce(SUM)`` of the flat buffer in the bucketed layout, one per
    leaf in the per-leaf layout, then ``div_n``.  The sum's order is the
    backend's (gloo's, NCCL's), as the JAX package's ``pmean`` is XLA's."""
    if cfg.bucketed:
        layout = bucket_layout(cfg, grads_local)
        flat = layout.flatten(grads_local)
        transport.all_reduce(flat, group=group)
        return layout.unflatten(div_n(flat, n), cast=False)
    out = {}
    for p, g in grads_local.items():
        s = g.to(torch.float32, copy=True)
        transport.all_reduce(s, group=group)
        out[p] = div_n(s, n)
    return out


def _dispatch_round(grads_local, state, key, cfg, n, part=None, faults=None, step=None,
                    defer=False, group=None):
    """Route the gradient tree through the layout's round (``:1198``);
    returns ``(ghat, new_hw, new_hs, scale)``, ``scale`` the masked tail's
    deferred one (:func:`_masked_server_tail`) or None.  The per-leaf layout is
    ``_perleaf_round`` (``:1235-1283``): on a mesh without a model axis its
    local branch; on a model mesh (``group`` the rank's data group) its
    nested fully-manual mode, where each model rank runs the same round on
    its own shards of the leaves with the same per-leaf keys, and the
    payloads meet over the data group.  Under participation identity is
    gathered and summed like every operator (``:1208``)."""
    if cfg.make().prefers_allreduce and part is None:
        return (_allreduce_mean(grads_local, cfg, n, group), state.h_worker, state.h_server,
                None)
    if cfg.bucketed:
        return _aggregate_bucketed(grads_local, state.h_worker, state.h_server, key, cfg, n,
                                   part, faults, step, defer)
    return _aggregate_local(grads_local, state.h_worker, state.h_server, key, cfg, n, part,
                            defer, group)


def _aggregate_grouped(grads_local, state, key, policy: CompressionPolicy, n, down_key,
                       part=None):
    """One round of a grouped policy (``repro/core/diana.py:1118``): per
    group of the partition, the flat path's round for the group's config
    with the key ``fold_in(key, GROUP_FOLD + g)``: the all-reduce for an
    identity group, ONE fused all-gather for a bucketed group, the per-leaf
    round for a per-leaf one; then the group's downlink, keyed
    ``fold_in(down_key, GROUP_FOLD + g)``.  Returns ``(ghat, h_worker,
    h_server, h_down)``, the memories keyed by group name.  The one
    participation context ``part`` serves every group; under it an identity
    group is gathered and summed (``:1157``)."""
    groups = partition_for(policy, grads_local)
    ghat, new_hw, new_hs, new_hd = [], {}, {}, {}
    for g, (gname, grads, paths) in enumerate(zip(groups.group_names,
                                                  groups.split(grads_local),
                                                  groups.group_paths)):
        cfg_g, dcfg = groups.configs[g], groups.down_configs[g]
        hw, hs = state.h_worker[gname], state.h_server[gname]
        gkey = prng.fold_in(key, GROUP_FOLD + g)
        scale = None
        if cfg_g.make().prefers_allreduce and part is None:
            ghat_g = _allreduce_mean(grads, cfg_g, n)
        elif cfg_g.bucketed:
            ghat_g, hw, hs, scale = _aggregate_bucketed(grads, hw, hs, gkey, cfg_g, n, part,
                                                        defer=dcfg is not None)
        else:
            ghat_g, hw_d, hs_d, scale = _aggregate_local(grads, dict(zip(paths, hw)),
                                                  dict(zip(paths, hs)), gkey, cfg_g, n, part,
                                                  defer=dcfg is not None)
            hw, hs = [hw_d[p] for p in paths], [hs_d[p] for p in paths]
        if dcfg is not None:
            dkey = prng.fold_in(down_key, GROUP_FOLD + g)
            ghat_g, new_hd[gname] = _frozen_downlink(
                part, state.h_down[gname], ghat_g,
                lambda: _group_downlink(ghat_g, state.h_down[gname], dkey, cfg_g, dcfg,
                                        policy.h_dtype, scale))
        ghat.append(ghat_g)
        new_hw[gname], new_hs[gname] = hw, hs
    return groups.merge(ghat), new_hw, new_hs, (new_hd or None)


def aggregate_distributed(grads_local: Mapping[str, torch.Tensor], state: DianaState,
                          key: torch.Tensor, cfg, *, vr_aux=None,
                          params_local=None, vr_force_refresh: bool = False,
                          down_key: Optional[torch.Tensor] = None,
                          part_key: Optional[torch.Tensor] = None, step: Optional[int] = None,
                          faults=None, telemetry: bool = False, group=None):
    """One DIANA aggregation round across the ranks of the default process
    group (or of ``group``), one worker per rank — the port of
    ``repro.core.diana.aggregate_shardmap`` (``repro/core/diana.py:891``)
    with ``torch.distributed`` collectives in place of shard_map's.

    grads_local: this rank's gradient tree ``{path: tensor}`` (g_i^k).
    state:       :class:`DianaState` with the rank's own ``h_worker`` row
                 (leading dim 1) and the replicated ``h_server``.
    key:         already folded with the rank's worker index
                 (:func:`worker_key`).
    cfg:         a flat :class:`CompressionConfig`, or a
                 :class:`~repro_torch.core.policy.CompressionPolicy` (a
                 grouped one runs :func:`_aggregate_grouped`).

    With ``state.vr`` (the config's ``vr``, ``:1033-1057``) the rank feeds
    the control-variated ``g - g_snap + mu_own`` to the round: ``vr_aux =
    (grads at the rank's snapshot on the same batch, mu candidate)``, both
    parameter-shaped, and ``params_local`` the current iterate; its own coin
    ``vr_coin(key, vr_p)``, OR-ed with ``vr_force_refresh``, refreshes its
    row.  With ``state.h_down`` (a downlink, ``:1074-1081``) the f32
    ``ghat`` passes through :func:`downlink_round` keyed ``down_key`` =
    ``fold_in(step_key, DOWN_FOLD)``, folded BEFORE the worker fold.

    With a non-trivial ``participation`` (``:1000-1011``) the round is
    elastic: ``part_key = fold_in(step_key, PART_FOLD)``, folded before the
    worker fold, gives every rank the same mask; ``step`` (the optimizer's
    counter) drives the churn schedule and the fault plan; the rank's own
    bits are its rank's.  ``faults`` (a
    :class:`~repro_torch.core.participation.FaultPlan`, flat bucketed
    configs only) puts the fused payload on the checksummed wire.

    With ``chunk_bytes`` the bucketed rounds run the chunked wire; with
    ``topology="hierarchical"`` (a flat config) the two-level round, and
    ``key`` must be folded with the rank's NODE index ``rank // node_size``
    (``repro/launch/train.py:455-459``), not its rank.

    ``group`` (a model mesh's data group: the ranks holding the same model
    shard of every worker) runs the round over those ranks on this rank's
    gradient shards, with shard-local flat memories, as the JAX package's
    nested fully-manual per-leaf round (``:1235-1283``, ``inner_axes=
    ("model",)``): a flat per-leaf config (its ternary, natural, rand-k,
    top-k EF and identity rounds) without VR, a downlink or participation.

    Returns ``(ghat, new_state)``: ``ghat`` equal on every rank, cast back to
    the gradients' dtypes (``:1102``).  ``telemetry=True`` returns ``(ghat,
    new_state, telem)``, measured on the f32 served direction before the
    cast (no collective: ``ghat`` is replicated)."""
    n = dist.get_world_size(group)
    part = step_part(cfg, faults, part_key, n, step, dist.get_rank(group))
    policy, cfg = _split_spec(cfg)
    if group is not None and (policy is not None or cfg.bucketed or state.vr is not None
                              or state.h_down is not None or part is not None):
        raise NotImplementedError(
            "the round over a model mesh's data group runs a flat per-leaf config without VR, "
            "a downlink or participation (ROADMAP.md queue 1 item 12)")
    _check_topology(policy, cfg, _resolve_participation(policy, cfg), faults, state.vr, n)
    grads_in, coin = grads_local, False
    if state.vr is not None:
        vr_p = policy.vr_p if policy is not None else cfg.vr_p
        _vr_check(vr_p, vr_aux, params_local)
        mu_own = {p: m[0] for p, m in state.vr.mu.items()}
        grads_in = control_variate(grads_local, vr_aux[0], mu_own)
        coin = vr_coin(key, vr_p) or bool(vr_force_refresh)
        if part is not None:
            # the scheduled mask only, never the wire verdict (:1050-1058)
            coin = coin and part.m_own and part.ok
    if state.h_down is not None and down_key is None:
        raise ValueError("bidirectional aggregation needs down_key = fold_in(step_key, "
                         "DOWN_FOLD), folded before the worker fold")
    if policy is not None:
        ghat, new_hw, new_hs, new_h_down = _aggregate_grouped(grads_in, state, key, policy, n,
                                                              down_key, part)
    else:
        ghat, new_hw, new_hs, scale = _dispatch_round(grads_in, state, key, cfg, n, part,
                                                      faults, step,
                                                      defer=state.h_down is not None,
                                                      group=group)
    del grads_in
    new_vr = state.vr
    if state.vr is not None:
        # After the round (the values do not depend on the order): the
        # refreshed rows are not held across the round's transients.
        new_vr = refresh(state.vr, [coin], params_local,
                         {p: g.unsqueeze(0) for p, g in vr_aux[1].items()})
    if policy is None:
        new_h_down = state.h_down
        if state.h_down is not None:
            ghat, new_h_down = _frozen_downlink(
                part, state.h_down, ghat,
                lambda: downlink_round(ghat, state.h_down, down_key, cfg, scale=scale))
    telem = None
    if telemetry:
        telem = measure(policy, ghat, ok=None if part is None else part.ok)
    ghat = {p: ghat[p].to(grads_local[p].dtype) for p in ghat}
    new_state = DianaState(h_worker=new_hw, h_server=new_hs, vr=new_vr, h_down=new_h_down)
    if telemetry:
        return ghat, new_state, telem
    return ghat, new_state
