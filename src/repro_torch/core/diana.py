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

Trees are ``{path: tensor}`` dicts (:mod:`repro_torch.core.tree`); stacked
per-worker grads carry a leading worker axis on every leaf.  The
chunked/hierarchical schedules are a later slice (ROADMAP.md queue 1 item
6).
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

from . import prng
from . import tree as T
from .bucket import (BucketLayout, add_checksum, bucketed_compressor, fuse_payload,
                     payload_recipe, unfuse_payload, verify_checksum, wire_roundtrip)
from .compression import CompressionConfig
from .compressors.base import Payload
from .numerics import div_n, fma32
from .participation import (PART_FOLD, ParticipationSpec, apply_faults, direction_scale,
                            step_ctx)
from .policy import CompressionPolicy, partition_for
from .vr import control_variate, init_vr, reference_coins, refresh, vr_coin

__all__ = [
    "DOWN_FOLD", "GROUP_FOLD", "CHUNK_FOLD", "PART_FOLD",
    "ReferenceState", "reference_init", "reference_step", "bucket_layout",
    "worker_key", "DianaState", "init_state", "init_downlink", "downlink_round",
    "aggregate_distributed",
]

# The JAX package's fold constants (repro/core/diana.py:79-98): the downlink
# stream, per-group streams of grouped policies (folded after the worker
# fold, and never by a uniform policy), and the chunked wire's
# in-kernel-PRNG chunk streams (a later slice).
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
                        m_eff: torch.Tensor, inplace: bool = False):
    """The sampled-sum server tail on ONE flat f32 buffer (``:167``):
    ``ghat = server_direction(h, total * scale)`` with the rescale of the
    effective set ``m_eff`` (as the jitted reference rounds it,
    :meth:`~repro_torch.core.compressors.base.Compressor.scaled_direction`),
    ``h_server`` advanced with the unrescaled ``total / n``, both frozen
    (``ghat = 0``) on a degraded step.  ``inplace`` lets a memoryless
    operator scale ``total`` in place (the in-turn trainer's buffer; the
    same bits)."""
    if not part.ok:
        return torch.zeros_like(h_f), h_f
    scale = float(direction_scale(part.spec, m_eff, part.ok))
    if not comp.carries_state:
        return comp.server_direction(h_f, total.mul_(scale) if inplace else total * scale), h_f
    return (comp.scaled_direction(h_f, total, scale),
            comp.next_server_memory(h_f, div_n(total, n)))


def _wire_exchange(payload: Payload, faults, step: int, widx: int):
    """One worker's payload on the checksummed wire (``:675-681``): fused
    into one uint8 buffer, the checksum appended, this worker's scheduled
    faults injected.  Returns ``(wire, fused shape, recipe)``."""
    buf = fuse_payload(payload)
    wire = apply_faults(add_checksum(buf), faults, step, widx)
    return wire, tuple(buf.shape), payload_recipe(payload)


def reference_step(grads_per_worker: Mapping[str, torch.Tensor], state: ReferenceState,
                   key: torch.Tensor, cfg, *, beta: float = 0.0,
                   vr_aux=None, params=None, vr_force_refresh: bool = False,
                   step: Optional[int] = None, faults=None):
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
    configs only) puts each worker's payload on the checksummed wire."""
    n = next(iter(grads_per_worker.values())).shape[0]
    part = step_part(cfg, faults, prng.fold_in(key, PART_FOLD), n, step)
    policy, cfg = _split_spec(cfg)
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
        if cfg.bucketed:
            ghat, new_hw, new_hs = _reference_agg_bucketed(
                grads_per_worker, state.h_worker, state.h_server, key, cfg, part=part,
                faults=faults, step=step)
        else:
            ghat, new_hw, new_hs = _reference_agg_perleaf(
                grads_per_worker, state.h_worker, state.h_server, key, cfg, part=part)
        new_h_down = None
        if state.h_down is not None:
            # _reference_finish's downlink (:1605-1626): the distributed path's
            # downlink_round and key, its memory in f32
            ghat, new_h_down = _frozen_downlink(
                part, state.h_down, ghat,
                lambda: downlink_round(ghat, state.h_down, prng.fold_in(key, DOWN_FOLD), cfg,
                                       h_dtype=torch.float32))
    # The momentum accumulate as one FMA: XLA contracts it so for most
    # leaves (beta = 0 makes the choice moot).
    v = {p: fma32(beta, state.v[p], ghat[p]) for p in ghat}
    return v, ReferenceState(h_worker=new_hw, h_server=new_hs, v=v, vr=new_vr,
                             h_down=new_h_down)


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
            ghat_g, new_hw[gname], new_hs[gname] = _reference_agg_bucketed(
                grads, hw, hs, key, cfg_g, gfold=GROUP_FOLD + g, part=part)
        else:
            ghat_g, hw_d, hs_d = _reference_agg_perleaf(
                grads, dict(zip(paths, hw)), dict(zip(paths, hs)), key, cfg_g,
                gfold=GROUP_FOLD + g, part=part)
            new_hw[gname], new_hs[gname] = [hw_d[p] for p in paths], [hs_d[p] for p in paths]
        if dcfg is not None:
            dkey = prng.fold_in(prng.fold_in(key, DOWN_FOLD), GROUP_FOLD + g)
            ghat_g, new_hd[gname] = _frozen_downlink(
                part, state.h_down[gname], ghat_g,
                lambda: _group_downlink(ghat_g, state.h_down[gname], dkey, cfg_g, dcfg,
                                        torch.float32))
        ghat.append(ghat_g)
    return groups.merge(ghat), new_hw, new_hs, (new_hd or None)


def _group_downlink(ghat_g, h_down_g, down_key, cfg_g, dcfg, h_dtype):
    """A group's downlink round; a grouped state's per-leaf downlink memory
    is a list in the group's leaf order (a flat state's, a dict)."""
    if dcfg.bucketed or isinstance(h_down_g, Mapping):
        return downlink_round(ghat_g, h_down_g, down_key, cfg_g, h_dtype=h_dtype, dcfg=dcfg)
    out, new_h = downlink_round(ghat_g, dict(zip(T.paths(ghat_g), h_down_g)), down_key, cfg_g,
                                h_dtype=h_dtype, dcfg=dcfg)
    return out, [new_h[p] for p in T.paths(ghat_g)]


# ---------------------------------------------------------------------------
# Downlink: the compressed server broadcast
# ---------------------------------------------------------------------------

def downlink_round(ghat: Mapping[str, torch.Tensor], h_down, down_key: torch.Tensor,
                   cfg: CompressionConfig, *, h_dtype=None,
                   dcfg: Optional[CompressionConfig] = None):
    """Pass the aggregated direction ``ghat`` (f32 leaves) through the
    DOWNLINK operator (``repro/core/diana.py:802-888``): the server encodes
    ``delta = compress_input(ghat, h_down)``, every receiver decodes the
    payload, takes ``server_direction(h_down, dhat)`` and advances the
    shared memory with ``next_memory``.  ``ghat``, ``h_down`` and
    ``down_key`` are the same on every worker, so the broadcast needs no
    collective: each rank runs the same replicated round.

    The layout is the downlink's own (``cfg.down_config().bucketed``): ONE
    compress of the flat buffer keyed ``down_key``, its payload through
    :func:`~repro_torch.core.bucket.wire_roundtrip`; or per leaf, leaf ``i``
    keyed ``split(down_key, n_leaves)[i]``, payloads unfused.  ``down_key``
    is the step key folded with :data:`DOWN_FOLD` before any worker fold.

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
        delta = comp.compress_input_(layout.flatten(ghat), h)
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
        delta = comp.compress_input(g, h)
        dhat = comp.decode(comp.compress(delta, k), g.numel())
        ghat_hat[p] = comp.server_direction(h, dhat).reshape(ghat[p].shape).to(ghat[p].dtype)
        new_h[p] = comp.next_memory(h, dhat, delta).to(h_dtype)
    return ghat_hat, new_h


def _reference_agg_perleaf(grads_per_worker, h_worker, h_server, key, cfg, gfold=None,
                           part=None):
    """Per-leaf round: each worker encodes every leaf with its own key
    (``split(_worker_key(key, w, gfold), n_leaves)``), the server runs one
    fused ``decode_sum_apply`` per leaf.  With a participation context
    (``:1526-1600``): rejoining rows reset first, the stacked rows masked
    before ``decode_sum``, :func:`_masked_server_tail`, and only the
    :func:`_participant_gate` rows advance."""
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
    ghat, new_hs = {}, {}
    for p in paths:
        d = grads_per_worker[p].shape[1:].numel()
        stacked = Payload.stack(payloads[p])
        if part is None:
            g_flat, new_hs[p] = comp.decode_sum_apply(stacked, n, d, h_server[p])
        else:
            g_flat, new_hs[p] = _masked_server_tail(
                comp, h_server[p].float(), comp.decode_sum(stacked.mask_workers(part.mask), n, d),
                n, part, part.mask)
        ghat[p] = g_flat.reshape(grads_per_worker[p].shape[1:])
    new_hw = {p: torch.stack(rows) for p, rows in new_hw.items()}
    if part is not None:
        new_hw = _where_rows(_participant_gate(part), new_hw, h_worker)
    return ghat, new_hw, new_hs


def _reference_agg_bucketed(grads_per_worker, h_worker, h_server, key, cfg, gfold=None,
                            part=None, faults=None, step=None):
    """Bucketed round: each worker ONE compress of the flattened model (or
    policy group) keyed ``_worker_key(key, w, gfold)``; ONE fused
    ``decode_sum_apply`` over the stacked payloads.  With a participation
    context (``:1629-1760``, one chunk) the masked ``decode_sum`` and
    :func:`_masked_server_tail` instead; with ``faults`` each worker's
    payload crosses the checksummed wire first (:func:`_wire_exchange`),
    and the payloads that fail verification are excluded like
    non-participants, their bytes decoded as received."""
    layout = bucket_layout(cfg, {p: g[0] for p, g in grads_per_worker.items()})
    comp = bucketed_compressor(cfg, layout)
    dp = layout.padded_size
    n = h_worker.shape[0]
    if part is not None:
        h_worker = _reinit_zero(part.reinit, h_worker)
    payloads, new_h = [], []
    for w in range(n):
        flat_g = layout.flatten({p: g[w] for p, g in grads_per_worker.items()})
        delta = comp.compress_input(flat_g, h_worker[w])
        pay = comp.compress(delta, _worker_key(key, w, gfold))
        payloads.append(pay)
        new_h.append(comp.next_memory(h_worker[w], comp.decode(pay, dp), delta))
    if part is None:
        ghat_flat, new_hs = comp.decode_sum_apply(Payload.stack(payloads), n, dp, h_server)
        # f32 leaves, like the per-leaf reference
        return layout.unflatten(ghat_flat, cast=False), torch.stack(new_h), new_hs
    valid = None
    if faults is not None:
        # the receivers' view: every worker's wire, verified after the gather
        wires = [_wire_exchange(pay, faults, step, w) for w, pay in enumerate(payloads)]
        flat, valid = verify_checksum(torch.stack([wire for wire, _, _ in wires]))
        _, shape, recipe = wires[0]
        gathered = unfuse_payload(flat.reshape(n, *shape), recipe)
    else:
        gathered = Payload.stack(payloads)
    m_eff = part.mask if valid is None else part.mask & valid
    total = comp.decode_sum(gathered.mask_workers(m_eff), n, dp)
    ghat_flat, new_hs = _masked_server_tail(comp, h_server.float(), total, n, part, m_eff)
    new_h = _where_rows(_participant_gate(part, valid), torch.stack(new_h), h_worker)
    return layout.unflatten(ghat_flat, cast=False), new_h, new_hs


# ---------------------------------------------------------------------------
# Distributed aggregation (one worker per torch.distributed rank)
# ---------------------------------------------------------------------------

def _gather_field(a: torch.Tensor, n: int) -> torch.Tensor:
    """All-gather ONE payload field over the ranks: ``(n, *a.shape)`` in rank
    order (``repro/core/diana.py:311``, no groups).

    The field travels as its bytes (``view(torch.uint8)``, exact), ``(lead,
    W)``, into ONE preallocated ``(n * lead, W)`` buffer viewed as ``(n,
    lead, W)``: every dtype of the wire format (uint16/uint32 indices, int16
    codes) crosses gloo and NCCL alike."""
    src = a.contiguous().view(torch.uint8).reshape(a.shape[0], -1)
    out = torch.empty((n * src.shape[0], src.shape[1]), dtype=torch.uint8, device=src.device)
    dist.all_gather_into_tensor(out, src)
    return out.view(n, *src.shape).view(a.dtype).reshape(n, *a.shape)


def _gather_payloads(payloads: Mapping[str, Payload], n: int):
    """All-gather every field of every per-leaf payload (one collective per
    field per leaf, ``:336``)."""
    return {p: Payload(*(None if f is None else _gather_field(f, n) for f in pay))
            for p, pay in payloads.items()}


def _gathered_sum(payloads, like, n: int, comp):
    """``sum_i decode(payload_i)`` per leaf: the gathered payloads through
    the operator's ``decode_sum`` (``:347``)."""
    gathered = _gather_payloads(payloads, n)
    return {p: comp.decode_sum(gathered[p], n, like[p].numel()) for p in payloads}


def _gathered_mean(payloads, like, n: int, comp):
    """``mean_i decode(payload_i)``, shaped and typed like ``like`` (``:372``)."""
    return {p: div_n(t, n).reshape(like[p].shape).to(like[p].dtype)
            for p, t in _gathered_sum(payloads, like, n, comp).items()}


def _gather_fused(payload: Payload, n: int) -> Payload:
    """All-gather ONE fused uint8 buffer instead of one collective per field
    (``:474``): the populated fields byte-cast into one ``(lead, W)``
    buffer (:func:`~repro_torch.core.bucket.fuse_payload`), gathered once,
    split back locally.  One populated field is gathered as itself: it
    already is one collective, and the fuse would only copy it."""
    populated = [i for i, f in enumerate(payload) if f is not None]
    if len(populated) == 1:
        fields = [None] * len(Payload._fields)
        fields[populated[0]] = _gather_field(payload[populated[0]], n)
        return Payload(*fields)
    return unfuse_payload(_gather_field(fuse_payload(payload), n), payload_recipe(payload))


def _aggregate_local(grads_local, h_worker, h_server, key, cfg, n, part=None):
    """The per-leaf Algorithm-1 round on this rank's leaves (``:381``): leaf
    ``i`` encodes with ``split(key, n_leaves)[i]``, each payload field is
    gathered on its own, and the server side is ``_gathered_mean``, then
    ``next_server_memory`` and ``server_direction`` (not the fused
    ``decode_sum_apply``), as the JAX package composes it.  ``ghat`` comes
    back f32, shaped like the grads.  With a participation context the
    masked sum and :func:`_masked_server_tail`; the rank's row advances
    only if it participates on a non-degraded step."""
    comp = cfg.make()
    paths = T.paths(grads_local)
    g_flat = {p: grads_local[p].reshape(-1).float() for p in paths}
    h_local = {p: h_worker[p][0].float() for p in paths}
    if part is not None:
        h_local = _reinit_zero(part.reinit_own, h_local)
    delta = {p: comp.compress_input(g_flat[p], h_local[p]) for p in paths}
    keys = prng.split(key, len(paths))
    payloads = {p: comp.compress(delta[p], k) for p, k in zip(paths, keys)}
    if part is not None:
        return _aggregate_local_masked(grads_local, g_flat, h_local, delta, payloads, h_server,
                                       comp, cfg, n, part)
    dhat_mean = _gathered_mean(payloads, g_flat, n, comp)
    ghat, new_hw, new_hs = {}, {}, {}
    for p in paths:
        # The rank's own estimate, decoded from its payload (bitwise the
        # transmitted value); memoryless rules ignore it (XLA drops the decode).
        if comp.carries_state:
            dhat_own = comp.decode(payloads[p], g_flat[p].numel())
            new_hw[p] = comp.next_memory(h_local[p], dhat_own, delta[p]).to(cfg.h_dtype)[None]
        else:
            new_hw[p] = h_worker[p]
        hs = h_server[p].float()
        new_hs[p] = comp.next_server_memory(hs, dhat_mean[p]).to(cfg.h_dtype)
        ghat[p] = comp.server_direction(hs, dhat_mean[p]).reshape(grads_local[p].shape)
    return ghat, new_hw, new_hs


def _aggregate_local_masked(grads_local, g_flat, h_local, delta, payloads, h_server, comp,
                            cfg, n, part):
    """:func:`_aggregate_local`'s sampled sum (``:446-470``): per-leaf
    payloads carry no checksum, so the effective set is the scheduled
    mask."""
    gathered = _gather_payloads(payloads, n)
    advance = part.m_own and part.ok
    ghat, new_hw, new_hs = {}, {}, {}
    for p in T.paths(grads_local):
        total = comp.decode_sum(gathered.pop(p).mask_workers(part.mask), n, g_flat[p].numel())
        g, hs = _masked_server_tail(comp, h_server[p].float(), total, n, part, part.mask)
        ghat[p] = g.reshape(grads_local[p].shape)
        new_hs[p] = hs.to(cfg.h_dtype)
        h = h_local[p]
        if comp.carries_state and advance:
            h = comp.next_memory(h, comp.decode(payloads[p], g_flat[p].numel()), delta[p])
        new_hw[p] = h.to(cfg.h_dtype)[None]
    return ghat, new_hw, new_hs


def _aggregate_bucketed(grads_local, h_worker, h_server, key, cfg, n, part=None, faults=None,
                        step=None):
    """Algorithm-1 round on the WHOLE model as one flat buffer (``:589``, one
    chunk): ONE compress with the rank's key, its own decode for
    ``next_memory`` on the rank's ``(1, Dp)`` row, ONE fused all-gather, ONE
    ``decode_sum_apply`` over the ``n`` gathered rows, replicated on every
    rank.  ``ghat`` comes back f32.  With a participation context the masked
    round (:func:`_aggregate_bucketed_masked`)."""
    layout = bucket_layout(cfg, grads_local)
    comp = bucketed_compressor(cfg, layout)
    dp = layout.padded_size
    h_local = h_worker[0].float()
    if part is not None:
        h_local = _reinit_zero(part.reinit_own, h_local)
    delta = comp.compress_input(layout.flatten(grads_local), h_local)
    payload = comp.compress(delta, key)
    if part is not None:
        return _aggregate_bucketed_masked(layout, comp, h_local, delta, payload, h_server, cfg,
                                          n, part, faults, step)
    # The memory update before the gather, so that the own decode and the
    # input are freed before the server tail allocates (the values are the
    # same in either order).
    if comp.carries_state:
        new_hw = comp.next_memory(h_local, comp.decode(payload, dp), delta).to(cfg.h_dtype)[None]
    else:
        new_hw = h_worker
    del delta
    gathered = _gather_fused(payload, n)    # ONE collective
    del payload
    ghat_flat, new_hs = comp.decode_sum_apply(gathered, n, dp, h_server.float())
    return layout.unflatten(ghat_flat, cast=False), new_hw, new_hs.to(cfg.h_dtype)


def _aggregate_bucketed_masked(layout, comp, h_local, delta, payload, h_server, cfg, n, part,
                               faults, step):
    """The bucketed sampled-sum round (``:653-691``): with ``faults`` the
    fused payload crosses the checksummed wire (:func:`_wire_exchange`, ONE
    all-gather of the wires) and every rank verifies every wire; the
    effective set is the scheduled mask AND the verdicts, and the rank's
    row advances only if it participates, the step is not degraded and its
    own wire verified (the verdict is the same on every rank)."""
    dp = layout.padded_size
    new_h = h_local
    if comp.carries_state:
        new_h = comp.next_memory(h_local, comp.decode(payload, dp), delta)
    del delta
    valid = None
    if faults is not None:
        wire, shape, recipe = _wire_exchange(payload, faults, step, part.widx)
        flat, valid = verify_checksum(_gather_field(wire, n))
        gathered = unfuse_payload(flat.reshape(n, *shape), recipe)
        del wire, flat
    else:
        gathered = _gather_fused(payload, n)
    del payload
    m_eff = part.mask if valid is None else part.mask & valid
    total = comp.decode_sum(gathered.mask_workers(m_eff), n, dp)
    del gathered
    ghat_flat, new_hs = _masked_server_tail(comp, h_server.float(), total, n, part, m_eff)
    gate = part.m_own and part.ok and (valid is None or bool(valid[part.widx]))
    new_hw = (new_h if gate else h_local).to(cfg.h_dtype)[None]
    return layout.unflatten(ghat_flat, cast=False), new_hw, new_hs.to(cfg.h_dtype)


def _allreduce_mean(grads_local, cfg, n):
    """Identity's round (``prefers_allreduce``, ``:1206-1214``): the
    gathered mean IS an all-reduce.  f32, as every other round: ONE
    ``all_reduce(SUM)`` of the flat buffer in the bucketed layout, one per
    leaf in the per-leaf layout, then ``div_n``.  The sum's order is the
    backend's (gloo's, NCCL's), as the JAX package's ``pmean`` is XLA's."""
    if cfg.bucketed:
        layout = bucket_layout(cfg, grads_local)
        flat = layout.flatten(grads_local)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return layout.unflatten(div_n(flat, n), cast=False)
    out = {}
    for p, g in grads_local.items():
        s = g.to(torch.float32, copy=True)
        dist.all_reduce(s, op=dist.ReduceOp.SUM)
        out[p] = div_n(s, n)
    return out


def _dispatch_round(grads_local, state, key, cfg, n, part=None, faults=None, step=None):
    """Route the gradient tree through the layout's round (``:1198``);
    returns ``(ghat, new_hw, new_hs)``.  The per-leaf layout is
    ``_perleaf_round``'s local branch (``:1242-1251``): its nested
    fully-manual shard_map, where each inner device encodes its own shard of
    every leaf, is a GSPMD specialisation with no ``torch.distributed``
    counterpart, since a rank holds whole leaves.  Under participation
    identity is gathered and summed like every operator (``:1208``)."""
    if cfg.make().prefers_allreduce and part is None:
        return _allreduce_mean(grads_local, cfg, n), state.h_worker, state.h_server
    if cfg.bucketed:
        return _aggregate_bucketed(grads_local, state.h_worker, state.h_server, key, cfg, n,
                                   part, faults, step)
    return _aggregate_local(grads_local, state.h_worker, state.h_server, key, cfg, n, part)


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
        if cfg_g.make().prefers_allreduce and part is None:
            ghat_g = _allreduce_mean(grads, cfg_g, n)
        elif cfg_g.bucketed:
            ghat_g, hw, hs = _aggregate_bucketed(grads, hw, hs, gkey, cfg_g, n, part)
        else:
            ghat_g, hw_d, hs_d = _aggregate_local(grads, dict(zip(paths, hw)),
                                                  dict(zip(paths, hs)), gkey, cfg_g, n, part)
            hw, hs = [hw_d[p] for p in paths], [hs_d[p] for p in paths]
        if dcfg is not None:
            dkey = prng.fold_in(down_key, GROUP_FOLD + g)
            ghat_g, new_hd[gname] = _frozen_downlink(
                part, state.h_down[gname], ghat_g,
                lambda: _group_downlink(ghat_g, state.h_down[gname], dkey, cfg_g, dcfg,
                                        policy.h_dtype))
        ghat.append(ghat_g)
        new_hw[gname], new_hs[gname] = hw, hs
    return groups.merge(ghat), new_hw, new_hs, (new_hd or None)


def aggregate_distributed(grads_local: Mapping[str, torch.Tensor], state: DianaState,
                          key: torch.Tensor, cfg, *, vr_aux=None,
                          params_local=None, vr_force_refresh: bool = False,
                          down_key: Optional[torch.Tensor] = None,
                          part_key: Optional[torch.Tensor] = None, step: Optional[int] = None,
                          faults=None):
    """One DIANA aggregation round across the ranks of the default process
    group, one worker per rank — the port of
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

    Returns ``(ghat, new_state)``: ``ghat`` equal on every rank, cast back to
    the gradients' dtypes (``:1102``).  The chunked wire is a later slice."""
    n = dist.get_world_size()
    part = step_part(cfg, faults, part_key, n, step, dist.get_rank())
    policy, cfg = _split_spec(cfg)
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
        ghat, new_hw, new_hs = _dispatch_round(grads_in, state, key, cfg, n, part, faults, step)
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
                part, state.h_down, ghat, lambda: downlink_round(ghat, state.h_down, down_key, cfg))
    ghat = {p: ghat[p].to(grads_local[p].dtype) for p in ghat}
    return ghat, DianaState(h_worker=new_hw, h_server=new_hs, vr=new_vr, h_down=new_h_down)
