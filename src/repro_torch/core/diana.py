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

Trees are ``{path: tensor}`` dicts (:mod:`repro_torch.core.tree`); stacked
per-worker grads carry a leading worker axis on every leaf.  VR, the
downlink, policies, participation and the chunked/hierarchical schedules are
later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple

import torch

from . import prng
from . import tree as T
from .bucket import BucketLayout, bucketed_compressor
from .compression import CompressionConfig
from .compressors.base import Payload
from .numerics import fma32

__all__ = [
    "DOWN_FOLD", "GROUP_FOLD", "CHUNK_FOLD",
    "ReferenceState", "reference_init", "reference_step", "bucket_layout",
    "worker_key",
]

# The JAX package's fold constants (repro/core/diana.py:79-98): the downlink
# stream, per-group streams of grouped policies, and the chunked wire's
# in-kernel-PRNG chunk streams.  Kept here so later slices draw the same bits.
DOWN_FOLD = 0x444E  # 'DN'
GROUP_FOLD = 0x4750  # 'GP'
CHUNK_FOLD = 0x434B  # 'CK'


class ReferenceState(NamedTuple):
    h_worker: Any  # (n, Dp) bucketed, or {path: (n, d_leaf)} per leaf
    h_server: Any  # (Dp,) bucketed, or {path: (d_leaf,)} per leaf
    v: Any         # momentum buffer {path: f32 tensor shaped like the param}


def bucket_layout(cfg: CompressionConfig, tree: Mapping[str, torch.Tensor]) -> BucketLayout:
    """The flat-buffer layout of ``tree`` under ``cfg``'s operator."""
    return BucketLayout.for_tree(tree, align=cfg.make().bucket_align())


def reference_init(params: Mapping[str, torch.Tensor], cfg: CompressionConfig,
                   n_workers: int) -> ReferenceState:
    """``h_i^0 = 0``, ``h^0 = 0``, ``v^0 = 0`` (f32)."""
    dev = next(iter(params.values())).device
    v = {p: torch.zeros(x.shape, dtype=torch.float32, device=dev) for p, x in params.items()}
    if cfg.bucketed:
        dp = bucket_layout(cfg, params).padded_size
        return ReferenceState(
            h_worker=torch.zeros((n_workers, dp), dtype=torch.float32, device=dev),
            h_server=torch.zeros((dp,), dtype=torch.float32, device=dev), v=v)
    return ReferenceState(
        h_worker={p: torch.zeros((n_workers, x.numel()), dtype=torch.float32, device=dev)
                  for p, x in params.items()},
        h_server={p: torch.zeros((x.numel(),), dtype=torch.float32, device=dev)
                  for p, x in params.items()},
        v=v)


def worker_key(key: torch.Tensor, w: int) -> torch.Tensor:
    """The per-worker compression key ``fold_in(key, w)``."""
    return prng.fold_in(key, w)


def reference_step(grads_per_worker: Mapping[str, torch.Tensor], state: ReferenceState,
                   key: torch.Tensor, cfg: CompressionConfig, *, beta: float = 0.0):
    """Aggregate stacked per-worker grads ``{path: (n, *shape)}`` exactly as
    Algorithm 1; returns ``(v, new_state)`` with ``v = beta * v + ghat``."""
    agg = _reference_agg_bucketed if cfg.bucketed else _reference_agg_perleaf
    ghat, new_hw, new_hs = agg(grads_per_worker, state.h_worker, state.h_server, key, cfg)
    v = _reference_finish(ghat, state.v, beta)
    return v, ReferenceState(h_worker=new_hw, h_server=new_hs, v=v)


def _reference_finish(ghat: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor],
                      beta: float) -> Dict[str, torch.Tensor]:
    """Momentum accumulate ``v = beta * v + ghat`` as one FMA (XLA contracts
    it so for most leaves; beta = 0 makes the choice moot)."""
    return {p: fma32(beta, v[p], ghat[p]) for p in ghat}


def _reference_agg_perleaf(grads_per_worker, h_worker, h_server, key, cfg):
    """Per-leaf round: each worker encodes every leaf with its own key, the
    server runs one fused ``decode_sum_apply`` per leaf."""
    comp = cfg.make()
    paths = T.paths(grads_per_worker)
    n = grads_per_worker[paths[0]].shape[0]
    payloads = {p: [] for p in paths}
    new_hw = {p: [] for p in paths}
    for w in range(n):
        keys = prng.split(worker_key(key, w), len(paths))
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
        g_flat, new_hs[p] = comp.decode_sum_apply(Payload.stack(payloads[p]), n, d, h_server[p])
        ghat[p] = g_flat.reshape(grads_per_worker[p].shape[1:])
    return ghat, {p: torch.stack(rows) for p, rows in new_hw.items()}, new_hs


def _reference_agg_bucketed(grads_per_worker, h_worker, h_server, key, cfg):
    """Bucketed round: each worker ONE compress of the flattened model; ONE
    fused ``decode_sum_apply`` over the stacked payloads."""
    layout = bucket_layout(cfg, {p: g[0] for p, g in grads_per_worker.items()})
    comp = bucketed_compressor(cfg, layout)
    dp = layout.padded_size
    n = h_worker.shape[0]
    payloads, new_h = [], []
    for w in range(n):
        flat_g = layout.flatten({p: g[w] for p, g in grads_per_worker.items()})
        delta = comp.compress_input(flat_g, h_worker[w])
        pay = comp.compress(delta, worker_key(key, w))
        payloads.append(pay)
        new_h.append(comp.next_memory(h_worker[w], comp.decode(pay, dp), delta))
    ghat_flat, new_hs = comp.decode_sum_apply(Payload.stack(payloads), n, dp, h_server)
    # f32 leaves, like the per-leaf reference
    return layout.unflatten(ghat_flat, cast=False), torch.stack(new_h), new_hs
