"""Transformer building blocks: RMSNorm, RoPE, GQA attention (train and
prefill path, optionally sliding-window, and the cached single-token
decode over a KV cache or its ring buffer), the dense MLP variants (SwiGLU,
GELU, squared ReLU).  Plain tensor functions over ``{name: tensor}``
parameter dicts, in the JAX package's layouts (``repro.models.layers``):
activations (B, S, D), heads (B, S, H, Dh), weights (in, out).

Under a model group (:mod:`repro_torch.models.sharding`) the attention and
the MLP run tensor-parallel on the rank's shards, as the JAX package's
``shard`` annotations place them under GSPMD: ``wq`` / ``wk`` / ``wv`` /
``w_in`` / ``w_gate`` column-parallel (the rank's query and KV heads, its
slice of the hidden units), ``wo`` / ``w_out`` row-parallel, their outputs
all-reduced.  The head counts are read from the weights' widths, so the
same code runs a whole model or a shard of one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import torch.distributed as dist

from repro_torch.core import transport

from .sharding import copy_to_model, current_data, reduce_from_model

__all__ = ["wide", "rms_norm", "rope_freqs", "apply_rope", "sdpa", "causal_mask", "attention",
           "mlp", "AttnCache", "init_attn_cache", "DECODE_KV_CHUNK"]

DECODE_KV_CHUNK = 4096


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 (the JAX package's ``astype(jnp.float32)``), or float64
    when it is float64: a float64 model, the accuracy reference, keeps
    float64 throughout."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = wide(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * wide(scale)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), positions (B, S): rotate-half (contiguous halves)."""
    dh = x.shape[-1]
    angles = positions[..., None].float() * rope_freqs(dh, theta, x.device)
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    xf = wide(x)
    x1, x2 = xf[..., : dh // 2], xf[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sdpa(q, k, v, mask, compute_dtype):
    """q (B,Sq,H,Dh), k/v (B,Sk,Hkv,Dh), mask (Sq,Sk) bool.

    Mirrors ``repro.models.layers._sdpa``: q is scaled in f32 and rounded to
    the kv dtype, the KV heads repeat to H, and both products take the
    (bf16-rounded) operands in f32 — the f32 accumulation JAX asks for with
    ``preferred_element_type``.  Masked scores are -1e30; softmax in f32."""
    h, hkv, dh = q.shape[2], k.shape[2], q.shape[-1]
    rep = h // hkv
    qs = (wide(q) / math.sqrt(dh)).to(k.dtype)
    kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    scores = torch.einsum("bqhd,bkhd->bhqk", wide(qs), wide(kr))
    scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=scores.dtype,
                                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", wide(probs.to(vr.dtype)), wide(vr))
    return out.to(compute_dtype)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window=None) -> torch.Tensor:
    """(Sq, Sk) bool: key at or before the query, and within ``window``
    positions of it when a sliding window is set."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _sdpa_qchunked(q, k, v, compute_dtype, chunk: int, window=None):
    """Causal attention over query chunks (full keys per chunk), each chunk
    recomputed in the backward so only one chunk's (B, H, cq, S) scores live
    (without autograd, as in a prefill, the chunks just run in turn)."""
    s = q.shape[1]
    idx_k = torch.arange(s, device=q.device)

    def one(qc, start):
        q_pos = start + torch.arange(qc.shape[1], device=q.device)
        return sdpa(qc, k, v, causal_mask(q_pos, idx_k, window), compute_dtype)

    if not torch.is_grad_enabled():
        return torch.cat([one(q[:, i:i + chunk], i) for i in range(0, s, chunk)], dim=1)
    outs = [checkpoint(one, q[:, i:i + chunk], i, use_reentrant=False)
            for i in range(0, s, chunk)]
    return torch.cat(outs, dim=1)


class AttnCache(NamedTuple):
    """A KV cache (``repro.models.layers.AttnCache``), written in place by
    the decode.  The sliding window is not stored: pass the same ``window=``
    to :func:`attention` as to :func:`init_attn_cache`.  A bf16 cache is
    held as bf16 (the JAX package stores its bits as uint16, a workaround
    for XLA's CPU backend)."""

    k: torch.Tensor       # (B, S_cache, Hkv, Dh); S_cache = max_len, or the window
    v: torch.Tensor
    pos: torch.Tensor     # () int32 on the cache's device: the next token's position


def init_attn_cache(cfg, batch: int, max_len: int, dtype, window: Optional[int] = None,
                    device=None) -> AttnCache:
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    w = int(window or 0)
    s_cache = min(max_len, w) if w else max_len
    return AttnCache(k=torch.zeros((batch, s_cache, hkv, dh), dtype=dtype, device=device),
                     v=torch.zeros((batch, s_cache, hkv, dh), dtype=dtype, device=device),
                     pos=torch.zeros((), dtype=torch.int32, device=device))


def _decode_attention(q, k_cache, v_cache, valid, compute_dtype):
    """Flash-decoding (``_decode_attention``): one query token (B, 1, H, Dh)
    against the cache, in chunks of :data:`DECODE_KV_CHUNK` rows (one chunk
    when that does not divide the cache) combined by their running
    (max, numerator, denominator).

    The JAX package's roundings: q scaled in f32 and rounded to the compute
    dtype; the scores summed in f32 from the (bf16) operands, the invalid
    rows -1e30; ``e = exp(s - m)`` rounded to the value dtype for the second
    product while the denominator sums it unrounded; the chunks combine
    through ``exp(m_c - max m)`` and the output is ``num / max(den,
    1e-30)``.  Only one chunk of K and V is widened at a time: widening the
    whole cache would hold it twice over in f32.

    With the cache's rows split over the serving data group (``split =
    "seq"``), the chunks' largest score is all-reduced (MAX) before the
    rescale and the rescaled numerators and denominators summed across the
    ranks (one all-reduce of both), each tagged ``"seq"``."""
    b, _, h, dh = q.shape
    s_cache, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    ck = min(DECODE_KV_CHUNK, s_cache)
    if s_cache % ck:
        ck = s_cache
    qg = wide((wide(q) / math.sqrt(dh)).to(compute_dtype)).reshape(b, hkv, rep, dh)
    neg = torch.tensor(-1e30, dtype=qg.dtype, device=q.device)
    ms, nums, dens = [], [], []
    for c0 in range(0, s_cache, ck):
        kc, vc = k_cache[:, c0:c0 + ck], v_cache[:, c0:c0 + ck]
        s = torch.einsum("bgrd,bkgd->bgrk", qg, wide(kc))
        s = torch.where(valid[c0:c0 + ck], s, neg)
        m = torch.amax(s, dim=-1, keepdim=True)                   # (B,g,r,1)
        e = torch.exp(s - m)
        nums.append(torch.einsum("bgrk,bkgd->bgrd", wide(e.to(vc.dtype)), wide(vc)))
        dens.append(torch.sum(e, dim=-1))
        ms.append(m[..., 0])
    ms = torch.stack(ms)                                          # (nk,B,g,r)
    top = torch.amax(ms, dim=0, keepdim=True)
    dg = _seq_group()
    if dg is not None:
        transport.all_reduce(top, op=dist.ReduceOp.MAX, group=dg.group, tag="seq")
    scale = torch.exp(ms - top)
    num = torch.sum(torch.stack(nums) * scale[..., None], dim=0)
    den = torch.sum(torch.stack(dens) * scale, dim=0)
    if dg is not None:
        both = torch.cat([num, den[..., None]], dim=-1)
        transport.all_reduce(both, group=dg.group, tag="seq")
        num, den = both[..., :-1], both[..., -1]
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(b, 1, h, dh).to(compute_dtype)


def _seq_group():
    """The serving data group when it splits the caches' rows, else None."""
    dg = current_data()
    return dg if dg is not None and dg.split == "seq" else None


def _decode_update(cache: AttnCache, k, v, window):
    """Write the new token's K / V (B, 1, Hkv, Dh) into their slot, in
    place, and return which cache rows hold a position at or before it.

    Without a window the slot is ``pos``; with one it is ``pos % w`` and the
    cache is a ring buffer: row ``j`` holds position ``pos - ((slot - j) mod
    w)`` (floor modulo), valid once that is >= 0.  ``pos`` stays on the
    device, so no step waits for the host.

    With the rows split over the serving data group, this rank holds global
    rows ``[r n, (r+1) n)`` of its ``n``: the owner of the slot writes the
    new K / V, every other rank writes its row back unchanged, and ``j`` is
    the global row."""
    w = int(window or 0)
    slot = torch.remainder(cache.pos, w) if w else cache.pos
    n = cache.k.shape[1]
    dg = _seq_group()
    first = 0 if dg is None else dg.index * n
    if dg is None:
        idx = slot.reshape(1).long()
    else:
        local = slot - first
        own = (local >= 0) & (local < n)
        idx = torch.clamp(local, 0, n - 1).reshape(1).long()
        k = torch.where(own, k.to(cache.k.dtype), cache.k.index_select(1, idx))
        v = torch.where(own, v.to(cache.v.dtype), cache.v.index_select(1, idx))
    cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
    cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
    rows = first + torch.arange(n, device=cache.k.device)
    if w:
        return cache.pos - torch.remainder(slot - rows, w) >= 0
    return rows <= cache.pos


def attention(p, x: torch.Tensor, cfg, positions: torch.Tensor, window=None,
              cache: Optional[AttnCache] = None) -> torch.Tensor:
    """Causal self-attention, masked to a sliding ``window`` when one is
    given.  ``p`` holds wq, wk, wv, wo.

    ``cache=None``: over the whole of ``x`` (the train and prefill path).
    Otherwise ``x`` is one new token per sequence (S = 1): its K and V go
    into the cache in place (the ring buffer with a window) and it attends
    to every valid row of the cache (the decode path); the caller advances
    ``cache.pos``.  Under a model group both paths all-reduce the output
    after the row-parallel ``wo``."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    # the heads this rank holds (all of them without a model group)
    h, hkv = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    cdt = cfg.compute_dtype
    x = copy_to_model(x)
    q = (x @ p["wq"].to(cdt)).reshape(b, s, h, dh)
    k = (x @ p["wk"].to(cdt)).reshape(b, s, hkv, dh)
    v = (x @ p["wv"].to(cdt)).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        if s != 1:
            raise ValueError(f"the decode path takes one new token per sequence, not {s}")
        valid = _decode_update(cache, k, v, window)
        out = _decode_attention(q, cache.k, cache.v, valid, cdt)
        return reduce_from_model(out.reshape(b, s, h * dh) @ p["wo"].to(cdt))
    cq = max(int(cfg.attn_q_chunk or 0), 0)
    if cq and s > cq and s % cq == 0:
        out = _sdpa_qchunked(q, k, v, cdt, cq, window)
    else:
        idx = torch.arange(s, device=x.device)
        out = sdpa(q, k, v, causal_mask(idx, idx, window), cdt)
    return reduce_from_model(out.reshape(b, s, h * dh) @ p["wo"].to(cdt))


def mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """``act(x @ w_in) @ w_out``: SwiGLU ``silu(x @ w_gate) * (x @ w_in)``,
    GELU (``jax.nn.gelu``'s default, the tanh approximation) or Nemotron's
    squared ReLU; only SwiGLU has a ``w_gate`` leaf."""
    cdt = cfg.compute_dtype
    x = copy_to_model(x)
    h = x @ p["w_in"].to(cdt)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(cdt)) * h
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.act == "relu2":
        r = F.relu(h)
        h = r * r
    else:
        raise ValueError(f"unknown activation {cfg.act}")
    return reduce_from_model(h @ p["w_out"].to(cdt))
