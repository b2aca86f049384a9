"""Transformer building blocks: RMSNorm, RoPE, GQA attention (train path,
optionally sliding-window), the dense MLP variants (SwiGLU, GELU, squared
ReLU).  Plain tensor functions over ``{name: tensor}`` parameter
dicts, in the JAX package's layouts (``repro.models.layers``): activations
(B, S, D), heads (B, S, H, Dh), weights (in, out).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["wide", "rms_norm", "rope_freqs", "apply_rope", "sdpa", "causal_mask", "attention", "mlp"]


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
    recomputed in the backward so only one chunk's (B, H, cq, S) scores live."""
    s = q.shape[1]
    idx_k = torch.arange(s, device=q.device)

    def one(qc, start):
        q_pos = start + torch.arange(qc.shape[1], device=q.device)
        return sdpa(qc, k, v, causal_mask(q_pos, idx_k, window), compute_dtype)

    outs = [checkpoint(one, q[:, i:i + chunk], i, use_reentrant=False)
            for i in range(0, s, chunk)]
    return torch.cat(outs, dim=1)


def attention(p, x: torch.Tensor, cfg, positions: torch.Tensor, window=None) -> torch.Tensor:
    """Causal self-attention (the train path), masked to a sliding
    ``window`` when one is given.  ``p`` holds wq, wk, wv, wo."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = cfg.compute_dtype
    q = (x @ p["wq"].to(cdt)).reshape(b, s, h, dh)
    k = (x @ p["wk"].to(cdt)).reshape(b, s, hkv, dh)
    v = (x @ p["wv"].to(cdt)).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cq = max(int(cfg.attn_q_chunk or 0), 0)
    if cq and s > cq and s % cq == 0:
        out = _sdpa_qchunked(q, k, v, cdt, cq, window)
    else:
        idx = torch.arange(s, device=x.device)
        out = sdpa(q, k, v, causal_mask(idx, idx, window), cdt)
    return out.reshape(b, s, h * dh) @ p["wo"].to(cdt)


def mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """``act(x @ w_in) @ w_out``: SwiGLU ``silu(x @ w_gate) * (x @ w_in)``,
    GELU (``jax.nn.gelu``'s default, the tanh approximation) or Nemotron's
    squared ReLU; only SwiGLU has a ``w_gate`` leaf."""
    cdt = cfg.compute_dtype
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
    return h @ p["w_out"].to(cdt)
