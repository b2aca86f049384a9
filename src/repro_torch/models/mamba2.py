"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer: the
train/prefill path of ``repro.models.mamba2.mamba_layer`` (``cache=None``).

The input projection splits into the gate ``z``, the inputs ``x``, the
projections ``B`` / ``C`` and the step ``dt``; ``x``, ``B`` and ``C`` pass a
causal depthwise convolution with SiLU; ``dt = softplus(dt + dt_bias)``
discretises ``A = -exp(A_log)``; the chunked SSD runs in f32 (the quadratic
form inside each chunk, each chunk's state, the linear recurrence across
chunks); ``D`` skips the input past the scan, and a gated RMSNorm
``norm(y * silu(z))`` precedes the output projection.

The segment sums' upper triangle is ``-inf`` before the ``exp``, as in the
JAX package, so the masked entries are exact zeros with zero gradients (an
``exp`` of the unmasked differences would overflow and give ``0 * inf`` in
the backward).  The log-decays' prefix sums, and the differences of them that
enter an ``exp``, are formed in float64 and rounded once to f32: over a
chunk the decays add up to hundreds, an f32 cumsum's rounding error grows
with that sum, and ``exp`` turns it into relative error of the decay
(~1e-5 on the reduced ``jamba``'s gradients, where the JAX package's f32
cumsum keeps it).  The sequence length must be a multiple of the chunk (or
shorter than one).

The decode (``cache`` given, one token per sequence) is the recurrence
itself, in place on a :class:`MambaCache`: the conv history takes the new
inputs (held in the compute dtype, as the JAX package holds it), and the
f32 state decays by ``exp(A * dt)`` and takes ``x * dt`` times ``B``; the
output contracts the state with ``C``.  It has no prefix sum.
"In f32" means at least f32 (:func:`~repro_torch.models.layers.wide`).

Over a model group (:func:`~repro_torch.models.sharding.model_parallel`) a
rank holds the JAX package's shards of the three split leaves: ``in_proj``
and ``conv_w`` cut into contiguous equal column slices across the packed
``[z, x, B, C, dt]`` / ``[x, B, C]`` channels (the slices ignore the
components), ``out_proj`` cut by rows.  The layer gathers them whole
(:func:`~repro_torch.models.sharding.gather_from_model`, tagged ``"mamba"``) and
runs its body replicated: its input is the model group's replicated residual
stream, so the output and every gradient are the unsharded layer's bits, and
each split leaf's gradient is the rank's slice of a whole one.  The cost is
every rank running the whole mixer (the JAX package's placement splits the
SSD heads over the model axis instead).

A leaf handed over whole is not gathered: serving over a mesh
(``repro_torch.launch.serve``) gathers the three once, when its step is
built, so that a decode step makes no ``mamba`` collective.  The decode's
``conv`` / ``ssm`` caches are then whole on every model rank too (split
over the data ranks by batch, as ``cache_specs`` says); the JAX placement
splits their channels and heads over ``model``, which a head-parallel
mixer would match (ROADMAP.md queue 2 item 14).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import wide
from .sharding import gather_from_model

__all__ = ["mamba_layer", "ssd_chunked", "conv_full", "gated_rms_norm", "dims",
           "mamba_shapes", "MambaCache", "init_mamba_cache", "SPLIT"]

# the leaves the model axis splits, and the dimension (of one layer's leaf)
# that the rules split them along
SPLIT = {"in_proj": 1, "conv_w": 1, "out_proj": 0}


class MambaCache(NamedTuple):
    """``repro.models.mamba2.MambaCache``, written in place by the decode."""

    conv: torch.Tensor    # (B, W-1, conv channels): the last inputs of the causal conv
    ssm: torch.Tensor     # (B, H, P, N) f32: the recurrent state
    pos: torch.Tensor     # () int32 on the cache's device


def dims(cfg):
    """``(ssm config, d_inner, heads, head_dim, d_state, groups)``."""
    sc = cfg.ssm
    return (sc, sc.d_inner(cfg.d_model), sc.n_heads(cfg.d_model), sc.head_dim, sc.d_state,
            sc.n_groups)


def mamba_shapes(cfg):
    """``{leaf: (shape, f32?)}`` of one mixer (``init_mamba``'s tree): the
    SSD scalars ``dt_bias``, ``A_log`` and ``D`` are f32 whatever the
    parameter dtype."""
    sc, d_in, h, _, n, g = dims(cfg)
    conv_ch = d_in + 2 * g * n
    d_proj = 2 * d_in + 2 * g * n + h       # z, x, B, C, dt
    return {"in_proj": ((cfg.d_model, d_proj), False),
            "conv_w": ((sc.conv_width, conv_ch), False),
            "conv_b": ((conv_ch,), False),
            "dt_bias": ((h,), True),
            "A_log": ((h,), True),
            "D": ((h,), True),
            "norm_scale": ((d_in,), False),
            "out_proj": ((d_in, cfg.d_model), False)}


def init_mamba_cache(cfg, batch: int, dtype, device=None) -> MambaCache:
    sc, d_in, h, p, n, g = dims(cfg)
    conv_ch = d_in + 2 * g * n
    return MambaCache(
        conv=torch.zeros((batch, sc.conv_width - 1, conv_ch), dtype=dtype, device=device),
        ssm=torch.zeros((batch, h, p, n), dtype=torch.promote_types(dtype, torch.float32),
                        device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def _segsum(at: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): ``cs[q] - cs[k]`` on and below the diagonal,
    ``-inf`` above it."""
    q = at.shape[-1]
    cs = torch.cumsum(at.double(), dim=-1)
    diff = (cs[..., :, None] - cs[..., None, :]).to(at.dtype)
    idx = torch.arange(q, device=at.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(xt, at, b_, c_, chunk: int) -> torch.Tensor:
    """The chunked SSD scan (``_ssd_chunked``), all in f32.

    xt (B, L, H, P): the dt-discretised inputs ``x * dt``; at (B, L, H): the
    log-decays ``A * dt`` (negative); b_, c_ (B, L, H, N): the input and
    output projections, broadcast over the groups.  Returns y (B, L, H, P)."""
    bsz, l, h, p = xt.shape
    n = b_.shape[-1]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    c = l // chunk

    def r(t):  # (B, L, ...) -> (B, C, Q, ...)
        return t.reshape(bsz, c, chunk, *t.shape[2:])

    xt, at, b_, c_ = wide(r(xt)), wide(r(at)), wide(r(b_)), wide(r(c_))

    # intra-chunk (quadratic): Y_diag = (C B^T o L) X
    lmat = torch.exp(_segsum(at.movedim(-1, 2)))                  # (B,C,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", c_, b_)
    y_diag = torch.einsum("bchqk,bchqk,bckhp->bcqhp", scores, lmat, xt)

    # chunk states: what each chunk contributes to the running state
    a_cum64 = torch.cumsum(at.double(), dim=2)                    # (B,C,Q,H)
    a_cum = a_cum64.to(at.dtype)
    a_tot = a_cum[:, :, -1]                                       # (B,C,H)
    decay_states = torch.exp((a_cum64[:, :, -1:] - a_cum64).to(at.dtype))  # (B,C,Q,H)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", b_, decay_states, xt)

    # inter-chunk recurrence: the state before each chunk
    carry = xt.new_zeros((bsz, h, p, n))
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * torch.exp(a_tot[:, i])[:, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                        # (B,C,H,P,N)

    # inter-chunk output: Y_off = C . (decay_in * prev_state)
    decay_out = torch.exp(a_cum)                                  # (B,C,Q,H)
    y_off = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", c_, decay_out, prev_states)
    return (y_diag + y_off).reshape(bsz, l, h, p)


def conv_full(conv_w, conv_b, u: torch.Tensor, cdt) -> torch.Tensor:
    """Causal depthwise conv over u (B, L, CH) with width W, in f32, then
    SiLU, rounded to ``cdt``."""
    w = wide(conv_w)                                             # (W, CH)
    width, l = w.shape[0], u.shape[1]
    up = F.pad(wide(u), (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + up[:, i:i + l] * w[i]
    return F.silu(out + wide(conv_b)).to(cdt)


def gated_rms_norm(y, z, scale, eps: float) -> torch.Tensor:
    """Mamba-2's ``norm(y * silu(z)) * scale`` in f32."""
    gated = y * F.silu(wide(z))
    var = torch.mean(gated * gated, dim=-1, keepdim=True)
    return gated * torch.rsqrt(var + eps) * wide(scale)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, without torch's linear
    branch above a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_step(conv_w, conv_b, cache: MambaCache, u: torch.Tensor, cdt) -> torch.Tensor:
    """One step of the causal conv: the history (the cache's last W-1
    inputs, then ``u`` (B, 1, CH)) against the taps in f32, then SiLU,
    rounded to ``cdt``; the history moves on by one in place."""
    hist = torch.cat([cache.conv.to(cdt), u], dim=1)              # (B,W,CH)
    out = torch.einsum("bwc,wc->bc", wide(hist), wide(conv_w))
    cache.conv.copy_(hist[:, 1:])
    return F.silu(out + wide(conv_b))[:, None].to(cdt)


def _gather_split(p, cfg):
    """``p`` (one mixer's leaves) with ``in_proj``, ``conv_w`` and
    ``out_proj`` whole: a shard gathered over the model group (tagged
    ``"mamba"``), a whole leaf as it is."""
    whole = mamba_shapes(cfg)
    return {**p, **{k: gather_from_model(p[k], d, tag="mamba") for k, d in SPLIT.items()
                    if p[k].shape[d] != whole[k][0][d]}}


def mamba_layer(p, x: torch.Tensor, cfg, cache: Optional[MambaCache] = None) -> torch.Tensor:
    """x (B, S, D) -> out (B, S, D).  ``cache=None``: the chunked SSD over
    the sequence (train and prefill); otherwise one token per sequence
    through the recurrence, the cache updated in place (the caller advances
    ``cache.pos``)."""
    sc, d_in, h, hp, n, g = dims(cfg)
    bsz, s, _ = x.shape
    cdt = cfg.compute_dtype
    p = _gather_split(p, cfg)

    proj = x @ p["in_proj"].to(cdt)                               # (B,S,dproj)
    z, xr, braw, craw, dt_raw = torch.split(proj, [d_in, d_in, g * n, g * n, h], dim=-1)
    conv_in = torch.cat([xr, braw, craw], dim=-1)
    if cache is None:
        conv_out = conv_full(p["conv_w"], p["conv_b"], conv_in, cdt)
    elif s != 1:
        raise ValueError(f"the decode path takes one new token per sequence, not {s}")
    else:
        conv_out = _conv_step(p["conv_w"], p["conv_b"], cache, conv_in, cdt)
    xr, braw, craw = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    xt = xr.reshape(bsz, s, h, hp)
    # each group's B and C over its h / g heads (jnp.repeat): an expand, whose
    # backward is a sum over the copies, never an atomic scatter
    rep = h // g
    bh = braw.reshape(bsz, s, g, 1, n).expand(bsz, s, g, rep, n).reshape(bsz, s, h, n)
    ch = craw.reshape(bsz, s, g, 1, n).expand(bsz, s, g, rep, n).reshape(bsz, s, h, n)

    dt = _softplus(wide(dt_raw) + p["dt_bias"])                  # (B,S,H)
    a = -torch.exp(p["A_log"])                                    # (H,)
    if cache is None:
        y = ssd_chunked(wide(xt) * dt[..., None], a * dt, bh, ch, min(sc.chunk_size, s))
    else:
        dt0 = dt[:, 0]                                            # (B,H)
        xin = wide(xt[:, 0]) * dt0[..., None]                     # (B,H,P)
        cache.ssm.mul_(torch.exp(a * dt0)[:, :, None, None])
        cache.ssm.add_(xin[..., None] * wide(bh[:, 0, :, None, :]))
        y = torch.einsum("bhpn,bhn->bhp", cache.ssm, wide(ch[:, 0]))[:, None]
    y = y + p["D"][:, None] * wide(xt)
    yn = gated_rms_norm(y.reshape(bsz, s, d_in), z, p["norm_scale"], cfg.norm_eps)
    return yn.to(cdt) @ p["out_proj"].to(cdt)
