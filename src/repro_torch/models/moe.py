"""Token-choice top-k Mixture-of-Experts with capacity buckets (the
single-device path of ``repro.models.moe.moe_layer``).

Each token is routed to its ``top_k`` experts by an f32 router (softmax,
then the top-k probabilities renormalised); each (token, choice) takes the
next free slot of its expert's ``capacity`` buckets in the flattened
(token, choice) order, and the choices past the capacity are dropped.  The
kept tokens are scattered into an ``(E, capacity, D)`` buffer, run through a
batched per-expert SwiGLU, and each token sums its ``top_k`` slots' outputs
weighted by their probabilities.

The routing matches ``lax.top_k`` (descending probability, ties to the lower
expert: a stable descending sort), so the same tokens are kept and dropped.
Both directions are deterministic on the card: the dispatch scatters each
kept (token, choice) into its own slot (the dropped ones into one spare row
that is cut off), and the combine gathers each token's ``top_k`` slots and
adds them in choice order, with no atomic accumulation over colliding
indices; a dropped choice gathers the zero row and adds an exact zero.  The
JAX package sums a token's slots in ``segment_sum``'s order instead, so the
two agree to the f32 rounding of a ``top_k``-term sum, not bit for bit.

Under a model group (:mod:`repro_torch.models.sharding`, the trainer on a
``--mesh NxM`` with M > 1) the layer runs the JAX package's nested
fully-manual path (``repro/models/moe.py:195-241``): the routing, the
capacity and the drops are computed replicated on every model rank from the
worker's whole tokens, and the experts are split one of two ways:

* ``partition="expert"`` (E % M == 0): the rank holds experts ``[m E/M,
  (m+1) E/M)``, runs them on its slice of the dispatch buffer, and the
  per-expert outputs are all-gathered over the group
  (:func:`~repro_torch.models.sharding.gather_from_model`) before the combine,
  which runs replicated;
* ``partition="ffn"`` (``d_ff`` % M == 0): the rank holds an F-slice of
  every expert, runs the whole buffer, combines its partial outputs into
  (T, D), and only then all-reduces: the sum is linear in ``y``, so the
  wire carries (T, D) instead of (E cap, D), ``top_k * capacity_factor``
  times fewer bytes.

The gradients of the router and of the layer's input are each the sum of a
branch that is whole on every rank and of one that holds only the rank's
share; only the latter is all-reduced (``copy_to_model`` on it alone): the
dispatch branch in both modes (a rank's experts, or its F-slice, see only
their part), and in the ``ffn`` mode the combine weights (they weight a
partial ``y``).  The aux loss's branch is whole in both.  The other splits
(the JAX package's pure GSPMD fallback, ``:175-193``) have no port: the
trainer refuses them (``check_model_axis``), and the layer asserts that its
shards are those of one of the two above.

Served with the batch split over the data ranks
(:class:`~repro_torch.models.sharding.DataGroup` ``split="batch"``), the
layer keeps the choices of the JAX serve step, which runs the pure GSPMD
path over the *global* batch: the capacity is that of the global tokens
(of each global chunk of ``token_chunk``), and a choice's position in its
expert follows global token order.  A rank holds the global tokens ``[r T,
(r+1) T)``; it routes them, all-gathers each rank's per-expert choice
counts in each global chunk over the data group (one gather of (chunks,
E) int64, tagged ``"serve_moe"``), and offsets its own positions by the
earlier ranks' counts, so that it keeps and drops exactly the choices the
global dispatch keeps and drops.  Each global chunk the rank's tokens meet
is dispatched apart, with that chunk's capacity.  A rank's own dispatch
(the training path's, per worker) would keep others: its capacity would
be that of its own tokens, its positions those of its own order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import transport

from .layers import wide
from .sharding import copy_to_model, current, current_data, gather_from_model, reduce_from_model

__all__ = ["moe_layer", "route", "MOE_TOKEN_CHUNK"]

MOE_TOKEN_CHUNK = 16_384  # dispatch-buffer working set: chunk x d x top_k x cf


def capacity(cfg, t: int) -> int:
    """The slots per expert of a dispatch of ``t`` tokens."""
    mc = cfg.moe
    return max(1, int(mc.capacity_factor * t * mc.top_k / mc.n_experts))


def _top_k(router, xf, cfg):
    """``(probs, top_p, top_e)`` of ``xf`` (T, D): the router's f32 softmax
    and its renormalised top-k probabilities and experts."""
    k = cfg.moe.top_k
    probs = torch.softmax(wide(xf) @ wide(router), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def route(router: torch.Tensor, xf: torch.Tensor, cfg, cap=None, base=None):
    """Routing and capacity slots of ``xf`` (T, D).  Returns ``(top_p, top_e,
    slot, keep, cap, aux)``: the renormalised (T, k) f32 probabilities and
    experts, each choice's slot ``e * cap + pos`` (``E * cap`` when
    dropped), whether it is kept, the capacity, and the Switch aux loss.
    ``cap`` defaults to that of T tokens; ``base`` (E,), the choices that
    precede ``xf``'s in each expert, offsets the positions (the serving
    dispatch over the data ranks)."""
    mc = cfg.moe
    t = xf.shape[0]
    e, k = mc.n_experts, mc.top_k
    cap = capacity(cfg, t) if cap is None else cap
    probs, top_p, top_e = _top_k(router, xf, cfg)

    # Switch-style load-balance loss
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_e[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * ce) * mc.aux_loss_weight

    flat_e = top_e.reshape(-1)                                    # (T*k,)
    eo = F.one_hot(flat_e, e)
    pos = torch.sum(torch.cumsum(eo, dim=0) * eo, dim=-1) - 1     # position within the expert
    if base is not None:
        pos = pos + base[flat_e]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, e * cap))
    return top_p, top_e, slot.reshape(t, k), keep.reshape(t, k), cap, aux


def _swiglu(buf, w_in, w_gate, w_out):
    h = torch.einsum("ecd,edf->ecf", buf, w_in)
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, w_out)


def _run_chunk(xc, router, w_in, w_gate, w_out, cfg, cap=None, base=None):
    """One token chunk (T, D) -> (combined (T, D), aux); under a model group
    the experts' shards of the nested path (the module's docstring);
    ``cap`` and ``base`` as :func:`route` takes them."""
    t, d = xc.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cdt = cfg.compute_dtype
    mp = current()
    top_p, _, slot, keep, cap, aux = route(router, xc, cfg, cap, base)
    if mp is not None:
        xc = copy_to_model(xc, tag="moe")           # the dispatch branch is partial
        if cfg.moe.partition == "ffn":
            top_p = copy_to_model(top_p, tag="moe")  # it weights a partial y
    # dispatch: each kept (token, choice) into its own slot; the dropped
    # ones all land in the spare row e * cap, which is cut off
    xrep = xc.to(cdt)[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xc.new_zeros((e * cap + 1, d), dtype=cdt)
    buf = buf.index_put((slot.reshape(-1),), xrep)
    buf = buf[:e * cap].reshape(e, cap, d)
    if mp is not None and cfg.moe.partition == "expert":
        e_loc = w_in.shape[0]
        # (E/M, ...) per rank -> (E, ...) (repro/models/moe.py:208)
        y = gather_from_model(_swiglu(buf[mp.index * e_loc:(mp.index + 1) * e_loc],
                                      w_in, w_gate, w_out), 0, tag="moe")
    else:
        y = _swiglu(buf, w_in, w_gate, w_out)
    # combine: gather each token's k slots (dropped: the zero row), weight,
    # and add in choice order
    y_pad = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))], dim=0)
    w_eff = torch.where(keep, top_p, torch.zeros_like(top_p)).to(cdt)
    picked = y_pad[slot.reshape(-1)].reshape(t, k, d) * w_eff[..., None]
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]
    if mp is not None and cfg.moe.partition == "ffn":
        out = reduce_from_model(out, tag="moe")     # after the combine: (T, D) on the wire
    return out, aux


def _chunk_tokens(t: int, cfg) -> int:
    """The tokens of one dispatch chunk of ``t`` (``_moe_chunked``): all
    of them unless ``token_chunk`` is exceeded and divides them."""
    chunk = cfg.moe.token_chunk or MOE_TOKEN_CHUNK
    return t if t <= chunk or t % chunk else chunk


def _serve_rows(xf, ws, cfg, dg):
    """The serving dispatch of this rank's rows of a batch split over the
    data group ``dg``: the global dispatch's capacities and positions (the
    module's docstring).  Returns ``(combined, aux)``, the aux loss the mean
    of this rank's segments' (serving discards it)."""
    t, e = xf.shape[0], cfg.moe.n_experts
    cs = _chunk_tokens(t * dg.size, cfg)
    lo = dg.index * t
    segs = [(c, max(c * cs, lo) - lo, min((c + 1) * cs, lo + t) - lo)
            for c in range(lo // cs, (lo + t - 1) // cs + 1)]
    counts = xf.new_zeros((t * dg.size // cs, e), dtype=torch.int64)
    for c, a, b in segs:
        top_e = _top_k(ws[0], xf[a:b], cfg)[2]
        counts[c] = F.one_hot(top_e.reshape(-1), e).sum(dim=0)
    every = transport.all_gather_bytes(counts, dg.size, dg.group, tag="serve_moe")
    base = every[:dg.index].sum(dim=0)                            # (chunks, E)
    outs, auxs = zip(*(_run_chunk(xf[a:b], *ws, cfg, capacity(cfg, cs), base[c])
                       for c, a, b in segs))
    return torch.cat(outs, dim=0), torch.mean(torch.stack(auxs))


def moe_layer(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss).  ``p`` holds ``router``
    (D, E) f32 and the stacked expert weights ``w_in`` / ``w_gate`` (E, D,
    F) and ``w_out`` (E, F, D), under a model group this rank's shards of
    them.  Above ``token_chunk`` (default :data:`MOE_TOKEN_CHUNK`) tokens
    that it divides, the tokens run in chunks, each recomputed in the
    backward (when autograd records), and the aux loss is the chunks' mean
    (``_moe_chunked``).  At decode T = B, so the capacity, and the drops,
    are those of B tokens: of the global batch when the serving data group
    splits it (:func:`_serve_rows`)."""
    b, s, d = x.shape
    t = b * s
    cdt = cfg.compute_dtype
    if current() is not None:
        split, dim = ((cfg.moe.n_experts, 0) if cfg.moe.partition == "expert"
                      else (cfg.moe.d_ff, -1))
        assert p["w_in"].shape[dim] * current().size == split, "an undivided MoE split"
    xf = x.reshape(t, d)
    ws = (p["router"], p["w_in"].to(cdt), p["w_gate"].to(cdt), p["w_out"].to(cdt))
    chunk = _chunk_tokens(t, cfg)
    dg = current_data()
    if dg is not None and dg.split == "batch" and dg.size > 1:
        combined, aux = _serve_rows(xf, ws, cfg, dg)
    elif chunk == t:
        combined, aux = _run_chunk(xf, *ws, cfg)
    else:
        outs, auxs = [], []
        for i in range(0, t, chunk):
            if torch.is_grad_enabled():
                o, a = checkpoint(_run_chunk, xf[i:i + chunk], *ws, cfg, use_reentrant=False)
            else:
                o, a = _run_chunk(xf[i:i + chunk], *ws, cfg)
            outs.append(o)
            auxs.append(a)
        combined, aux = torch.cat(outs, dim=0), torch.mean(torch.stack(auxs))
    return combined.reshape(b, s, d).to(cdt), aux
