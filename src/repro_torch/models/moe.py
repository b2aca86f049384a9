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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import wide
from .sharding import copy_to_model, current, gather_from_model, reduce_from_model

__all__ = ["moe_layer", "route", "MOE_TOKEN_CHUNK"]

MOE_TOKEN_CHUNK = 16_384  # dispatch-buffer working set: chunk x d x top_k x cf


def route(router: torch.Tensor, xf: torch.Tensor, cfg):
    """Routing and capacity slots of ``xf`` (T, D).  Returns ``(top_p, top_e,
    slot, keep, cap, aux)``: the renormalised (T, k) f32 probabilities and
    experts, each choice's slot ``e * cap + pos`` (``E * cap`` when
    dropped), whether it is kept, the capacity, and the Switch aux loss."""
    mc = cfg.moe
    t = xf.shape[0]
    e, k = mc.n_experts, mc.top_k
    cap = max(1, int(mc.capacity_factor * t * k / e))

    logits = wide(xf) @ wide(router)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    # Switch-style load-balance loss
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_e[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * ce) * mc.aux_loss_weight

    flat_e = top_e.reshape(-1)                                    # (T*k,)
    eo = F.one_hot(flat_e, e)
    pos = torch.sum(torch.cumsum(eo, dim=0) * eo, dim=-1) - 1     # position within the expert
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, e * cap))
    return top_p, top_e, slot.reshape(t, k), keep.reshape(t, k), cap, aux


def _swiglu(buf, w_in, w_gate, w_out):
    h = torch.einsum("ecd,edf->ecf", buf, w_in)
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, w_out)


def _run_chunk(xc, router, w_in, w_gate, w_out, cfg):
    """One token chunk (T, D) -> (combined (T, D), aux); under a model group
    the experts' shards of the nested path (the module's docstring)."""
    t, d = xc.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cdt = cfg.compute_dtype
    mp = current()
    top_p, _, slot, keep, cap, aux = route(router, xc, cfg)
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


def moe_layer(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss).  ``p`` holds ``router``
    (D, E) f32 and the stacked expert weights ``w_in`` / ``w_gate`` (E, D,
    F) and ``w_out`` (E, F, D), under a model group this rank's shards of
    them.  Above ``token_chunk`` (default :data:`MOE_TOKEN_CHUNK`) tokens
    that it divides, the tokens run in chunks, each recomputed in the
    backward (when autograd records), and the aux loss is the chunks' mean
    (``_moe_chunked``).  At decode T = B, so the capacity, and the drops,
    are those of B tokens."""
    b, s, d = x.shape
    t = b * s
    cdt = cfg.compute_dtype
    if current() is not None:
        split, dim = ((cfg.moe.n_experts, 0) if cfg.moe.partition == "expert"
                      else (cfg.moe.d_ff, -1))
        assert p["w_in"].shape[dim] * current().size == split, "an undivided MoE split"
    xf = x.reshape(t, d)
    ws = (p["router"], p["w_in"].to(cdt), p["w_gate"].to(cdt), p["w_out"].to(cdt))
    chunk = cfg.moe.token_chunk or MOE_TOKEN_CHUNK
    if t <= chunk or t % chunk:
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
