"""Decoder-only model family: embeddings (with the frontend stubs), the block
stack, the LM head, and the chunked next-token cross-entropy (plus the MoE
aux loss).

One code path serves the ten architectures through the config's ``pattern``
(a repeating tuple of :class:`~repro_torch.configs.base.LayerSpec`): dense
GQA transformers, MoE, pure SSM (mamba2), the Jamba hybrid interleave and
the vision / audio frontend-stub models.

Parameters keep the JAX package's tree (``repro.models.transformer``):
``embed`` (V_pad, D), ``final_norm/scale``, ``lm_head`` (D, V_pad, absent
with ``tie_embeddings``), ``frontend_proj/{w,b}`` for a frontend model, and
every block leaf stacked over ``n_blocks`` under ``blocks/layer{i}/...``, one
per position ``i`` of the pattern: ``norm1/scale``, the mixer (attention's
``wq`` / ``wk`` / ``wv`` / ``wo`` or Mamba-2's eight leaves), and unless the
layer has no MLP ``norm2/scale`` and the MLP (``w_in`` / ``w_out`` and
SwiGLU's ``w_gate``, or the MoE's ``router`` and stacked experts).  One
``nn.Parameter`` per leaf, keyed by its path, in the JAX leaf's dtype: the
MoE router and the SSD scalars (``dt_bias``, ``A_log``, ``D``) are f32
whatever ``param_dtype`` is.  The bucket layout and the per-leaf PRNG keys
follow that tree's leaf order, so any other layout would break payload
parity with the JAX package.

Under a model group (:mod:`repro_torch.models.sharding`, the trainer on a
``--mesh NxM`` with M > 1) the parameters are the rank's shards
(``repro_torch.launch.sharding_rules``): the embedding's feature columns,
gathered after the lookup; the LM head's vocabulary columns, whose logits
meet in a vocabulary-parallel cross-entropy (the max and the log-sum-exp
all-reduced, the target logit from the shard that owns it), chunked by
``CE_SEQ_CHUNK`` as before; the frontend projection's feature columns,
gathered before its (replicated) bias; the attention and the MLP
tensor-parallel (``layers.py``); the MoE layer's experts by expert or by
``d_ff`` (``moe.py``).

Serving (``repro_torch.launch.serve``) runs :func:`forward` over the
prompt with ``last_token_only`` (the prefill) and :func:`decode_step` one
token at a time against :func:`init_caches` (per pattern position an
``AttnCache`` or a ``MambaCache``, each leaf stacked over ``n_blocks`` as in
the JAX package), which the step updates in place.  Over a serving mesh the
caches are the rank's shards (``repro_torch.launch.serve``): its rows of
the batch or of the cache's sequence, its KV heads; the head's logits,
vocabulary-sharded like ``lm_head``, are all-gathered along the vocabulary
(tagged ``"head"``), so that every rank returns the whole (B, 1, V_pad)
logits of its rows.

``remat="full"`` recomputes each block in the backward
(``torch.utils.checkpoint``), like ``jax.checkpoint`` around the scanned
block.  ``remat="dots"`` is ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``: a selective checkpoint whose policy
(:func:`dots_policy`) saves the outputs of the products with no batch
dimension and recomputes everything else.  A ``x @ W`` projection of a
(B, S, D) activation folds into one ``aten.mm`` (the attention and MLP
projections, Mamba-2's ``in_proj`` / ``out_proj``, the MoE router); the
batched einsums (attention scores and values, the MoE experts, the SSD)
reach ``aten.bmm`` and are recomputed.  The saved set is the block's
no-batch ``dot_general`` outputs; XLA keeps a product as a residual only
where the backward reads it, so it drops the block's last one (the MLP's
``w_out``, which feeds only the residual add), which the port holds until
its recompute.  Without autograd (a prefill under ``torch.inference_mode``)
and on the decode path the blocks just run.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.shapes import FRONTEND_DIM

from . import layers as L
from . import mamba2 as M
from .moe import moe_layer
from .sharding import copy_to_model, current, gather_from_model, vocab_parallel_ce

__all__ = ["init_model", "param_shapes", "param_dtypes", "meta_params", "Transformer",
           "forward", "head_logits", "train_loss", "init_caches", "decode_step",
           "count_params", "count_active_params", "model_flops_per_token", "CE_SEQ_CHUNK",
           "FRONTEND_DIM", "SAVED_PRODUCTS", "dots_policy"]

CE_SEQ_CHUNK = 512

# remat="dots": the aten ops of the products with no batch dimension
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable`` as a selective-checkpoint policy:
    save the output of an op of :data:`SAVED_PRODUCTS`, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


_REMATS = ("none", "full", "dots")

_ONES, _ZEROS, _A_LOG = "ones", "zeros", "a_log"


def _layer_specs(spec, cfg) -> Dict[str, tuple]:
    """``{name: (shape, init, f32)}`` of one layer (unstacked): ``init`` is
    a std for a normal draw, or how a constant leaf starts."""
    d, deep = cfg.d_model, math.sqrt(2 * cfg.n_layers)
    out = {"norm1/scale": ((d,), _ONES, False)}
    if spec.mlp != "none":
        out["norm2/scale"] = ((d,), _ONES, False)
    if spec.mixer == "attn":
        h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        s = 1 / math.sqrt(d)
        out.update({"mixer/wq": ((d, h * dh), s, False), "mixer/wk": ((d, hkv * dh), s, False),
                    "mixer/wv": ((d, hkv * dh), s, False),
                    "mixer/wo": ((h * dh, d), s / deep, False)})
    elif spec.mixer == "mamba":
        d_in = M.dims(cfg)[1]
        std = {"in_proj": 1 / math.sqrt(d), "conv_w": 1 / math.sqrt(cfg.ssm.conv_width),
               "conv_b": _ZEROS, "dt_bias": _ZEROS, "A_log": _A_LOG, "D": _ONES,
               "norm_scale": _ONES, "out_proj": 1 / math.sqrt(d_in) / deep}
        out.update({f"mixer/{k}": (shape, std[k], f32)
                    for k, (shape, f32) in M.mamba_shapes(cfg).items()})
    else:
        raise ValueError(spec.mixer)
    if spec.mlp == "dense":
        f = cfg.d_ff
        if cfg.act not in ("swiglu", "gelu", "relu2"):
            raise ValueError(f"unknown activation {cfg.act}")
        out.update({"mlp/w_in": ((d, f), 1 / math.sqrt(d), False),
                    "mlp/w_out": ((f, d), 1 / math.sqrt(f) / deep, False)})
        if cfg.act == "swiglu":
            out["mlp/w_gate"] = ((d, f), 1 / math.sqrt(d), False)
    elif spec.mlp == "moe":
        e, f = cfg.moe.n_experts, cfg.moe.d_ff
        out.update({"mlp/router": ((d, e), 1 / math.sqrt(d), True),
                    "mlp/w_in": ((e, d, f), 1 / math.sqrt(d), False),
                    "mlp/w_gate": ((e, d, f), 1 / math.sqrt(d), False),
                    "mlp/w_out": ((e, f, d), 1 / math.sqrt(f) / deep, False)})
    elif spec.mlp != "none":
        raise ValueError(spec.mlp)
    return out


def _specs(cfg) -> Dict[str, tuple]:
    """``{path: (shape, init, f32)}`` of the whole tree, block leaves stacked."""
    d, vpad, nb = cfg.d_model, cfg.padded_vocab, cfg.n_blocks
    if cfg.remat not in _REMATS:
        raise ValueError(f"unknown remat {cfg.remat!r}; choose from {_REMATS}")
    specs = {"embed": ((vpad, d), 0.02, False), "final_norm/scale": ((d,), _ONES, False)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, vpad), 0.02, False)
    if cfg.frontend != "none":
        fdim = FRONTEND_DIM[cfg.frontend]
        specs["frontend_proj/w"] = ((fdim, d), 1 / math.sqrt(fdim), False)
        specs["frontend_proj/b"] = ((d,), _ZEROS, False)
    for i, spec in enumerate(cfg.pattern):
        for n, (shape, init, f32) in _layer_specs(spec, cfg).items():
            specs[f"blocks/layer{i}/{n}"] = ((nb, *shape), init, f32)
    return specs


def param_shapes(cfg) -> Dict[str, tuple]:
    """``{path: shape}`` of the parameter tree (block leaves stacked)."""
    return {p: s for p, (s, _, _) in _specs(cfg).items()}


def param_dtypes(cfg) -> Dict[str, torch.dtype]:
    """``{path: dtype}``: f32 for the router and the SSD scalars,
    ``cfg.param_dtype`` for every other leaf (``init_model``'s)."""
    return {p: torch.float32 if f32 else cfg.param_dtype for p, (_, _, f32) in _specs(cfg).items()}


def meta_params(cfg) -> Dict[str, torch.Tensor]:
    """The tree as ``meta`` tensors (shapes and dtypes, no storage)."""
    dts = param_dtypes(cfg)
    return {p: torch.empty(s, dtype=dts[p], device="meta") for p, s in param_shapes(cfg).items()}


def init_model(cfg, device, seed: int = 0) -> Dict[str, nn.Parameter]:
    """Random weights from a ``torch.Generator`` (the JAX package's scales
    and constants, not its numbers: parity tests load JAX weights through
    ``convert.py``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for path, (shape, init, f32) in _specs(cfg).items():
        if init == _ONES:
            x = torch.ones(shape, device=device)
        elif init == _ZEROS:
            x = torch.zeros(shape, device=device)
        elif init == _A_LOG:
            x = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device)).expand(shape)
        else:
            x = torch.randn(shape, generator=gen, device=device) * init
        params[path] = nn.Parameter(x.to(torch.float32 if f32 else cfg.param_dtype).contiguous())
    return params


def init_caches(cfg, batch: int, max_len: int, *, window: Optional[int] = None,
                device=None) -> tuple:
    """The decode caches (``init_caches``): per pattern position an
    ``AttnCache`` (a ring buffer of ``window`` rows when one is given) or a
    ``MambaCache``, every leaf stacked over ``n_blocks``, in the compute
    dtype (the SSM state and ``pos`` in f32 and int32).  ``device="meta"``
    gives the shapes and dtypes without allocating."""
    out = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            one = L.init_attn_cache(cfg, batch, max_len, cfg.compute_dtype, window, device="meta")
        else:
            one = M.init_mamba_cache(cfg, batch, cfg.compute_dtype, device="meta")
        out.append(type(one)(*(torch.zeros((cfg.n_blocks, *t.shape), dtype=t.dtype,
                                           device=device) for t in one)))
    return tuple(out)


def _block(x, aux, positions, lp, cfg, window, caches=None):
    """One pattern block over ``lp`` (``{layer{i}/...: tensor}``); on the
    decode path ``caches`` holds this block's cache per pattern position."""
    for i, spec in enumerate(cfg.pattern):
        pre = f"layer{i}/"
        sub = lambda part: {k[len(pre) + len(part):]: v for k, v in lp.items()  # noqa: E731
                            if k.startswith(pre + part)}
        cache = caches[i] if caches is not None else None
        h = L.rms_norm(lp[pre + "norm1/scale"], x, cfg.norm_eps)
        if spec.mixer == "attn":
            x = x + L.attention(sub("mixer/"), h, cfg, positions, window, cache=cache)
        else:
            x = x + M.mamba_layer(sub("mixer/"), h, cfg, cache=cache)
        if spec.mlp != "none":
            h2 = L.rms_norm(lp[pre + "norm2/scale"], x, cfg.norm_eps)
            if spec.mlp == "moe":
                y, a = moe_layer(sub("mlp/"), h2, cfg)
                aux = aux + a
            else:
                y = L.mlp(sub("mlp/"), h2, cfg)
            x = x + y
    return x, aux


def _embed_inputs(params, batch, cfg) -> torch.Tensor:
    """The input sequence: the frontend stub's projected embeddings, then
    the token embeddings."""
    cdt = cfg.compute_dtype
    parts = []
    key = f"{cfg.frontend}_embeds"
    if cfg.frontend != "none" and key in batch:
        # column-parallel over a model group: the rank's D columns, gathered
        # (the contraction over fdim is whole, so nothing is summed)
        w, b = params["frontend_proj/w"].to(cdt), params["frontend_proj/b"].to(cdt)
        parts.append(gather_from_model(batch[key].to(cdt) @ w, tag="frontend") + b)
    if "tokens" in batch:
        parts.append(gather_from_model(torch.nn.functional.embedding(
            batch["tokens"].long(), params["embed"].to(cdt))))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def forward(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor], cfg,
            window: Optional[int] = None, *, caches: Optional[tuple] = None,
            positions: Optional[torch.Tensor] = None,
            last_token_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch -> (final hidden states (B, S, D) after the final norm, the
    summed MoE aux loss, a 0-dim f32).

    ``positions`` (B, S) default to ``0 .. S-1``.  ``caches``
    (:func:`init_caches`) take the decode path, one token per sequence,
    updating them in place (:func:`decode_step` advances their ``pos``).
    ``last_token_only`` keeps the last position alone, sliced before the
    final norm: the prefill, whose logits (:func:`head_logits`) are then
    (B, 1, V) and never (B, S, V)."""
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    names = [p[len("blocks/"):] for p in params if p.startswith("blocks/")]
    stacked = {n: params["blocks/" + n].unbind(0) for n in names}
    body = partial(_block, cfg=cfg, window=window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_blocks):
        lp = {n: stacked[n][i] for n in names}
        if caches is not None:
            x, aux = body(x, aux, positions, lp,
                          caches=tuple(type(c)(*(t[i] for t in c)) for c in caches))
        elif cfg.remat == "full" and torch.is_grad_enabled():
            x, aux = checkpoint(body, x, aux, positions, lp, use_reentrant=False)
        elif cfg.remat == "dots" and torch.is_grad_enabled():
            x, aux = checkpoint(body, x, aux, positions, lp, use_reentrant=False,
                                context_fn=_dots_context)
        else:
            x, aux = body(x, aux, positions, lp)
    if last_token_only:
        x = x[:, -1:]
    return L.rms_norm(params["final_norm/scale"], x, cfg.norm_eps), aux


def _head(params: Mapping[str, torch.Tensor], cfg) -> torch.Tensor:
    """The LM head (D, V_pad) in the compute dtype: the tied embedding's
    transpose, or ``lm_head``."""
    return (params["embed"].t() if cfg.tie_embeddings else params["lm_head"]).to(cfg.compute_dtype)


def head_logits(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """Final hidden states -> logits over the padded vocabulary: ``x @
    head`` in the compute dtype, widened to f32; under a model group the
    rank's vocabulary columns, gathered whole."""
    return L.wide(gather_from_model(x @ _head(params, cfg), -1, tag="head"))


def decode_step(params: Mapping[str, torch.Tensor], tokens: torch.Tensor, caches: tuple, cfg,
                window: Optional[int] = None) -> Tuple[torch.Tensor, tuple]:
    """One decode step: tokens (B, 1) -> (logits (B, 1, V_pad) f32, the
    caches), the caches updated in place and their ``pos`` advanced by one.
    The position is read from the first cache (every layer's ``pos`` moves
    together) and stays on the device."""
    pos = caches[0].pos[0]
    positions = pos.expand(tokens.shape[0], 1)
    x, _ = forward(params, {"tokens": tokens}, cfg, window, caches=caches, positions=positions)
    out = head_logits(params, x, cfg)
    for c in caches:
        c.pos.add_(1)
    return out, caches


def _ce_chunk(xc, lc, head):
    logits = L.wide(xc @ head)
    if current() is not None:
        return vocab_parallel_ce(logits, lc)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum(logz - picked)


def train_loss(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
               cfg, window: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross-entropy plus the MoE aux loss, the CE computed
    per sequence chunk of ``CE_SEQ_CHUNK`` so the (B, S, V) logits never
    exist at once.  A frontend model's loss covers the token span only (its
    frontend positions are context)."""
    x, aux = forward(params, batch, cfg, window)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = batch["tokens"][:, 1:]
        x = x[:, :-1]
    if cfg.frontend != "none" and "tokens" in batch and x.shape[1] != labels.shape[1]:
        x = x[:, -labels.shape[1]:]                      # drop the frontend positions
    head = _head(params, cfg)
    x = copy_to_model(x)     # the head is column-parallel over a model group
    s, cs = x.shape[1], CE_SEQ_CHUNK
    if s > cs and s % cs == 0:
        total = sum(checkpoint(_ce_chunk, x[:, i:i + cs], labels[:, i:i + cs], head,
                               use_reentrant=False) for i in range(0, s, cs))
    else:
        total = _ce_chunk(x, labels, head)
    return total / labels.numel() + aux


def count_params(params: Mapping[str, torch.Tensor]) -> int:
    return sum(x.numel() for x in params.values())


def count_active_params(cfg, params: Mapping[str, torch.Tensor]) -> int:
    """Active parameters per token (MoE: ``top_k`` of ``n_experts``; the
    router counts whole)."""
    total = count_params(params)
    if cfg.moe is None:
        return total
    moe_leaves = sum(x.numel() for p, x in params.items()
                     if any(p.startswith(f"blocks/layer{i}/mlp/")
                            for i, spec in enumerate(cfg.pattern) if spec.mlp == "moe")
                     and p.rsplit("/", 1)[-1] != "router")
    frac = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - moe_leaves * (1 - frac))


def model_flops_per_token(cfg, params: Mapping[str, torch.Tensor]) -> float:
    """``6 * N_active`` per token."""
    return 6.0 * count_active_params(cfg, params)


class Transformer(nn.Module):
    """The parameter tree as an ``nn.ParameterDict`` keyed by path; calling
    the module returns the training loss of a batch."""

    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ParameterDict(
            {k: v if isinstance(v, nn.Parameter) else nn.Parameter(v) for k, v in params.items()})

    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return train_loss(self.params, batch, self.cfg)
