"""Dense decoder-only transformer: embeddings, the block stack, LM head, and
the chunked next-token cross-entropy.

Parameters keep the JAX package's tree (``repro.models.transformer``):
``embed`` (V_pad, D), ``final_norm/scale``, ``lm_head`` (D, V_pad), and every
block leaf stacked over ``n_blocks`` under ``blocks/layer0/...`` — one
``nn.Parameter`` per leaf, keyed by its path.  The bucket layout and the
per-leaf PRNG keys follow that tree's leaf order, so any other layout would
break payload parity with the JAX package.

``remat="full"`` recomputes each block in the backward
(``torch.utils.checkpoint``), like ``jax.checkpoint`` around the scanned block.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Mapping

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from . import layers as L

__all__ = ["init_model", "param_shapes", "Transformer", "forward", "train_loss",
           "CE_SEQ_CHUNK", "BLOCK"]

BLOCK = "blocks/layer0/"
CE_SEQ_CHUNK = 512


def _block_shapes(cfg) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = {
        "norm1/scale": (d,), "norm2/scale": (d,),
        "mixer/wq": (d, h * dh), "mixer/wk": (d, hkv * dh),
        "mixer/wv": (d, hkv * dh), "mixer/wo": (h * dh, d),
        "mlp/w_in": (d, f), "mlp/w_out": (f, d),
    }
    if cfg.act != "swiglu":
        raise NotImplementedError(f"activation {cfg.act!r} comes with the other model "
                                  "families (ROADMAP.md queue 1)")
    shapes["mlp/w_gate"] = (d, f)
    return shapes


def param_shapes(cfg) -> Dict[str, tuple]:
    """``{path: shape}`` of the parameter tree (block leaves stacked)."""
    d, vpad, nb = cfg.d_model, cfg.padded_vocab, cfg.n_blocks
    shapes = {"embed": (vpad, d), "final_norm/scale": (d,), "lm_head": (d, vpad)}
    shapes.update({BLOCK + n: (nb, *s) for n, s in _block_shapes(cfg).items()})
    return shapes


def init_model(cfg, device, seed: int = 0) -> Dict[str, nn.Parameter]:
    """Random weights from a ``torch.Generator`` (the JAX package's scales,
    not its numbers: parity tests load JAX weights through ``convert.py``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff
    deep = math.sqrt(2 * cfg.n_layers)
    std = {"embed": 0.02, "lm_head": 0.02,
           BLOCK + "mixer/wq": 1 / math.sqrt(d), BLOCK + "mixer/wk": 1 / math.sqrt(d),
           BLOCK + "mixer/wv": 1 / math.sqrt(d), BLOCK + "mixer/wo": 1 / math.sqrt(d) / deep,
           BLOCK + "mlp/w_in": 1 / math.sqrt(d), BLOCK + "mlp/w_gate": 1 / math.sqrt(d),
           BLOCK + "mlp/w_out": 1 / math.sqrt(f) / deep}
    params = {}
    for path, shape in param_shapes(cfg).items():
        if path.endswith("scale"):
            x = torch.ones(shape, device=device)
        else:
            x = torch.randn(shape, generator=gen, device=device) * std[path]
        params[path] = nn.Parameter(x.to(cfg.param_dtype))
    return params


def _block(x, positions, lp, cfg):
    h = L.rms_norm(lp["norm1/scale"], x, cfg.norm_eps)
    x = x + L.attention({k[6:]: v for k, v in lp.items() if k.startswith("mixer/")},
                        h, cfg, positions)
    h2 = L.rms_norm(lp["norm2/scale"], x, cfg.norm_eps)
    return x + L.mlp({k[4:]: v for k, v in lp.items() if k.startswith("mlp/")}, h2, cfg)


def forward(params: Mapping[str, torch.Tensor], tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, D) after the final norm."""
    b, s = tokens.shape
    x = torch.nn.functional.embedding(tokens.long(), params["embed"].to(cfg.compute_dtype))
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    names = list(_block_shapes(cfg))
    stacked = {n: params[BLOCK + n].unbind(0) for n in names}
    body = partial(_block, cfg=cfg)
    for i in range(cfg.n_blocks):
        lp = {n: stacked[n][i] for n in names}
        if cfg.remat == "full":
            x = checkpoint(body, x, positions, lp, use_reentrant=False)
        else:
            x = body(x, positions, lp)
    return L.rms_norm(params["final_norm/scale"], x, cfg.norm_eps)


def _ce_chunk(xc, lc, head):
    logits = (xc @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum(logz - picked)


def train_loss(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
               cfg) -> torch.Tensor:
    """Mean next-token cross-entropy, computed per sequence chunk of
    ``CE_SEQ_CHUNK`` so the (B, S, V) logits never exist at once."""
    x = forward(params, batch["tokens"], cfg)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = batch["tokens"][:, 1:]
        x = x[:, :-1]
    head = params["lm_head"].to(cfg.compute_dtype)
    s, cs = x.shape[1], CE_SEQ_CHUNK
    if s > cs and s % cs == 0:
        total = sum(checkpoint(_ce_chunk, x[:, i:i + cs], labels[:, i:i + cs], head,
                               use_reentrant=False) for i in range(0, s, cs))
    else:
        total = _ce_chunk(x, labels, head)
    return total / labels.numel()


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
