"""The assigned input shapes, which of them an architecture can run, and
the input layout of a batch (the port's copy of ``repro.configs.shapes``).

Decode shapes run the serve step (ONE new token per sequence against a
KV/SSM cache of ``seq_len``); train and prefill shapes run the forward over
the whole sequence.  ``long_500k`` takes each architecture's sub-quadratic
path: native for SSM and hybrid models, the sliding window
(``cfg.sliding_window``) for attention models.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .base import ModelConfig, ShapeConfig

__all__ = ["SHAPES", "FRONTEND_DIM", "get_shape", "shape_applicable", "input_shapes",
           "input_specs"]

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}

FRONTEND_DIM = {"vision": 1024, "audio": 128}   # stub encoder output dims


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason).  long_500k needs a sub-quadratic path."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, (
            f"{cfg.name} is pure full-attention with no sliding_window configured; "
            "long_500k requires a sub-quadratic variant (DESIGN.md §Arch-applicability)"
        )
    return True, ""


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of every model input (the JAX package's ``input_specs``).

    train / prefill: the whole (B, S) batch; a frontend model gets its stub
    embeddings for a ``cfg.frontend_tokens`` prefix and tokens for the rest,
    and a train shape adds the labels.  decode: one token per sequence (the
    cache is serving state, not input)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": (b, 1)}
    out: Dict[str, Tuple[int, ...]] = {}
    s_tokens = s
    if cfg.frontend in FRONTEND_DIM:
        out[f"{cfg.frontend}_embeds"] = (b, cfg.frontend_tokens, FRONTEND_DIM[cfg.frontend])
        s_tokens = s - cfg.frontend_tokens
    out["tokens"] = (b, s_tokens)
    if shape.kind == "train":
        out["labels"] = (b, s_tokens)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                                         torch.dtype]]:
    """``{name: (shape, dtype)}`` of every model input: the JAX package's
    ``ShapeDtypeStruct`` stand-ins (f32 frontend embeddings, int32 tokens and
    labels)."""
    return {name: (dims, torch.float32 if name.endswith("_embeds") else torch.int32)
            for name, dims in input_shapes(cfg, shape).items()}
