"""The assigned input shapes and the input layout of a training batch."""

from __future__ import annotations

from typing import Dict, Tuple

from .base import ModelConfig, ShapeConfig

__all__ = ["SHAPES", "FRONTEND_DIM", "get_shape", "input_shapes"]

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
}

FRONTEND_DIM = {"vision": 1024, "audio": 128}   # stub encoder output dims


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise NotImplementedError(
            f"shape {name!r} is not ported yet (prefill/decode shapes come with "
            f"serving, ROADMAP.md queue 1); available: {sorted(SHAPES)}")
    return SHAPES[name]


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of every model input of a train/prefill batch (the JAX
    package's ``input_specs``): a frontend model gets its stub embeddings
    for a ``cfg.frontend_tokens`` prefix and tokens for the rest."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Tuple[int, ...]] = {}
    s_tokens = s
    if cfg.frontend in FRONTEND_DIM:
        out[f"{cfg.frontend}_embeds"] = (b, cfg.frontend_tokens, FRONTEND_DIM[cfg.frontend])
        s_tokens = s - cfg.frontend_tokens
    out["tokens"] = (b, s_tokens)
    if shape.kind == "train":
        out["labels"] = (b, s_tokens)
    return out

