"""The assigned input shapes and the input layout of a training batch."""

from __future__ import annotations

from typing import Dict, Tuple

from .base import ModelConfig, ShapeConfig

__all__ = ["SHAPES", "get_shape", "input_shapes"]

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
}


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise NotImplementedError(
            f"shape {name!r} is not ported yet (prefill/decode shapes come with "
            f"serving, ROADMAP.md queue 1); available: {sorted(SHAPES)}")
    return SHAPES[name]


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of every int32 model input of a text-only train batch."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": (b, s)}
    if shape.kind == "train":
        out["labels"] = (b, s)
    return out
