"""nemotron-4-15b — NVIDIA Nemotron-4.

[arXiv:2402.16819] — 32L, d_model=6144, 48 heads (GQA kv=8), d_ff=24576,
vocab=256000, squared-ReLU MLP (no gate), RoPE.
"""

import torch

from .base import ModelConfig, register


@register("nemotron-4-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        arch_type="dense",
        citation="arXiv:2402.16819",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=256000,
        act="relu2",                  # squared ReLU
        rope_theta=10_000.0,
        sliding_window=8192,          # engaged only by long_500k
        h_dtype=torch.bfloat16,         # 15B: halve DIANA memory footprint
    )
