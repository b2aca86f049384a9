"""jamba-v0.1-52b — AI21 Jamba: Mamba + attention 1:7 interleave, MoE.

[arXiv:2403.19887] — 32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=65536, 16 experts top-2.  Block period 8: one attention layer per 7
mamba layers (attention at in-block index 3), MoE replacing the MLP on every
other layer (odd indices) — 4 stacked super-blocks of 8.

Sub-quadratic natively (mamba carries long context; the 4 attention layers
keep full 500k KV caches, sequence-sharded over the data axes in decode).
"""

import torch

from .base import LayerSpec, ModelConfig, MoEConfig, SSMConfig, register


def _pattern():
    specs = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, mlp=mlp))
    return tuple(specs)


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        citation="arXiv:2403.19887",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=65536,
        act="swiglu",
        pattern=_pattern(),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, partition="expert"),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk_size=256),
        h_dtype=torch.bfloat16,
    )
