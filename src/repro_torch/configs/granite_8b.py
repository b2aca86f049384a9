"""granite-8b — IBM Granite Code 8B (llama architecture).

[arXiv:2405.04324] — 36L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=49152.
"""

from .base import ModelConfig, register


@register("granite-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        arch_type="dense",
        citation="arXiv:2405.04324",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=49152,
        act="swiglu",
        sliding_window=8192,          # engaged only by long_500k
    )
