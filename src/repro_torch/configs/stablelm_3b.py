"""stablelm-3b — Stability AI StableLM-2 family scaled per assignment.

[hf:stabilityai/stablelm-2-1_6b] — 32L, d_model=2560, 32 heads (GQA kv=32,
i.e. MHA), d_ff=6912, vocab=50304.
"""

from .base import LayerSpec, ModelConfig, register


@register("stablelm-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        arch_type="dense",
        citation="hf:stabilityai/stablelm-2-1_6b",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab=50304,
        act="swiglu",
        rope_theta=10_000.0,
        sliding_window=8192,          # engaged only by long_500k
    )
