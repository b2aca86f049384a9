"""internvl2-2b — InternVL2: InternViT vision encoder + InternLM2 decoder.

[arXiv:2404.16821] — LM backbone: 24L, d_model=2048, 16 heads (GQA kv=8),
d_ff=8192, vocab=92553.  The InternViT encoder + MLP projector is a STUB:
``input_specs`` supplies precomputed patch embeddings (B, 256, 1024); the
language decoder that consumes them is fully implemented (allowed carve-out).
"""

from .base import ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        arch_type="vlm",
        citation="arXiv:2404.16821",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=92553,
        act="swiglu",
        frontend="vision",
        frontend_tokens=256,
        sliding_window=8192,          # engaged only by long_500k
    )
