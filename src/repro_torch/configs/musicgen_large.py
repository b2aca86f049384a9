"""musicgen-large — Meta MusicGen, decoder-only over EnCodec tokens.

[arXiv:2306.05284] — 48L, d_model=2048, 32 heads (MHA kv=32), d_ff=8192,
vocab=2048 (EnCodec codebook).  The EnCodec/conv frontend is a STUB:
``input_specs`` supplies precomputed frame embeddings (B, frames, 128) that a
learned projector lifts to d_model; the transformer backbone is fully
implemented (the allowed carve-out).
"""

from .base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        arch_type="audio",
        citation="arXiv:2306.05284",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=2048,
        act="gelu",
        frontend="audio",
        frontend_tokens=256,
        sliding_window=8192,          # engaged only by long_500k
    )
