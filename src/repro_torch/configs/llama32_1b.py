"""llama3.2-1b — Meta Llama 3.2 1B.

[hf:meta-llama/Llama-3.2-1B] — 16L, d_model=2048, 32 heads (GQA kv=8),
d_ff=8192, vocab=128256, rope theta 500k.
"""

from .base import ModelConfig, register


@register("llama3.2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        arch_type="dense",
        citation="hf:meta-llama/Llama-3.2-1B",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=128256,
        act="swiglu",
        rope_theta=500_000.0,
        sliding_window=8192,          # engaged only by long_500k
        # Curated transformer policy (--comp-policy default): norms/biases
        # are tiny and conditioning-critical -> exact; embedding/unembedding
        # gradients are token-sparse -> top-k with error feedback; the dense
        # bulk runs the paper's ternary operator.  Theory-optimal per Def. 2:
        # each group's rate is governed by its own alpha_p(d_l).
        comp_policy=("scale$|bias=identity,"
                     "^embed$|^lm_head$=topk_ef:k=256,"
                     "*=diana"),
    )
