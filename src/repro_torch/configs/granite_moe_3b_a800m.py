"""granite-moe-3b-a800m — IBM Granite 3.0 MoE family.

[hf:ibm-granite/granite-3.0-1b-a400m-base] — 32L, d_model=1536, 24 heads
(GQA kv=8), per-expert d_ff=512, vocab=49155, 40 experts top-8.

40 experts do not divide the 16-wide model axis, so experts are
tensor-parallel over their d_ff in the JAX package (``partition="ffn"``); the
port runs every expert on one device.  Every layer is MoE (a800m active).
"""

from .base import LayerSpec, ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        arch_type="moe",
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab=49155,
        act="swiglu",
        pattern=(LayerSpec(mixer="attn", mlp="moe"),),
        moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, partition="ffn"),
        sliding_window=8192,          # engaged only by long_500k
        comp_block=2048,
        attn_q_chunk=512,             # 24 heads don't shard over model=16 ->
                                      # scores replicate; keep chunks small
        # Curated MoE policy (--comp-policy default): the router is tiny and
        # decides every token's expert assignment -> exact (a quantized
        # router reroutes tokens, compounding error); norms/biases exact;
        # embeddings top-k; the expert FFN bulk takes natural compression
        # (9 bits/dim, omega=1/8 — gentler than ternary on the sparsely-
        # activated expert gradients); everything else ternary.
        comp_policy=("router|scale$|bias=identity,"
                     "^embed$|^lm_head$=topk_ef:k=256,"
                     "mlp/w_=natural,"
                     "*=diana"),
    )
