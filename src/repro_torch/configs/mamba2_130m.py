"""mamba2-130m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] — 24L, d_model=768, vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads.

Natively sub-quadratic: long_500k runs the recurrent decode with O(1) state.
DIANA applies unchanged (gradients are architecture-agnostic) — this arch
demonstrates the technique on a non-attention family.
"""

from .base import LayerSpec, ModelConfig, SSMConfig, register


@register("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        arch_type="ssm",
        citation="arXiv:2405.21060",
        n_layers=24,
        d_model=768,
        n_heads=24,                   # SSD heads (d_inner / head_dim)
        n_kv_heads=24,
        d_ff=0,                       # no MLP — mamba blocks only
        vocab=50280,
        pattern=(LayerSpec(mixer="mamba", mlp="none"),),
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256),
        comp_block=1024,              # smaller blocks for a 130M model
        # Curated SSM policy (--comp-policy default): the SSD dynamics
        # parameters (A_log/D/dt_bias), conv kernels and norms are tiny and
        # govern the recurrence's stability -> exact; embeddings top-k;
        # projections ternary at the model's block size.
        comp_policy=("A_log|dt_bias|/D$|scale$|conv_=identity,"
                     "^embed$|^lm_head$=topk_ef:k=256,"
                     "*=diana:block=1024"),
    )
