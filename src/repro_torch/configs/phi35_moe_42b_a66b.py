"""phi3.5-moe-42b-a6.6b — Microsoft Phi-3.5-MoE.

[hf:microsoft/Phi-3.5-MoE-instruct] — 32L, d_model=4096, 32 heads (GQA kv=8),
per-expert d_ff=6400, vocab=32064, 16 experts top-2.

16 experts divide the 16-wide model axis exactly -> expert parallelism.
42B total params: the DIANA memories are kept in bf16 (``h_dtype``).  The JAX
package's worker axes (``comp_worker_axes``) have no counterpart here: the port
has one worker axis.
"""

import torch

from .base import LayerSpec, ModelConfig, MoEConfig, register


@register("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        arch_type="moe",
        citation="hf:microsoft/Phi-3.5-MoE-instruct",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab=32064,
        act="swiglu",
        pattern=(LayerSpec(mixer="attn", mlp="moe"),),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400, partition="expert"),
        sliding_window=8192,          # engaged only by long_500k
        h_dtype=torch.bfloat16,
    )
