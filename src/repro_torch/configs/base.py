"""Config dataclasses + the architecture registry (``--arch <id>``).

The port's own copy of ``repro.configs.base``: dtypes are torch dtypes.  Two
fields of the JAX config stay out: ``scan_unroll`` (the port runs no
``lax.scan``: its block stack is a Python loop) and ``comp_worker_axes``
(the port has one worker axis).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = [
    "LayerSpec",
    "MoEConfig",
    "SSMConfig",
    "ModelConfig",
    "ShapeConfig",
    "register",
    "get_config",
    "list_archs",
    "reduced",
    "VOCAB_PAD",
]

VOCAB_PAD = 4096  # embedding tables padded to a multiple of this


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating block pattern."""

    mixer: str = "attn"   # attn | mamba
    mlp: str = "dense"    # dense | moe | none


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25
    partition: str = "expert"      # expert | ffn (a sharding choice of the JAX package)
    aux_loss_weight: float = 0.01
    token_chunk: int = 0           # 0 = MOE_TOKEN_CHUNK tokens per dispatch chunk


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""
    head_dim: Optional[int] = None
    act: str = "swiglu"            # swiglu | gelu | relu2
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: str = "none"         # none | vision | audio
    frontend_tokens: int = 256     # patch/frame positions supplied by the stub
    sliding_window: Optional[int] = None   # engaged only by long_500k
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "full"            # none | full (recompute each block) | dots (save the products)
    attn_q_chunk: int = 2048       # query-chunked attention above this seq len
    # --- DIANA / training defaults (overridable from the CLI) ---
    compression: str = "diana"
    comp_p: float = math.inf
    comp_block: int = 2048
    comp_k: int = 64               # kept coordinates per leaf for rand-k / top-k
    comp_bucketed: bool = True     # whole-model flat-buffer aggregation
    vr: bool = False               # VR-DIANA: L-SVRG control variates (core.vr)
    vr_p: Optional[float] = None   # snapshot-refresh probability (None: 1/m)
    comp_down_method: Optional[str] = None  # downlink operator (None: exact broadcast)
    comp_down_k: Optional[int] = None       # sparse downlink budget (None: comp_k)
    comp_policy: Optional[str] = None       # curated per-group policy (inline rules),
                                            # opt-in: --comp-policy default
    h_dtype: torch.dtype = torch.float32

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // VOCAB_PAD) * VOCAB_PAD

    @property
    def n_blocks(self) -> int:
        """Stacked blocks: the layers over the pattern's period."""
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible by "
                             f"pattern period {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    def has_attention(self) -> bool:
        return any(l.mixer == "attn" for l in self.pattern)

    def has_mamba(self) -> bool:
        return any(l.mixer == "mamba" for l in self.pattern)

    def supports_long_context(self) -> bool:
        """long_500k eligibility: SSM/hybrid natively; attention via sliding window."""
        return self.has_mamba() or self.sliding_window is not None


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401 — populate registry

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, toy size (the JAX package's ``reduced``): one pattern
    period (two layers for a period of one), d_model <= 256, <= 4 heads,
    <= 4 experts with ``capacity_factor = n_experts`` (no token drops), small
    SSM sizes, <= 16 frontend tokens, f32, no remat."""
    period = len(cfg.pattern)
    n_heads = min(cfg.n_heads, 4)
    d_model = min(cfg.d_model, 256)
    moe = cfg.moe and replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
                              top_k=min(cfg.moe.top_k, 2), d_ff=128,
                              capacity_factor=float(min(cfg.moe.n_experts, 4)))
    ssm = cfg.ssm and replace(cfg.ssm, d_state=32, head_dim=32, chunk_size=64)
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=period if period > 1 else 2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=min(cfg.n_kv_heads, max(1, n_heads // 2)),
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) or cfg.d_ff,
        vocab=min(cfg.vocab, 512),
        moe=moe,
        ssm=ssm,
        frontend_tokens=min(cfg.frontend_tokens, 16),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        remat="none",
    )
