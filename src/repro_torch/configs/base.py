"""Config dataclasses + the architecture registry (``--arch <id>``).

The port's own copy of ``repro.configs.base``: dtypes are torch dtypes, and
only the fields the dense transformer and the flat DIANA round read are kept.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import torch

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "register",
    "get_config",
    "reduced",
    "VOCAB_PAD",
]

VOCAB_PAD = 4096  # embedding tables padded to a multiple of this


@dataclass(frozen=True)
class ModelConfig:
    """A dense decoder-only transformer (every layer attention + MLP)."""

    name: str
    arch_type: str                 # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""
    head_dim: Optional[int] = None
    act: str = "swiglu"            # swiglu (the only activation ported so far)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "full"            # none | full (torch.utils.checkpoint per block)
    attn_q_chunk: int = 2048       # query-chunked attention above this seq len
    # --- DIANA / training defaults (overridable from the CLI) ---
    compression: str = "diana"
    comp_p: float = math.inf
    comp_block: int = 2048
    comp_k: int = 64               # kept coordinates per leaf for rand-k / top-k
    comp_bucketed: bool = True     # whole-model flat-buffer aggregation
    h_dtype: torch.dtype = torch.float32
    vr: bool = False               # VR-DIANA: L-SVRG control variates (core.vr)
    vr_p: Optional[float] = None   # snapshot-refresh probability (None: 1/m)
    comp_down_method: Optional[str] = None  # downlink operator (None: exact broadcast)
    comp_down_k: Optional[int] = None       # sparse downlink budget (None: comp_k)
    comp_policy: Optional[str] = None       # curated per-group policy (inline rules),
                                            # opt-in: --comp-policy default

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // VOCAB_PAD) * VOCAB_PAD

    @property
    def n_blocks(self) -> int:
        """Stacked blocks: one layer per block (the dense pattern has period 1)."""
        return self.n_layers


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
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP.md queue 1, 'other model "
            f"families'); available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, toy size (the JAX package's ``reduced`` for dense archs)."""
    n_heads = min(cfg.n_heads, 4)
    d_model = min(cfg.d_model, 256)
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=min(cfg.n_kv_heads, max(1, n_heads // 2)),
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) or cfg.d_ff,
        vocab=min(cfg.vocab, 512),
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        remat="none",
    )
