"""Compression configuration — a frozen, hashable factory over the registry.

The port's copy of ``repro.core.compression.CompressionConfig`` with the
fields the flat (uniform, uplink-only) round reads.  VR, the downlink,
participation and the chunked/hierarchical schedules are later slices
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from .compressors import make_compressor
from .compressors.registry import canonical_name

__all__ = ["CompressionConfig", "payload_bits_per_dim"]


@dataclass(frozen=True)
class CompressionConfig:
    """method:     ``diana`` / ``qsgd`` / ``terngrad`` / ``dqgd`` / ``ternary`` /
                ``natural`` / ``randk`` (``rand-k``) / ``topk_ef`` (``top-k-ef``) /
                ``identity`` (``none``)
    p:          quantization norm power (``math.inf``, 2.0, 1.0, or > 2)
    block_size: quantization block d_l (Def. 2; ternary only)
    alpha:      memory learning rate override (None: alpha_p/2, Cor. 1, for
                ternary; 8/9 for natural; k/d per leaf for rand-k)
    k:          kept coordinates per leaf for rand-k / top-k
    h_dtype:    dtype of the DIANA memories
    bucketed:   aggregate the whole model as ONE flat buffer (bitwise the
                per-leaf layout; the flag selects the execution layout)"""

    method: str = "diana"
    p: float = math.inf
    block_size: int = 2048
    alpha: Optional[float] = None
    k: int = 64
    h_dtype: torch.dtype = torch.float32
    bucketed: bool = False

    def __post_init__(self):
        canonical_name(self.method)  # raises on unknown methods
        if self.block_size % 4:
            raise ValueError("block_size must be a multiple of 4 for 2-bit packing")

    def make(self):
        """The configured compressor (memoized: compressors are stateless)."""
        return _make_cached(self)


@functools.lru_cache(maxsize=None)
def _make_cached(cfg: CompressionConfig):
    return make_compressor(cfg)


def payload_bits_per_dim(cfg: CompressionConfig, d: Optional[int] = None) -> float:
    """Communication cost per coordinate of the configured operator."""
    return cfg.make().bits_per_dim(d)
