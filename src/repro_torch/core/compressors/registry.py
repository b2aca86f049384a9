"""Compressor registry: canonical names, legacy aliases, config -> instance.

Every operator of the JAX package's registry is ported: the ternary operator
with its legacy aliases (the paper's Sec. 3 special cases), natural
compression, the sparse operators and the uncompressed baseline:

    diana    -> ternary with memory            (Algorithm 1)
    qsgd     -> ternary p=2,   memory off      (Algorithm 2)
    terngrad -> ternary p=inf, memory off      (Algorithm 2)
    dqgd     -> ternary p=cfg, memory off      (Khirirat et al. 2018)
    natural  -> natural compression with memory (alpha 8/9)
    randk    -> rand-k with memory (alpha k/d per leaf); alias rand-k
    topk_ef  -> top-k with error feedback;          alias top-k-ef
    identity -> uncompressed f32 (32 bits/dim);     alias none
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

from .base import Compressor
from .identity import IdentityCompressor
from .natural import NaturalCompressor
from .randk import RandKCompressor
from .ternary import TernaryCompressor
from .topk_ef import TopKEFCompressor

__all__ = ["make_compressor", "canonical_name", "available_methods"]

_FACTORIES: Dict[str, Callable[..., Compressor]] = {}
_ALIASES: Dict[str, Tuple[str, dict]] = {}


def canonical_name(method: str) -> str:
    if method in _FACTORIES:
        return method
    if method in _ALIASES:
        return _ALIASES[method][0]
    raise KeyError(f"unknown compression method {method!r}; choose from {available_methods()}")


def available_methods() -> Tuple[str, ...]:
    return tuple(sorted(set(_FACTORIES) | set(_ALIASES)))


def make_compressor(cfg) -> Compressor:
    """Build the compressor a :class:`~repro_torch.core.compression.CompressionConfig` names."""
    name = canonical_name(cfg.method)
    overrides = _ALIASES[cfg.method][1] if cfg.method in _ALIASES else {}
    return _FACTORIES[name](cfg, **overrides)


def _ternary(cfg, *, p=None, memory=True):
    return TernaryCompressor(p=cfg.p if p is None else p, block_size=cfg.block_size,
                             alpha=cfg.alpha, memory=memory)


def _natural(cfg, *, memory=True):
    return NaturalCompressor(alpha=cfg.alpha, memory=memory)


def _randk(cfg, *, memory=True):
    return RandKCompressor(cfg.k, alpha=cfg.alpha, memory=memory)


def _topk_ef(cfg):
    return TopKEFCompressor(cfg.k)


def _identity(cfg):
    return IdentityCompressor()


_FACTORIES["ternary"] = _ternary
_FACTORIES["natural"] = _natural
_FACTORIES["randk"] = _randk
_FACTORIES["topk_ef"] = _topk_ef
_FACTORIES["identity"] = _identity
_ALIASES.update({
    "diana": ("ternary", {"memory": True}),
    "qsgd": ("ternary", {"p": 2.0, "memory": False}),
    "terngrad": ("ternary", {"p": math.inf, "memory": False}),
    "dqgd": ("ternary", {"memory": False}),
    "rand-k": ("randk", {}),
    "top-k-ef": ("topk_ef", {}),
    "none": ("identity", {}),
})
