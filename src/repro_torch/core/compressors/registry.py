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

A new operator is one :func:`register` call (and :func:`alias` for another
name of it).
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

__all__ = ["register", "alias", "make_compressor", "canonical_name", "available_methods"]

# canonical name -> factory(cfg, **alias_overrides) -> Compressor
_FACTORIES: Dict[str, Callable[..., Compressor]] = {}
# alias -> (canonical name, overrides)
_ALIASES: Dict[str, Tuple[str, dict]] = {}


def register(name: str):
    """Register a compressor factory ``f(cfg, **overrides) -> Compressor``
    under ``name`` (a decorator); the name is then reachable from
    ``CompressionConfig(method=...)``, ``down_method=`` and the trainer CLI."""

    def deco(factory):
        _FACTORIES[name] = factory
        return factory

    return deco


def alias(name: str, canonical: str, **overrides):
    """Map a legacy or alternate method string onto a canonical operator
    with the factory keyword overrides ``overrides``."""
    _ALIASES[name] = (canonical, overrides)


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
    if cfg.method in _ALIASES:
        name, overrides = _ALIASES[cfg.method]
    else:
        name, overrides = cfg.method, {}
    if name not in _FACTORIES:
        raise KeyError(f"unknown compression method {cfg.method!r}; "
                       f"choose from {available_methods()}")
    return _FACTORIES[name](cfg, **overrides)


@register("ternary")
def _ternary(cfg, *, p=None, memory=True):
    return TernaryCompressor(p=cfg.p if p is None else p, block_size=cfg.block_size,
                             alpha=cfg.alpha, memory=memory)


@register("natural")
def _natural(cfg, *, memory=True):
    return NaturalCompressor(alpha=cfg.alpha, memory=memory)


@register("randk")
def _randk(cfg, *, memory=True):
    return RandKCompressor(cfg.k, alpha=cfg.alpha, memory=memory)


@register("topk_ef")
def _topk_ef(cfg):
    return TopKEFCompressor(cfg.k)


@register("identity")
def _identity(cfg):
    return IdentityCompressor()


alias("diana", "ternary", memory=True)
alias("qsgd", "ternary", p=2.0, memory=False)
alias("terngrad", "ternary", p=math.inf, memory=False)
alias("dqgd", "ternary", memory=False)
alias("none", "identity")
alias("rand-k", "randk")
alias("top-k-ef", "topk_ef")
