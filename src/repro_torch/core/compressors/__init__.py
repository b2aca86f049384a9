"""Compression operators behind DIANA's aggregation loop (ternary family)."""

from .base import Compressor, Payload
from .registry import available_methods, canonical_name, make_compressor
from .ternary import TernaryCompressor

__all__ = ["Compressor", "Payload", "TernaryCompressor", "available_methods",
           "canonical_name", "make_compressor"]
