"""Compression operators behind DIANA's aggregation loop (ternary family,
natural compression)."""

from .base import Compressor, Payload
from .natural import NaturalCompressor
from .registry import available_methods, canonical_name, make_compressor
from .ternary import TernaryCompressor

__all__ = ["Compressor", "NaturalCompressor", "Payload", "TernaryCompressor",
           "available_methods", "canonical_name", "make_compressor"]
