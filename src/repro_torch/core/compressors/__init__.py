"""Compression operators behind DIANA's aggregation loop (ternary family,
natural compression, rand-k, top-k with error feedback, and the uncompressed
identity baseline)."""

from .base import Compressor, Payload
from .identity import IdentityCompressor
from .natural import NaturalCompressor
from .randk import RandKCompressor
from .registry import available_methods, canonical_name, make_compressor
from .ternary import TernaryCompressor
from .topk_ef import TopKEFCompressor

__all__ = ["Compressor", "IdentityCompressor", "NaturalCompressor", "Payload", "RandKCompressor",
           "TernaryCompressor", "TopKEFCompressor", "available_methods", "canonical_name",
           "make_compressor"]
