"""Compression operators behind DIANA's aggregation loop (ternary family,
natural compression, rand-k, top-k with error feedback, and the uncompressed
identity baseline)."""

from .base import Compressor, Payload, payload_nbits
from .identity import IdentityCompressor
from .natural import NaturalCompressor
from .randk import RandKCompressor
from .registry import alias, available_methods, canonical_name, make_compressor, register
from .ternary import TernaryCompressor
from .topk_ef import TopKEFCompressor

__all__ = ["Compressor", "IdentityCompressor", "NaturalCompressor", "Payload", "RandKCompressor",
           "TernaryCompressor", "TopKEFCompressor", "alias", "available_methods",
           "canonical_name", "make_compressor", "payload_nbits", "register"]
