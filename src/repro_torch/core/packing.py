"""2-bit packing of ternary sign tensors.

Encoding: sign s in {-1, 0, +1} -> code (s + 1) in {0, 1, 2}, four codes per
uint8 byte, little-endian within the byte (code j at bits 2j..2j+1).  Code 3
is unused.  The same wire format as ``repro.core.packing``.
"""

from __future__ import annotations

import torch

__all__ = ["pack2bit", "unpack2bit", "packed_nbytes", "PACK_FACTOR"]

PACK_FACTOR = 4  # ternary values per byte
_SHIFTS = (0, 2, 4, 6)


def packed_nbytes(n: int) -> int:
    """Bytes needed for ``n`` ternary values."""
    return -(-n // PACK_FACTOR)


def pack2bit(signs: torch.Tensor) -> torch.Tensor:
    """Pack an integer {-1,0,1} tensor (..., B) into (..., B/4) uint8."""
    if signs.shape[-1] % PACK_FACTOR:
        raise ValueError(f"last dim {signs.shape[-1]} not a multiple of {PACK_FACTOR}")
    codes = (signs + 1).to(torch.uint8)
    g = codes.reshape(*codes.shape[:-1], -1, PACK_FACTOR)
    return g[..., 0] | (g[..., 1] << 2) | (g[..., 2] << 4) | (g[..., 3] << 6)


def unpack2bit(packed: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack2bit`; returns int8 {-1,0,1} with last dim 4x."""
    g = torch.stack([(packed >> s) & 3 for s in _SHIFTS], dim=-1)
    out = (g.to(torch.int8) - 1).reshape(*packed.shape[:-1], -1)
    if n is not None:
        out = out[..., :n]
    return out
