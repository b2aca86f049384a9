"""Natural-compression encode on the card.

Replaces ``src/repro/kernels/nat_pack.py:nat_pack`` (the Pallas TPU kernel;
``pallas_call`` at ``:119``) with ``csrc/nat_pack.cu``: each thread turns 4
coordinates (one float4 of x, one uint4 of bits) into 4 int16 codes, read
off the float's exponent and mantissa bits.

Bound: bytes, 10 B per coordinate (4 B x + 4 B bits in, 2 B codes out).
Plain version: :func:`repro_torch.kernels.ref.ref_nat_pack` (frexp), bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_nat_pack as plain

__all__ = ["nat_pack", "plain"]


def nat_pack(x: torch.Tensor, bits: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (d,) f32, bits (d,) int32 (the uint32 pattern), both contiguous on
    one CUDA device -> (d,) int16 codes, written into ``out`` when given (a
    contiguous (d,) int16 tensor on that device, e.g. a worker's row of a
    gathered buffer; any 2-byte alignment)."""
    if not x.is_cuda:
        raise ValueError(f"nat_pack launches a CUDA kernel; got {x.device}")
    if x.dim() != 1 or bits.shape != x.shape:
        raise ValueError(f"nat_pack: x {tuple(x.shape)} and bits {tuple(bits.shape)} must "
                         "be the same (d,) shape")
    if x.dtype != torch.float32 or bits.dtype != torch.int32 or bits.device != x.device:
        raise ValueError("nat_pack: x must be float32 and bits int32, on one device")
    x, bits = x.contiguous(), bits.contiguous()
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    elif (out.dtype != torch.int16 or out.shape != x.shape or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError("nat_pack: out must be a contiguous int16 tensor shaped like x "
                         "on its device")
    check(library().nat_pack(x.data_ptr(), bits.data_ptr(), out.data_ptr(), x.numel(),
                             stream_ptr(x.device)), "nat_pack")
    LAUNCHES["nat_pack"] += 1
    return out
