"""Natural-compression encode on the card, with pre-drawn bits or with the
bits drawn in the kernel.

Replaces ``src/repro/kernels/nat_pack.py:nat_pack`` and ``:nat_pack_prng``
(Pallas TPU kernels; ``pallas_call`` at ``:119`` and ``:154``) with
``csrc/nat_pack.cu``: each coordinate becomes an int16 code read off the
float's exponent and mantissa bits (four per float4 of x, with one uint4
of pre-drawn bits, or with threefry words that a warp draws in registers
for a chunk of 512 coordinates).

The in-kernel generator is counter-mode threefry2x32, the JAX package's
``jax.random.bits``: coordinates of segment ``i`` draw
``bits(keys[i], (s_i,))``, each coordinate from its own segment's key (a
boundary can fall inside a group of 4).  So :func:`nat_pack_prng` equals
:func:`nat_pack` fed those draws, bit for bit.

Bound: bytes, 10 B per coordinate with pre-drawn bits (4 B x + 4 B bits in,
2 B codes out); with the generator 6 B and the cipher's 68 integer
instructions per coordinate, which bound it at the SMs' dispatch rate.
Plain versions: :func:`repro_torch.kernels.ref.ref_nat_pack`
(frexp) and ``ref_nat_pack_prng``, bitwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_nat_pack, ref_nat_pack_prng
from .threefry import key_table

__all__ = ["nat_pack", "nat_pack_prng", "plain"]

plain = {"nat_pack": ref_nat_pack, "nat_pack_prng": ref_nat_pack_prng}


def _out_for(x: torch.Tensor, out: Optional[torch.Tensor], name: str) -> torch.Tensor:
    if out is None:
        return torch.empty(x.shape, dtype=torch.int16, device=x.device)
    if (out.dtype != torch.int16 or out.shape != x.shape or out.device != x.device
            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous int16 tensor shaped like x on "
                         "its device")
    return out


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
    out = _out_for(x, out, "nat_pack")
    check(library().nat_pack(x.data_ptr(), bits.data_ptr(), out.data_ptr(), x.numel(),
                             stream_ptr(x.device)), "nat_pack")
    LAUNCHES["nat_pack"] += 1
    return out


def nat_pack_prng(x: torch.Tensor, keys: torch.Tensor, sizes: Sequence[int],
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (d,) f32 on a CUDA device; keys (nseg, 2) (the port's int64 key
    words) and ``sizes`` (nseg segment lengths summing to d, any alignment):
    coordinates of segment ``i`` draw ``bits(keys[i], (sizes[i],))`` in the
    kernel -> (d,) int16 codes, written into ``out`` when given (as for
    :func:`nat_pack`)."""
    if not x.is_cuda:
        raise ValueError(f"nat_pack_prng launches a CUDA kernel; got {x.device}")
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"nat_pack_prng: x must be (d,) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if sum(sizes) != x.numel():
        raise ValueError(f"nat_pack_prng: segments of {list(sizes)} coordinates do not cover "
                         f"the {x.numel()} coordinates")
    x = x.contiguous()
    out = _out_for(x, out, "nat_pack_prng")
    words, starts, nseg = key_table(keys, sizes)
    check(library().nat_pack_prng(x.data_ptr(), out.data_ptr(), x.numel(), words, starts, nseg,
                                  stream_ptr(x.device)), "nat_pack_prng")
    LAUNCHES["nat_pack_prng"] += 1
    return out
