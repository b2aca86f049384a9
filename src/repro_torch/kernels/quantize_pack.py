"""Fused block p-quantization + 2-bit pack on the card.

Replaces ``src/repro/kernels/quantize_pack.py:quantize_pack`` (the Pallas TPU
kernel; ``pallas_call`` at ``:126``) with ``csrc/quantize_pack.cu``: one
thread block per quantization row reduces the row's ``||.||_p`` scale, then
each thread turns 4 consecutive coordinates (one 16-byte load of delta and
one of bits) into one packed byte.

Bound: bytes, ~8.25 B per coordinate (4 B delta + 4 B bits + 0.25 B codes).
Plain version: :func:`repro_torch.kernels.ref.ref_quantize_pack` — bitwise
for p = inf (a max does not depend on order); for p in {1, 2} the sums run
in another order than torch's, so scales agree to a few ulp and codes on all
but the coordinates whose uniform falls between the two probabilities.
"""

from __future__ import annotations

import math

import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_quantize_pack as plain

__all__ = ["quantize_pack", "plain", "norm_kind"]


def norm_kind(p: float) -> int:
    """The kernel's norm selector: 0 = inf, 1 = p1, 2 = p2, 3 = general p."""
    if p == math.inf:
        return 0
    if p == 1:
        return 1
    if p == 2:
        return 2
    if p > 2:
        return 3
    raise ValueError(f"unsupported quantization norm power p={p}")


def quantize_pack(delta: torch.Tensor, bits: torch.Tensor, *, p: float):
    """delta (m, B) f32, bits (m, B) int32 (the uint32 pattern), both
    contiguous on one CUDA device -> (packed (m, B/4) uint8, scales (m, 1) f32)."""
    if not delta.is_cuda:
        raise ValueError(f"quantize_pack launches a CUDA kernel; got {delta.device}")
    if delta.dim() != 2 or bits.shape != delta.shape:
        raise ValueError(f"quantize_pack: delta {tuple(delta.shape)} and bits "
                         f"{tuple(bits.shape)} must be the same (m, B) shape")
    if delta.dtype != torch.float32 or bits.dtype != torch.int32:
        raise ValueError("quantize_pack: delta must be float32 and bits int32")
    if bits.device != delta.device:
        raise ValueError("quantize_pack: delta and bits on different devices")
    m, b = delta.shape
    if b % 128:
        raise ValueError(f"block size {b} must be a multiple of 128")
    delta, bits = delta.contiguous(), bits.contiguous()
    for t in (delta, bits):
        if t.data_ptr() % 16:
            raise ValueError("quantize_pack: inputs must be 16-byte aligned")
    packed = torch.empty((m, b // 4), dtype=torch.uint8, device=delta.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=delta.device)
    kind = norm_kind(p)
    pf = 1.0 if kind != 3 else float(p)
    inv_p = 1.0 if kind != 3 else 1.0 / p
    check(library().quantize_pack(delta.data_ptr(), bits.data_ptr(), packed.data_ptr(),
                                  scales.data_ptr(), m, b, kind, pf, inv_p,
                                  stream_ptr(delta.device)), "quantize_pack")
    LAUNCHES["quantize_pack"] += 1
    return packed, scales
