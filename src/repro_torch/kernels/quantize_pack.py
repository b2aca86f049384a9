"""Fused block p-quantization + 2-bit pack on the card, with pre-drawn bits
or with the bits drawn in the kernel.

Replaces ``src/repro/kernels/quantize_pack.py:quantize_pack`` and
``:quantize_pack_prng`` (Pallas TPU kernels; ``pallas_call`` at ``:126`` and
``:177``) with ``csrc/quantize_pack.cu``: one warp per quantization row
reduces the row's ``||.||_p`` scale, then each lane turns groups of 4
consecutive coordinates (16-byte loads of delta, and pre-drawn bits or
threefry words computed in registers) into packed bytes.  Any block size
that is a multiple of 4 (the 2-bit packing's unit): the trainer's 2048 and
the convex harness's 8-64 alike.

The in-kernel generator is counter-mode threefry2x32, the JAX package's
``jax.random.bits``: segment ``i`` of the rows draws
``bits(keys[i], (m_i, B))``.  So :func:`quantize_pack_prng` equals
:func:`quantize_pack` fed those draws, bit for bit (the TPU kernel's own
stream is equal to it only in distribution).

Bound: bytes, ~8.25 B per coordinate with pre-drawn bits (4 B delta + 4 B
bits + 0.25 B codes); with the generator 4.25 B and the cipher's 68 integer
instructions per coordinate, which bound it at the SMs' dispatch rate.
Plain versions:
:func:`repro_torch.kernels.ref.ref_quantize_pack` and
``ref_quantize_pack_prng`` — bitwise for p = inf (a max does not depend on
order); for p in {1, 2} the sums run in another order than torch's, so
scales agree to a few ulp and codes on all but the coordinates whose
uniform falls between the two probabilities.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_quantize_pack, ref_quantize_pack_prng
from .threefry import key_table

__all__ = ["quantize_pack", "quantize_pack_prng", "plain", "norm_kind"]

plain = {"quantize_pack": ref_quantize_pack, "quantize_pack_prng": ref_quantize_pack_prng}


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


def _check_delta(delta: torch.Tensor, name: str) -> torch.Tensor:
    if not delta.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel; got {delta.device}")
    if delta.dim() != 2 or delta.dtype != torch.float32:
        raise ValueError(f"{name}: delta must be (m, B) float32, got {tuple(delta.shape)} "
                         f"{delta.dtype}")
    if delta.shape[1] % 4 or delta.shape[1] == 0:
        raise ValueError(f"block size {delta.shape[1]} must be a positive multiple of 4")
    delta = delta.contiguous()
    if delta.data_ptr() % 16:
        raise ValueError(f"{name}: delta must be 16-byte aligned")
    return delta


def _norm_args(p: float):
    kind = norm_kind(p)
    return kind, (1.0 if kind != 3 else float(p)), (1.0 if kind != 3 else 1.0 / p)


def quantize_pack(delta: torch.Tensor, bits: torch.Tensor, *, p: float):
    """delta (m, B) f32, bits (m, B) int32 (the uint32 pattern), both
    contiguous on one CUDA device -> (packed (m, B/4) uint8, scales (m, 1) f32)."""
    delta = _check_delta(delta, "quantize_pack")
    if bits.shape != delta.shape or bits.dtype != torch.int32 or bits.device != delta.device:
        raise ValueError(f"quantize_pack: bits must be int32 shaped like delta "
                         f"{tuple(delta.shape)} on its device, got {tuple(bits.shape)} "
                         f"{bits.dtype}")
    bits = bits.contiguous()
    if bits.data_ptr() % 16:
        raise ValueError("quantize_pack: bits must be 16-byte aligned")
    m, b = delta.shape
    packed = torch.empty((m, b // 4), dtype=torch.uint8, device=delta.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=delta.device)
    kind, pf, inv_p = _norm_args(p)
    check(library().quantize_pack(delta.data_ptr(), bits.data_ptr(), packed.data_ptr(),
                                  scales.data_ptr(), m, b, kind, pf, inv_p,
                                  stream_ptr(delta.device)), "quantize_pack")
    LAUNCHES["quantize_pack"] += 1
    return packed, scales


def quantize_pack_prng(delta: torch.Tensor, keys: torch.Tensor, seg_rows: Sequence[int], *,
                       p: float):
    """delta (m, B) f32, contiguous on a CUDA device; keys (nseg, 2) (the
    port's int64 key words) and ``seg_rows`` (nseg row counts summing to m):
    rows of segment ``i`` draw ``bits(keys[i], (seg_rows[i], B))`` in the
    kernel -> (packed (m, B/4) uint8, scales (m, 1) f32)."""
    delta = _check_delta(delta, "quantize_pack_prng")
    m, b = delta.shape
    if sum(seg_rows) != m:
        raise ValueError(f"quantize_pack_prng: segments of {list(seg_rows)} rows do not "
                         f"cover the {m} rows")
    words, starts, nseg = key_table(keys, seg_rows)
    packed = torch.empty((m, b // 4), dtype=torch.uint8, device=delta.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=delta.device)
    kind, pf, inv_p = _norm_args(p)
    check(library().quantize_pack_prng(delta.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                                       m, b, kind, pf, inv_p, words, starts, nseg,
                                       stream_ptr(delta.device)), "quantize_pack_prng")
    LAUNCHES["quantize_pack_prng"] += 1
    return packed, scales
