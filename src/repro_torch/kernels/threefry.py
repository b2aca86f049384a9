"""Counter-mode threefry2x32 bits on the card (CUDA helper).

Replaces the XLA threefry that ``TernaryCompressor._batched_bits`` draws with
(``src/repro/core/compressors/ternary.py:167``); it is no Pallas kernel.  The
plain int64 emulation (:func:`repro_torch.core.prng.bits`) needs ~2 GB per
int64 temporary at the largest bucket segment (``embed``, 268 M words), so
the trainer draws on the card with ``csrc/threefry.cu``: native uint32, one
thread per output word.

Bound: bytes written (4 B per word) or its ~110 integer ops per word,
whichever is larger on the card.  Plain version: ``prng.bits``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core import prng

from .build import LAUNCHES, check, library, stream_ptr

__all__ = ["threefry_bits", "plain"]

plain = prng.bits


def threefry_bits(key: torch.Tensor, shape: Sequence[int], device,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` drawn by the CUDA kernel into
    an int32 tensor (``out`` if given: contiguous int32 on ``device``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry_bits launches a CUDA kernel; got device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = math.prod(shape)
    if out is None:
        out = torch.empty(tuple(shape), dtype=torch.int32, device=device)
    if out.dtype != torch.int32 or not out.is_contiguous() or out.numel() != n \
            or out.device != device:
        raise ValueError("threefry_bits: out must be a contiguous int32 tensor of the "
                         "requested size on the requested device")
    k0, k1 = prng.key_words(key)
    check(library().threefry_bits(k0, k1, out.data_ptr(), n, stream_ptr(device)),
          "threefry_bits")
    LAUNCHES["threefry_bits"] += 1
    return out.reshape(tuple(shape))
