"""Counter-mode threefry2x32 bits on the card (CUDA helper).

Replaces the XLA threefry that ``TernaryCompressor._batched_bits`` draws with
(``src/repro/core/compressors/ternary.py:167``); it is no Pallas kernel.  The
plain int64 emulation (:func:`repro_torch.core.prng.bits`, in passes of
16 M counters) runs the 20 rounds as int64 tensor operations, ~300x the
kernel's time at the largest bucket segment (``embed``, 268 M words;
PERF.md's kernel table), so the trainer draws on the card with
``csrc/threefry.cu``: native uint32, one thread per output word.

Bound: bytes written (4 B per word) or the cipher's 68 integer instructions
per word at the SMs' dispatch rate, whichever is larger on the card.  Plain version: ``prng.bits``.

The ternary and natural encodes draw their bits inside their kernels from
the same cipher (``csrc/threefry.cuh``); :func:`key_table` packs their
per-segment keys into the launch's parameters.  On the trainer's path this
helper then draws only rand-k's tags.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import prng

from .build import LAUNCHES, check, library, stream_ptr

__all__ = ["threefry_bits", "plain", "key_table", "MAX_SEGMENTS"]

plain = prng.bits

MAX_SEGMENTS = 128  # csrc/threefry.cuh kMaxSegments: the key table's capacity


def key_table(keys: torch.Tensor, sizes: Sequence[int]) -> Tuple[object, object, int]:
    """The in-kernel generators' key table as host arrays for the C entry
    points: segment ``i`` (``sizes[i]`` units, in order) draws from
    ``keys[i]``.  Returns ``(words (nseg, 2) uint32, starts (nseg + 1,)
    int64, nseg)``.  Raises when the table exceeds the kernels' capacity (no
    fallback)."""
    keys = keys.reshape(-1, 2)
    nseg = len(sizes)
    if keys.shape[0] != nseg or nseg < 1:
        raise ValueError(f"key table: {keys.shape[0]} keys for {nseg} segments")
    if nseg > MAX_SEGMENTS:
        raise ValueError(f"key table: {nseg} segments exceed the kernels' capacity of "
                         f"{MAX_SEGMENTS}")
    if any(s < 0 for s in sizes):
        raise ValueError(f"key table: negative segment size in {list(sizes)}")
    words = [int(w) & prng.MASK for w in keys.reshape(-1).tolist()]
    starts = [0]
    for s in sizes:
        starts.append(starts[-1] + int(s))
    return ((ctypes.c_uint32 * (2 * nseg))(*words), (ctypes.c_longlong * (nseg + 1))(*starts),
            nseg)


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
