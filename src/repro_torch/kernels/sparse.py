"""Sparse (rand-k / top-k) payload kernels on the card: the compress-side
value gather and the scatter-add server decode (sum, or mean).

Replaces ``src/repro/kernels/sparse.py:sparse_gather``,
``:sparse_decode_sum`` and ``:sparse_decode_sum_mean`` (Pallas TPU kernels;
``pallas_call`` at ``:65``, ``:131``, ``:157``) with one source,
``csrc/sparse.cu``.  The gather takes 8 entries per thread, all 8 random
reads in flight before any store.  The decode sorts each kept entry into
the run of its (output tile of ``TILE`` floats, worker), in two levels
(coarse bins of ``COARSE`` floats, then tiles within a bin, a bin's run
taken ``CHUNK`` records per block so that a bin that holds many entries is
spread over many blocks), then one block
per tile accumulates its workers' ``values * scale`` in shared memory,
worker by worker in order (indices are unique within a worker: no atomics
on values, the reference's summation order), and writes the tile once,
divided by n for the mean: bitwise the plain versions in
``kernels/ref.py`` (the argument is in the source).  As in the JAX package
there is no fused memory update: with memory, rand-k's server rule
composes outside the kernel from the materialised sum.

Indices are the payload's unsigned words (uint8 / uint16 / uint32 by the
vector length, the JAX package's wire widths), read as they are.

Bound: bytes.  Gather: 12 B per entry.  Decode: 4 B per coordinate out
plus 8 B per entry and worker (index, value) and the (k,) scale.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_sparse_decode_sum, ref_sparse_decode_sum_mean, ref_sparse_gather

__all__ = ["sparse_gather", "sparse_decode_sum", "sparse_decode_sum_mean", "plain"]

plain = {
    "sparse_gather": ref_sparse_gather,
    "sparse_decode_sum": ref_sparse_decode_sum,
    "sparse_decode_sum_mean": ref_sparse_decode_sum_mean,
}

INDEX_DTYPES = (torch.uint8, torch.uint16, torch.uint32)
# The decode's widths, compile-time constants of csrc/sparse.cu (kTile,
# kCoarse, kChunk), mirrored here to size its scratch.
TILE = 16384         # output floats one block of the decode owns (64 KB of shared memory)
COARSE = 1 << 19     # floats of a coarse bin of the decode's first sorting level
CHUNK = 4096         # records of a coarse bin's run that one block of its sort takes
GROUP = 512          # workers the decode's passes take at a time (kGroup)


def decode_scratch(n: int, k: int, d: int) -> Dict[str, int]:
    """Element counts of the decode's scratch for ``n`` workers of ``k``
    entries into ``d`` coordinates: ``bins`` coarse bins of ``COARSE``
    floats (a count, a cursor and a first chunk each, and one more first
    chunk for the total), ``tiles`` output tiles of ``TILE`` floats (the last
    ones partial), a count, a start and a cursor per (tile, worker) ``run``,
    two buffers of ``records`` 8-byte records, one per entry (entries with an
    index >= d are dropped, so n * k is the most there can be), and the bin
    of each of at most ``chunks`` chunks of ``CHUNK`` records (every record
    in a chunk of its own bin's, plus one partial chunk per bin): 16 B per
    bin, 20 B per run, 16 B per record and 4 B per chunk in all."""
    bins = -(-d // COARSE)
    tiles = -(-d // TILE)
    runs = tiles * n
    records = n * k
    chunks = -(-records // CHUNK) + bins
    return {"bins": bins, "tiles": tiles, "runs": runs, "records": records, "chunks": chunks}


def _check_index(idx: torch.Tensor, name: str) -> None:
    if idx.dtype not in INDEX_DTYPES:
        raise ValueError(f"{name}: indices must be uint8, uint16 or uint32 (the wire "
                         f"widths), got {idx.dtype}")


def sparse_gather(x: torch.Tensor, idx: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (d,) f32, idx (k,) unsigned (entries < d), both on one CUDA device ->
    (k,) f32 ``x[idx]``, written into ``out`` when given (a contiguous (k,)
    f32 tensor there, e.g. a worker's row of a gathered payload)."""
    if not x.is_cuda:
        raise ValueError(f"sparse_gather launches a CUDA kernel; got {x.device}")
    _check_index(idx, "sparse_gather")
    if x.dim() != 1 or x.dtype != torch.float32 or idx.dim() != 1 or idx.device != x.device:
        raise ValueError("sparse_gather: x must be (d,) float32 and idx (k,), on one device")
    x, idx = x.contiguous(), idx.contiguous()
    k = idx.numel()
    if out is None:
        out = torch.empty(k, dtype=torch.float32, device=x.device)
    elif (out.dtype != torch.float32 or out.shape != (k,) or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError("sparse_gather: out must be a contiguous (k,) float32 tensor on "
                         "x's device")
    check(library().sparse_gather(x.data_ptr(), x.numel(), idx.data_ptr(), idx.itemsize, k,
                                  out.data_ptr(), stream_ptr(x.device)), "sparse_gather")
    LAUNCHES["sparse_gather"] += 1
    return out


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _decode(mean: int, name: str, idx: torch.Tensor, values: torch.Tensor,
            scale: torch.Tensor, d: int) -> torch.Tensor:
    if not values.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel; got {values.device}")
    _check_index(idx, name)
    if (idx.dim() != 2 or idx.shape != values.shape or idx.shape[0] < 1
            or values.dtype != torch.float32 or scale.dtype != torch.float32
            or scale.shape != (idx.shape[1],) or d < 1
            or not (idx.device == values.device == scale.device)):
        raise ValueError(f"{name}: idx and values must be (n, k) with n >= 1 (values "
                         "float32), scale (k,) float32, d >= 1, on one device")
    idx, values, scale = _rows(idx), _rows(values), scale.contiguous()
    n, k = idx.shape
    if d > 1 << 32:     # checked again by the launch, but before (d,) is allocated
        raise ValueError(f"{name}: the card's decode takes d <= 2^32 (the widest index "
                         f"word), got {d}")
    dev = values.device
    out = torch.empty(d, dtype=torch.float32, device=dev)
    size = decode_scratch(min(n, GROUP), k, d)     # one group of workers at a time
    # One allocation, cut in the order of csrc/sparse.cu's struct Scratch:
    # the 8-byte arrays (cursors, fine starts, fine cursors, the two record
    # buffers), then the 4-byte ones (counts and fine counts together, first
    # chunks, chunk bins).
    lengths = ((8, size["bins"]), (8, size["runs"]), (8, size["runs"]),
               (8, size["records"]), (8, size["records"]), (4, size["bins"]),
               (4, size["runs"]), (4, size["bins"] + 1), (4, size["chunks"]))
    scratch = torch.empty(sum(w * m for w, m in lengths), dtype=torch.uint8, device=dev)
    ptrs, at = [], scratch.data_ptr()
    for w, m in lengths:
        ptrs.append(at)
        at += w * m
    check(library().sparse_decode(
        mean, n, idx.data_ptr(), idx.stride(0), idx.itemsize, values.data_ptr(),
        values.stride(0), scale.data_ptr(), k, d, out.data_ptr(),
        (ctypes.c_void_p * len(ptrs))(*ptrs), stream_ptr(dev)), name)
    LAUNCHES[name] += 1
    return out


def sparse_decode_sum(idx: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                      d: int) -> torch.Tensor:
    """idx (n, k) unsigned, values (n, k) f32, scale (k,) f32 -> (d,) f32
    ``sum_i scatter(idx_i, values_i * scale)`` from worker 0, in order.  Rows
    may sit any number of elements apart (views of a gathered buffer).  The
    kernels take the workers ``GROUP`` at a time (the (tile, worker) keys of
    a coarse bin live in shared memory), each group's sum continuing the
    last one's output in worker order: the same bits as one pass."""
    return _decode(0, "sparse_decode_sum", idx, values, scale, d)


def sparse_decode_sum_mean(idx: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                           d: int) -> torch.Tensor:
    """The same sum, then one IEEE division by n."""
    return _decode(1, "sparse_decode_sum_mean", idx, values, scale, d)
