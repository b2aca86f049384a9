"""The sparse wire format shared by rand-k and top-k: ``indices`` + ``values``.

A payload keeps ``k_d = min(k, d)`` coordinates of a length-``d`` vector:
their indices in the narrowest unsigned dtype that covers ``d``
(:func:`~repro_torch.core.compressors.base.index_dtype`, the JAX package's
wire widths) and their f32 values, unscaled.  The decode multiplies by a
per-entry scale (rand-k's ``d/k_d``, top-k's 1.0) and scatter-adds into
zeros.  Gather and decode go through :mod:`repro_torch.kernels.ops`: the
``sparse_gather`` / ``sparse_decode_sum*`` kernels on a CUDA tensor, their
plain versions on a CPU tensor.

Selection stays outside the kernels, as in the JAX package:
:func:`top_k_indices` reproduces ``lax.top_k``'s set AND order (descending
value, equal values by ascending index) with ``torch.topk`` on unique
composite keys, since ``torch.topk`` orders ties as it likes.

The bucketed payload is one ``(K,)`` indices + values pair for the whole
flat buffer, ``K = sum_leaf k_d``: segment ``i`` selects within its own
stretch with the per-leaf rule and its indices are offset into global
coordinates (uint32, by the buffer's length).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

from .base import Compressor, Payload, index_dtype, index_nbits

__all__ = ["SparseCompressor", "top_k_indices"]

_LOW = (1 << 31) - 1


def top_k_indices(words: torch.Tensor, k: int) -> torch.Tensor:
    """The int64 indices of the ``k`` largest of ``words`` (a 1-D int64
    tensor of values in ``[0, 2^32)``, consumed: it is overwritten) in
    ``lax.top_k``'s order.  The key ``word * 2^31 + (2^31 - 1 - index)`` is
    unique (``d <= 2^31``) and orders as (word descending, index ascending),
    so ``torch.topk`` of the keys has one answer.  (A shift by 32 would
    overflow int64.)"""
    d = words.numel()
    if d > 1 << 31:
        raise ValueError(f"top_k_indices: {d} coordinates exceed the 31-bit index field")
    keys = words.bitwise_left_shift_(31).add_(_LOW)
    keys.sub_(torch.arange(d, dtype=torch.int64, device=keys.device))
    return torch.topk(keys, k, sorted=True).indices


class SparseCompressor(Compressor):
    """The ``indices`` + ``values`` wire format over a kept set of
    ``min(k, d)`` coordinates; subclasses choose the set (:meth:`_select`)
    and the decode scale (:meth:`_scale_value`)."""

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError(f"{self.name} needs k >= 1, got {k}")
        self.k = k

    def _k(self, d: int) -> int:
        return min(self.k, d)

    def _select(self, x: torch.Tensor, kk: int, key: torch.Tensor) -> torch.Tensor:
        """The int64 indices of the ``kk`` coordinates of ``x`` to keep, in
        the JAX package's order."""
        raise NotImplementedError

    def _scale_value(self, d: int, kk: int) -> float:
        raise NotImplementedError

    def _scale(self, d: int, kk: int, device) -> torch.Tensor:
        """The per-entry decode scale: the scalar as a ``(kk,)`` f32 vector
        (the same products as the scalar multiply)."""
        return torch.full((kk,), self._scale_value(d, kk), dtype=torch.float32, device=device)

    # ---------------------------------------------------------------- wire

    def compress(self, delta: torch.Tensor, key: torch.Tensor) -> Payload:
        x = delta.float().reshape(-1)
        d = x.numel()
        idx = self._select(x, self._k(d), key).to(index_dtype(d))
        return Payload(indices=idx, values=ops.sparse_gather_op(x, idx))

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        """One worker's decode as the one-worker ``sparse_decode_sum``."""
        return self.decode_sum(Payload(indices=payload.indices[None],
                                       values=payload.values[None]), 1, d)

    def decode_sum(self, gathered: Payload, n: int, d: int) -> torch.Tensor:
        """ONE ``sparse_decode_sum`` over the stacked workers: the base
        class's recurrence from worker 0, bitwise."""
        v = gathered.values
        return ops.sparse_decode_sum_op(gathered.indices, v,
                                        self._scale(d, v.shape[-1], v.device), d)

    def _decode_mean(self, gathered: Payload, d: int, scale: torch.Tensor) -> torch.Tensor:
        return ops.sparse_decode_sum_mean_op(gathered.indices, gathered.values, scale, d)

    def bits_per_dim(self, d: Optional[int] = None) -> float:
        if d is None:
            return 64.0  # per transmitted coordinate (32-bit index + value bound)
        return float(32 + index_nbits(d)) * self._k(d) / d

    # ------------------------------------------------- bucketed (flat) path

    def payload_length(self, layout) -> int:
        """``K``: the kept coordinates of the whole flat buffer."""
        return sum(self._k(d) for d in layout.sizes)

    def compress_bucketed_keys(self, layout, delta: torch.Tensor, keys: torch.Tensor, *,
                               out: Optional[Payload] = None) -> Payload:
        """Per-segment selection with ``keys[i]`` (``repro/core/compressors/
        randk.py:142``, ``topk_ef.py:158``), indices offset into the flat
        buffer and written into ``out`` (a worker's row of
        :meth:`gathered_bucketed`), then ONE ``sparse_gather`` of the values."""
        x = delta.float().reshape(-1)
        if out is None:
            out = self.gathered_bucketed(layout, 1, x.device).select(0)
        pos = 0
        for key, off, d in zip(keys, layout.offsets, layout.sizes):
            kk = self._k(d)
            out.indices[pos:pos + kk].copy_(self._select(x[off:off + d], kk, key).add_(off))
            pos += kk
        ops.sparse_gather_op(x, out.indices, out=out.values)
        return out

    def gathered_bucketed(self, layout, n: int, device) -> Payload:
        """``(n, K)`` indices (uint32 by the buffer's length) + ``(n, K)`` f32
        values: the all-gather's output shape."""
        kk = self.payload_length(layout)
        return Payload(
            indices=torch.empty((n, kk), dtype=index_dtype(layout.padded_size), device=device),
            values=torch.empty((n, kk), dtype=torch.float32, device=device))

    def _bucket_scales(self, layout, device) -> torch.Tensor:
        """The per-entry scale over the flat payload: each segment's own
        factor for each of its kept coordinates."""
        return torch.cat([self._scale(d, self._k(d), device) for d in layout.sizes])

    def decode_bucketed(self, layout, payload: Payload) -> torch.Tensor:
        return self.decode_sum_bucketed(layout, Payload(indices=payload.indices[None],
                                                        values=payload.values[None]), 1)

    def decode_sum_bucketed(self, layout, gathered: Payload, n: int) -> torch.Tensor:
        """ONE ``sparse_decode_sum`` over the flat buffer with the per-entry
        scale vector: bitwise the per-leaf decodes laid side by side."""
        v = gathered.values
        return ops.sparse_decode_sum_op(gathered.indices, v,
                                        self._bucket_scales(layout, v.device),
                                        layout.padded_size)
