"""Rand-k sparsification — unbiased random coordinate subsampling.

The port's copy of ``repro.core.compressors.randk``.  Keeps ``k`` coordinates
drawn uniformly without replacement and rescales by ``d/k`` at decode:
unbiased, ``omega = d/k - 1``; the default memory rate
``alpha = 1 / (1 + omega) = k/d`` runs it in DIANA's memory loop (per leaf,
so the bucketed layout takes one rate per segment).  Wire format: indices +
unscaled values (:mod:`repro_torch.core.compressors.sparse`),
``(32 + index_bits(d)) * k / d`` bits/dim.

The subset is the ``k`` largest of ``d`` iid uint32 tags
``bits(key, (d,))`` (:func:`uniform_subset`, ``randk.py:50``), drawn by the
threefry kernel on the card; given the same key the indices, their order
and the values equal the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import prng
from repro_torch.kernels import ops

from .base import Payload
from .sparse import SparseCompressor, top_k_indices

__all__ = ["RandKCompressor", "uniform_subset"]


def uniform_subset(key: torch.Tensor, d: int, k: int, device) -> torch.Tensor:
    """A uniform random k-subset of ``range(d)``: the int64 indices of the
    ``k`` largest of ``d`` iid uint32 tags, in ``lax.top_k``'s order (tags
    descending, equal tags by ascending index)."""
    # The int32 tags are freed once widened: the selection's peak is the
    # int64 keys and torch.topk's workspace.
    words = ops.bits_op(key, (d,), device).to(torch.int64)
    return top_k_indices(words.bitwise_and_(prng.MASK), k)


class RandKCompressor(SparseCompressor):
    name = "randk"

    def __init__(self, k: int, *, alpha: Optional[float] = None, memory: bool = True):
        super().__init__(k)
        self.alpha = alpha
        self.carries_state = memory

    def _select(self, x: torch.Tensor, kk: int, key: torch.Tensor) -> torch.Tensor:
        return uniform_subset(key, x.numel(), kk, x.device)

    def _scale_value(self, d: int, kk: int) -> float:
        return d / kk

    def decode_sum_apply(self, gathered: Payload, n: int, d: int, h_server: torch.Tensor):
        """With memory, the base composition over the kernel's materialised
        sum (the JAX package's rule: no fused alpha variant, ``kernels/sparse.py:26``);
        memoryless, ONE ``sparse_decode_sum_mean``."""
        if self.carries_state:
            return super().decode_sum_apply(gathered, n, d, h_server)
        v = gathered.values
        return self._decode_mean(gathered, d, self._scale(d, v.shape[-1], v.device)), h_server

    def decode_sum_apply_bucketed(self, layout, gathered: Payload, n: int, h_server):
        if self.carries_state:
            return super().decode_sum_apply_bucketed(layout, gathered, n, h_server)
        scale = self._bucket_scales(layout, gathered.values.device)
        return self._decode_mean(gathered, layout.padded_size, scale), h_server

    def memory_alpha(self, d: Optional[int] = None) -> float:
        if not self.carries_state:
            return 0.0
        if self.alpha is not None:
            return self.alpha
        if d is None:
            return 1.0
        return self._k(d) / d  # 1 / (1 + omega), omega = d/k - 1
