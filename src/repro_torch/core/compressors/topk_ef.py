"""Top-k with error feedback — biased sparsification, residual-carried memory.

The port's copy of ``repro.core.compressors.topk_ef``.  Each worker sends the
``k`` largest-magnitude coordinates of ``delta = g + e`` (its gradient plus
the residual it kept) and keeps ``e <- delta - dhat``, what it did not send
(EF-SGD, Stich et al. 2018).  Biased, so it lives outside the paper's
analysis; it reuses DIANA's worker-memory slots under the error-feedback
rule, and the server keeps no memory: ``ghat`` is the mean of the decodes.
Wire format: indices + values with no rescale
(:mod:`repro_torch.core.compressors.sparse`).

Selection is ``lax.top_k(|delta|, k)`` per leaf or bucket segment
(``topk_ef.py:123``, ``:168``): non-negative f32 values order like their
bit patterns, so :func:`~repro_torch.core.compressors.sparse.top_k_indices`
on those bits gives the JAX package's set and order, ties included.  (The
JAX package's sort-free selection, ``_select_topk_sortfree``, exists for
XLA's sort partitioner inside sharded bodies; it comes with the
``torch.distributed`` round, ROADMAP.md queue 1.)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..numerics import fma32
from .base import Payload
from .sparse import SparseCompressor, top_k_indices

__all__ = ["TopKEFCompressor"]


class TopKEFCompressor(SparseCompressor):
    name = "topk_ef"
    carries_state = True  # the EF residual
    fused_downlink_input = True

    def _select(self, x: torch.Tensor, kk: int, key: torch.Tensor) -> torch.Tensor:
        del key  # deterministic selection
        return top_k_indices(x.abs().view(torch.int32).to(torch.int64), kk)

    def _scale_value(self, d: int, kk: int) -> float:
        return 1.0

    def decode_sum_apply(self, gathered: Payload, n: int, d: int, h_server: torch.Tensor):
        """ONE ``sparse_decode_sum_mean``: ``ghat`` is the mean, and the
        server memory does not move."""
        v = gathered.values
        return self._decode_mean(gathered, d, self._scale(d, v.shape[-1], v.device)), h_server

    def decode_sum_apply_bucketed(self, layout, gathered: Payload, n: int, h_server):
        scale = self._bucket_scales(layout, gathered.values.device)
        return self._decode_mean(gathered, layout.padded_size, scale), h_server

    # ------------------------------------------------ error-feedback rule

    def memory_alpha(self, d: Optional[int] = None) -> float:
        return 1.0  # the residual is carried in full, not alpha-averaged

    def compress_input(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return g + h  # error-corrected gradient

    def compress_input_(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return g.add_(h)

    def compress_input_scaled(self, total: torch.Tensor, scale: float,
                              h: torch.Tensor) -> torch.Tensor:
        return fma32(scale, total, h)

    def next_memory(self, h: torch.Tensor, dhat: torch.Tensor,
                    delta: torch.Tensor) -> torch.Tensor:
        return delta - dhat  # what top-k dropped this round

    def next_server_memory(self, h: torch.Tensor, dhat_mean: torch.Tensor) -> torch.Tensor:
        return h  # no server-side memory in EF

    def server_direction(self, h: torch.Tensor, dhat_mean: torch.Tensor) -> torch.Tensor:
        return dhat_mean
