"""Compressor interface + the ``Payload`` wire format.

The port's copy of ``repro.core.compressors.base`` for the hooks the ternary
path runs.  Memory rules follow the JAX package's jitted arithmetic: XLA
contracts ``h + alpha * x`` into one FMA, so the port writes those updates
with :func:`repro_torch.core.numerics.fma32`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.numerics import fma32

__all__ = ["Payload", "Compressor"]


class Payload(NamedTuple):
    """The wire format of the ternary family: 2-bit codes (``packed``, (m, B/4)
    uint8) and one f32 scale per block (``scales``, (m,)).  A stacked
    (gathered) payload carries a leading worker axis on both fields.  The
    sparse and dense operators' ``indices``/``values`` fields come with those
    operators (ROADMAP.md queue 1)."""

    packed: torch.Tensor
    scales: torch.Tensor

    @staticmethod
    def stack(payloads) -> "Payload":
        return Payload(torch.stack([p.packed for p in payloads]),
                       torch.stack([p.scales for p in payloads]))


class Compressor:
    """Abstract compression operator behind the DIANA aggregation loop.

    Subclasses implement the wire hooks (:meth:`compress`, :meth:`decode`,
    :meth:`decode_sum`, :meth:`decode_sum_apply`, :meth:`bits_per_dim`) and the
    bucketed hooks; the memory rule defaults to the paper's
    ``h <- h + alpha * dhat`` gated on :attr:`carries_state`.
    """

    name: str = "abstract"
    carries_state: bool = False

    # ---------------------------------------------------------------- wire

    def compress(self, delta: torch.Tensor, key: torch.Tensor) -> Payload:
        """Encode a flat f32 vector ``delta`` into a :class:`Payload`."""
        raise NotImplementedError

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        """Decode ONE worker's payload back to a flat f32 vector of length d."""
        raise NotImplementedError

    def decode_sum(self, gathered: Payload, n: int, d: int) -> torch.Tensor:
        """``sum_i decode(payload_i)`` over a stacked payload, accumulated in
        f32 from zeros in worker order."""
        raise NotImplementedError

    def decode_sum_apply(self, gathered: Payload, n: int, d: int, h_server: torch.Tensor):
        """The fused server tail ``(ghat, new_h)``: ``dm = decode_sum / n``,
        ``ghat = server_direction(h, dm)``, ``new_h = next_server_memory(h, dm)``."""
        raise NotImplementedError

    def bits_per_dim(self, d: Optional[int] = None) -> float:
        raise NotImplementedError

    # -------------------------------------------------------- memory rule

    def memory_alpha(self, d: Optional[int] = None) -> float:
        """Learning rate of the alpha-memory rule; 0 for memoryless."""
        return 0.0

    def compress_input(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """What the worker encodes: ``g - h`` when the memory is live."""
        return g - h if self.carries_state else g

    def next_memory(self, h: torch.Tensor, dhat: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """Worker memory update ``h_i + alpha * dhat_i`` (one rounding, as jitted)."""
        if not self.carries_state:
            return h
        return fma32(self.memory_alpha(h.shape[-1]), dhat, h)

    def next_server_memory(self, h: torch.Tensor, dhat_mean: torch.Tensor) -> torch.Tensor:
        """Server memory update ``h + alpha * mean_i dhat_i``."""
        if not self.carries_state:
            return h
        return fma32(self.memory_alpha(h.shape[-1]), dhat_mean, h)

    def server_direction(self, h: torch.Tensor, dhat_mean: torch.Tensor) -> torch.Tensor:
        """The aggregated estimator ``ghat = h + mean_i dhat_i``."""
        return h + dhat_mean if self.carries_state else dhat_mean

    # ------------------------------------------------- bucketed (flat) hooks

    def bucket_align(self) -> int:
        """Segment alignment of the flat layout (blocked operators: the block)."""
        return 1

    def compress_bucketed(self, layout, delta: torch.Tensor, key: torch.Tensor) -> Payload:
        """Encode the whole padded flat buffer with the per-leaf key schedule
        ``split(key, n_leaves)`` (segment ``i`` draws from ``keys[i]``)."""
        return self.compress_bucketed_keys(layout, delta, prng.split(key, layout.n_leaves))

    def compress_bucketed_keys(self, layout, delta: torch.Tensor, keys: torch.Tensor) -> Payload:
        raise NotImplementedError

    def decode_bucketed(self, layout, payload: Payload) -> torch.Tensor:
        raise NotImplementedError

    def decode_sum_bucketed(self, layout, gathered: Payload, n: int) -> torch.Tensor:
        raise NotImplementedError

    def decode_sum_apply_bucketed(self, layout, gathered: Payload, n: int, h_server):
        raise NotImplementedError

    def bucketed_alpha(self, layout) -> float:
        """The memory rate over the flat buffer: one scalar, since every
        ported operator's alpha is independent of the leaf length."""
        alphas = {self.memory_alpha(s) for s in layout.sizes}
        if len(alphas) > 1:
            raise NotImplementedError(
                "per-segment memory rates (rand-k) come with that operator "
                "(ROADMAP.md queue 1, 'the other four operators')")
        return alphas.pop() if alphas else 0.0
