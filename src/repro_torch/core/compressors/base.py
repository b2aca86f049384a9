"""Compressor interface + the ``Payload`` wire format.

The port's copy of ``repro.core.compressors.base`` for the hooks the ternary,
natural and sparse (rand-k, top-k + EF) paths run.  Memory rules follow the
JAX package's jitted arithmetic: XLA contracts ``h + alpha * x`` into one FMA,
so the port writes those updates with
:func:`repro_torch.core.numerics.fma32`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import prng
from repro_torch.core.numerics import SegmentRates, div_n, fma32

__all__ = ["Payload", "Compressor", "index_dtype", "index_nbits", "payload_nbits"]


def index_dtype(d: int) -> torch.dtype:
    """Narrowest unsigned integer dtype that addresses ``d`` coordinates: the
    wire width of a sparse payload's indices (``base.py:33``).  torch has no
    arithmetic on ``uint16``/``uint32``; indices are converted to int64 where
    torch indexes, and the kernels read the raw words."""
    if d <= (1 << 8):
        return torch.uint8
    if d <= (1 << 16):
        return torch.uint16
    return torch.uint32


def index_nbits(d: int) -> int:
    """Wire bits of one coordinate index of a length-``d`` vector."""
    return index_dtype(d).itemsize * 8


class Payload(NamedTuple):
    """The one wire format (``repro/core/compressors/base.py:52``): each
    operator fills the fields its encoding needs and leaves the rest ``None``.

    packed:   2-bit ternary codes ((m, B/4) uint8) or natural compression's
              sign+exponent codes ((d,) int16)
    scales:   per-block norm scales of the ternary family ((m,) f32)
    indices:  coordinate indices of a sparse payload (rand-k / top-k)
    values:   dense values (identity) or sparse coefficients

    A stacked (gathered) payload carries a leading worker axis on every field
    that is set."""

    packed: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    indices: Optional[torch.Tensor] = None
    values: Optional[torch.Tensor] = None

    @staticmethod
    def stack(payloads) -> "Payload":
        return Payload(*(None if f is None else torch.stack([p[i] for p in payloads])
                         for i, f in enumerate(payloads[0])))

    def select(self, i) -> "Payload":
        """The ``i``-th worker's payload from a stacked/gathered payload."""
        return Payload(*(None if f is None else f[i] for f in self))

    def _mask_field(self) -> Optional[int]:
        """The ONE field whose zero rows decode to exact zeros, in the JAX
        order: ``scales`` (zero scales times any ternary code), else
        ``values`` (dense or scattered zeros), else ``packed`` (natural
        compression's code 0 is 0.0)."""
        for name in ("scales", "values", "packed"):
            if getattr(self, name) is not None:
                return self._fields.index(name)
        return None

    def mask_workers(self, mask: torch.Tensor) -> "Payload":
        """Zero the rows of the non-participants of a GATHERED payload
        (``repro/core/compressors/base.py:76``; ``mask`` a (n,) bool): each
        excluded worker then decodes to zeros and the unchanged
        ``decode_sum`` recurrence sums the participants alone.  Returns a
        new payload; the fields it leaves alone are shared.

        A sparse payload's excluded rows also get the indices ``0..k-1``.
        With zero values a row decodes to the +0.0 row whatever its indices
        (the JAX decode drops an out-of-range index), so the bits are the
        same; but a corrupted wire may carry any index, and the card's
        decode must not be handed one out of range."""
        i = self._mask_field()
        if i is None:
            return self
        copied = {self._fields[i]: self[i].clone()}
        if self.indices is not None and self._fields[i] == "values":
            copied["indices"] = self.indices.clone()
        return self._replace(**copied).mask_workers_(mask)

    def mask_workers_(self, mask: torch.Tensor) -> "Payload":
        """:meth:`mask_workers` in place, for a stacked buffer the caller
        owns: nothing model-sized is allocated.  Zeroed rows hold +0, the
        bits of the JAX select."""
        i = self._mask_field()
        if i is None:
            return self
        sparse = self.indices is not None and self._fields[i] == "values"
        for w, keep in enumerate(mask.tolist()):
            if not keep:
                self[i][w].zero_()
                if sparse:
                    k = self.indices.shape[-1]
                    self.indices[w].copy_(torch.arange(k, device=self.indices.device)
                                          .to(self.indices.dtype))
        return self


def payload_nbits(payload: Payload) -> int:
    """Container bits of one payload (an upper bound on the logical wire
    cost): every field that is set, at its dtype's width."""
    return sum(f.numel() * f.element_size() * 8 for f in payload if f is not None)


class Compressor:
    """Abstract compression operator behind the DIANA aggregation loop.

    Subclasses implement the wire hooks (:meth:`compress`, :meth:`decode`,
    :meth:`decode_sum`, :meth:`decode_sum_apply`, :meth:`bits_per_dim`) and the
    bucketed hooks; the memory rule defaults to the paper's
    ``h <- h + alpha * dhat`` gated on :attr:`carries_state`.
    """

    name: str = "abstract"
    carries_state: bool = False
    # The payload IS the dense vector and no state is kept: the distributed
    # round all-reduces instead of gather + decode (identity).
    prefers_allreduce: bool = False
    # Under a compressed downlink the jitted reference contracts this
    # operator's elastic direction ``total * scale`` into the downlink's
    # input, one FMA across the two rounds (top-k EF: measured against
    # jitted JAX rounds in tests/test_torch_elastic_reference.py; XLA keeps
    # identity's two roundings).  See :meth:`compress_input_scaled`.
    fused_downlink_input: bool = False

    # ---------------------------------------------------------------- wire

    def compress(self, delta: torch.Tensor, key: torch.Tensor) -> Payload:
        """Encode a flat f32 vector ``delta`` into a :class:`Payload`."""
        raise NotImplementedError

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        """Decode ONE worker's payload back to a flat f32 vector of length d."""
        raise NotImplementedError

    def decode_sum(self, gathered: Payload, n: int, d: int) -> torch.Tensor:
        """``sum_i decode(payload_i)`` over a stacked payload: the sequential
        f32 recurrence from worker 0's decode (``base.py:163``).  Operators
        with a fused decode kernel override it with the same recurrence."""
        acc = self.decode(gathered.select(0), d)
        for i in range(1, n):
            acc = acc + self.decode(gathered.select(i), d)
        return acc

    def decode_sum_apply(self, gathered: Payload, n: int, d: int, h_server: torch.Tensor):
        """The server tail ``(ghat, new_h)``: ``dm = decode_sum / n``,
        ``ghat = server_direction(h, dm)``, ``new_h = next_server_memory(h, dm)``
        — the literal composition (``base.py:177``); kernel-backed operators
        fuse it into the decode."""
        dm = div_n(self.decode_sum(gathered, n, d), n)
        return self.server_direction(h_server, dm), self.next_server_memory(h_server, dm)

    def bits_per_dim(self, d: Optional[int] = None) -> float:
        raise NotImplementedError

    # -------------------------------------------------------- memory rule

    def memory_alpha(self, d: Optional[int] = None) -> float:
        """Learning rate of the alpha-memory rule; 0 for memoryless."""
        return 0.0

    def compress_input(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """What the worker encodes: ``g - h`` when the memory is live."""
        return g - h if self.carries_state else g

    def compress_input_(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """:meth:`compress_input` computed in place in ``g`` (the trainer's
        gradient buffer): the same bits, no model-sized temporary."""
        return g.sub_(h) if self.carries_state else g

    def compress_input_scaled(self, total: torch.Tensor, scale: float,
                              h: torch.Tensor) -> torch.Tensor:
        """``compress_input(total * scale, h)`` with the product contracted
        into the memory term, one rounding: ``fma(scale, total, -h)`` for
        the alpha rule (what a downlink encodes after an uplink whose
        direction XLA leaves unrounded, :attr:`fused_downlink_input`)."""
        if not self.carries_state:
            return total * scale
        return fma32(scale, total, -h)

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

    def scaled_direction(self, h: torch.Tensor, total: torch.Tensor, scale: float) -> torch.Tensor:
        """``server_direction(h, total * scale)``, the elastic round's
        direction from the participant sum (``repro/core/diana.py:174``).
        The jitted reference contracts ``h + total * scale`` into one FMA, as
        it does ``h + alpha * x``, so the alpha rule's direction is
        :func:`fma32`: bitwise at every participant count, where the unfused
        sum is an ulp off when ``scale`` is not a power of two."""
        if self.carries_state and type(self).server_direction is Compressor.server_direction:
            return fma32(scale, total, h)
        return self.server_direction(h, total * scale)

    # ------------------------------------------------- bucketed (flat) hooks

    def bucket_align(self) -> int:
        """Segment alignment of the flat layout (blocked operators: the block)."""
        return 1

    def compress_bucketed(self, layout, delta: torch.Tensor, key: torch.Tensor, *,
                          out: Optional[Payload] = None) -> Payload:
        """Encode the whole padded flat buffer with the per-leaf key schedule
        ``split(key, n_leaves)`` (segment ``i`` draws from ``keys[i]``), into
        ``out`` (a worker's row of :meth:`gathered_bucketed`, returned) when
        given."""
        return self.compress_bucketed_keys(layout, delta, prng.split(key, layout.n_leaves),
                                           out=out)

    def compress_bucketed_keys(self, layout, delta: torch.Tensor, keys: torch.Tensor, *,
                               out: Optional[Payload] = None) -> Payload:
        raise NotImplementedError

    def gathered_bucketed(self, layout, n: int, device) -> Payload:
        """An uninitialised stacked payload of ``n`` workers over the flat
        buffer: the shape of the all-gather's output."""
        raise NotImplementedError

    def decode_bucketed(self, layout, payload: Payload) -> torch.Tensor:
        raise NotImplementedError

    def decode_sum_bucketed(self, layout, gathered: Payload, n: int) -> torch.Tensor:
        """``sum_i decode_bucketed(payload_i)``: the sequential f32 recurrence
        from worker 0 (``base.py:318``)."""
        acc = self.decode_bucketed(layout, gathered.select(0))
        for i in range(1, n):
            acc = acc + self.decode_bucketed(layout, gathered.select(i))
        return acc

    def decode_sum_apply_bucketed(self, layout, gathered: Payload, n: int, h_server):
        """The server tail over the flat buffer (``base.py:327``), composed
        from the bucketed hooks: an operator that overrides
        :meth:`next_server_memory` (error feedback) keeps its own rule, else
        the alpha rule runs with :meth:`bucketed_alpha` (one rate, or one per
        segment)."""
        dm = div_n(self.decode_sum_bucketed(layout, gathered, n), n)
        return (self.server_direction(h_server, dm),
                self.next_server_memory_bucketed(layout, h_server, dm))

    def next_memory_bucketed(self, layout, h, dhat, delta):
        """:meth:`next_memory` over the flat buffer (``repro/core/bucket.py
        :458``): an operator's own rule (top-k EF), else the alpha rule with
        :meth:`bucketed_alpha`."""
        if type(self).next_memory is not Compressor.next_memory:
            return self.next_memory(h, dhat, delta)
        return fma32(self.bucketed_alpha(layout), dhat, h) if self.carries_state else h

    def next_server_memory_bucketed(self, layout, h, dhat_mean):
        """:meth:`next_server_memory` over the flat buffer, dispatched the
        same way."""
        if type(self).next_server_memory is not Compressor.next_server_memory:
            return self.next_server_memory(h, dhat_mean)
        return fma32(self.bucketed_alpha(layout), dhat_mean, h) if self.carries_state else h

    def bucketed_alpha(self, layout) -> Union[float, SegmentRates]:
        """The memory rate over the flat buffer (``base.py:345``): a scalar
        when the operator's alpha is the same for every leaf, else each
        segment's ``memory_alpha(d_leaf)`` over its padded stretch (rand-k's
        ``k/d``)."""
        alphas = [self.memory_alpha(s) for s in layout.sizes]
        if len(set(alphas)) <= 1:
            return alphas[0] if alphas else 0.0
        return SegmentRates(tuple(alphas), tuple(layout.offsets), tuple(layout.padded_sizes))
