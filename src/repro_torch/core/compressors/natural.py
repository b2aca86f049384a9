"""Natural compression — unbiased power-of-two exponent rounding (9 bits/dim).

The port's copy of ``repro.core.compressors.natural``.  ``C_nat(x)`` keeps the
sign and rounds ``|x|`` to one of its two enclosing powers of two, up with
probability ``(|x| - 2^(e-1)) / 2^(e-1)`` (Horvath et al. 2019): unbiased,
``omega = 1/8``, and with the default ``alpha = 1 / (1 + omega) = 8/9`` it
runs in DIANA's memory loop.

Wire format: one signed exponent code per coordinate in ``Payload.packed``
(int16 container for the 9-bit sign + exponent): 0 is an exact zero,
otherwise ``code = sign * (exponent + 160)``.

Encode and decode go through :mod:`repro_torch.kernels.ops`: on a CUDA tensor
the ``nat_pack_prng`` kernel (the bits ``bits(key, (d,))``, or
``bits(keys[i], (s_i,))`` per bucket segment, drawn in registers) and the
``nat_decode_sum*`` kernels, on a CPU tensor their plain versions.  Given the
same key the codes equal the JAX package's CPU route's bit for bit; a decoded value is the exact power of
two, which the JAX package's CPU build computes with ``exp2`` to within a
relative 4.1e-6 (see ``tests/test_torch_natural.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

from .base import Compressor, Payload

__all__ = ["NaturalCompressor", "OMEGA_NAT"]

OMEGA_NAT = 1.0 / 8.0


class NaturalCompressor(Compressor):
    name = "natural"

    def __init__(self, *, alpha: Optional[float] = None, memory: bool = True):
        self.alpha = alpha
        self.carries_state = memory

    # ---------------------------------------------------------------- wire

    def compress(self, delta: torch.Tensor, key: torch.Tensor) -> Payload:
        x = delta.float().reshape(-1)
        return Payload(packed=ops.nat_pack_prng_op(x, key.reshape(1, 2), (x.numel(),)))

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        """One worker's decode as the one-worker ``nat_decode_sum``: the same
        bits as a plain decode, and a kernel on the card instead of several
        model-sized temporaries."""
        return ops.nat_decode_sum_op(payload.packed[None])[:d]

    def decode_sum(self, gathered: Payload, n: int, d: int) -> torch.Tensor:
        """ONE ``nat_decode_sum`` over the stacked workers: the base class's
        recurrence from worker 0's decode, bitwise."""
        return ops.nat_decode_sum_op(gathered.packed)[:d]

    def decode_sum_apply(self, gathered: Payload, n: int, d: int, h_server: torch.Tensor):
        """ONE ``nat_decode_sum_apply`` (``nat_decode_sum_mean`` when the
        memory is off) whose epilogue runs the server rule on the sum."""
        if self.carries_state:
            return ops.nat_decode_sum_apply_op(gathered.packed, h_server,
                                               alpha=self.memory_alpha(d))
        return ops.nat_decode_sum_mean_op(gathered.packed)[:d], h_server

    def bits_per_dim(self, d: Optional[int] = None) -> float:
        return 9.0  # sign + 8-bit exponent (int16 is only the container)

    # ------------------------------------------------- bucketed (flat) path

    def compress_bucketed_keys(self, layout, delta: torch.Tensor, keys: torch.Tensor, *,
                               out: Optional[Payload] = None) -> Payload:
        """ONE encode over the whole buffer; segment ``i`` draws
        ``bits(keys[i], (s_i,))`` over its stretch in the kernel (the JAX
        package's CPU route concatenates the same draws; alignment is 1, so
        segments are unpadded and contiguous, and a boundary can fall
        anywhere)."""
        x = delta.float().reshape(-1)
        codes = ops.nat_pack_prng_op(x, keys, layout.padded_sizes,
                                     out=None if out is None else out.packed)
        return Payload(packed=codes) if out is None else out

    def gathered_bucketed(self, layout, n: int, device) -> Payload:
        """``(n, Dp)`` int16 codes; rows sit a multiple of 8 codes apart so
        each row starts 16-byte aligned (the decode kernel's vector loads)."""
        dp = layout.padded_size
        ld = -(-dp // 8) * 8
        return Payload(packed=torch.empty((n, ld), dtype=torch.int16, device=device)[:, :dp])

    def decode_bucketed(self, layout, payload: Payload) -> torch.Tensor:
        return self.decode(payload, layout.padded_size)

    def decode_sum_bucketed(self, layout, gathered: Payload, n: int) -> torch.Tensor:
        return self.decode_sum(gathered, n, layout.padded_size)

    def decode_sum_apply_bucketed(self, layout, gathered: Payload, n: int, h_server):
        """Alpha does not depend on d, so the fused kernel serves the flat
        buffer unchanged."""
        return self.decode_sum_apply(gathered, n, layout.padded_size, h_server)

    # -------------------------------------------------------- memory rule

    def memory_alpha(self, d: Optional[int] = None) -> float:
        if not self.carries_state:
            return 0.0
        return self.alpha if self.alpha is not None else 1.0 / (1.0 + OMEGA_NAT)
