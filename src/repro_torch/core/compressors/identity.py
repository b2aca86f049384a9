"""Identity "compressor" — the uncompressed f32 baseline (method ``none``).

The port's copy of ``repro.core.compressors.identity``: the dense vector
travels in ``Payload.values`` through the same compress -> gather ->
decode_sum pipeline as every real operator, so the 32 bits/dim row of the
paper's trade-off is measured through the same plumbing.

On a CUDA tensor the payload passes through the ``dense_copy`` kernel and the
server sums (means) the workers' rows with ``dense_decode_sum(_mean)``; on a
CPU tensor their plain versions run.  The JAX package routes identity through
its dense kernels only with ``use_kernel=True`` (off by default); both of its
routes give the same bits (a memoryless server direction is the mean itself),
so routing by device keeps the port bitwise against either: for n a power of
two, and within 1 ulp at other n, where the jitted reference divides as
``s * f32(1/n)`` (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

from .base import Compressor, Payload

__all__ = ["IdentityCompressor"]


class IdentityCompressor(Compressor):
    name = "identity"
    unbiased = True
    carries_state = False
    # Dense payload: one all-reduce beats gather + decode; read by the
    # torch.distributed round (core/diana.py::_dispatch_round), not by the
    # in-turn round.
    prefers_allreduce = True

    # ---------------------------------------------------------------- wire

    def compress(self, delta: torch.Tensor, key: torch.Tensor) -> Payload:
        return Payload(values=ops.dense_copy_op(delta.float().reshape(-1)))

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        return payload.values[:d]

    def decode_sum(self, gathered: Payload, n: int, d: int) -> torch.Tensor:
        """ONE ``dense_decode_sum`` over the stacked rows: the base class's
        recurrence from worker 0's row, bitwise."""
        return ops.dense_decode_sum_op(gathered.values[:, :d])

    def decode_sum_apply(self, gathered: Payload, n: int, d: int, h_server: torch.Tensor):
        """ONE ``dense_decode_sum_mean``: memoryless, so ghat is the mean and
        the server memory is returned as it is."""
        return ops.dense_decode_sum_mean_op(gathered.values[:, :d]), h_server

    def bits_per_dim(self, d: Optional[int] = None) -> float:
        return 32.0

    # ------------------------------------------------- bucketed (flat) path

    def compress_bucketed_keys(self, layout, delta: torch.Tensor, keys: torch.Tensor, *,
                               out: Optional[Payload] = None) -> Payload:
        """ONE copy of the whole buffer (no key is read), into ``out``'s row
        when given."""
        x = delta.float().reshape(-1)
        vals = ops.dense_copy_op(x, out=None if out is None else out.values)
        return Payload(values=vals) if out is None else out

    def gathered_bucketed(self, layout, n: int, device) -> Payload:
        """``(n, Dp)`` f32 values; rows sit a multiple of 4 floats apart so
        each row starts 16-byte aligned (the kernels' float4 accesses)."""
        dp = layout.padded_size
        ld = -(-dp // 4) * 4
        return Payload(values=torch.empty((n, ld), dtype=torch.float32, device=device)[:, :dp])

    def decode_bucketed(self, layout, payload: Payload) -> torch.Tensor:
        return payload.values

    def decode_sum_bucketed(self, layout, gathered: Payload, n: int) -> torch.Tensor:
        return self.decode_sum(gathered, n, layout.padded_size)

    def decode_sum_apply_bucketed(self, layout, gathered: Payload, n: int, h_server):
        return self.decode_sum_apply(gathered, n, layout.padded_size, h_server)
