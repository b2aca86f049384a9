"""Ternary block p-quantization (paper Def. 1/2) — DIANA's native operator.

Wire format: 2-bit sign codes (4/byte, :mod:`repro_torch.core.packing`) + one
f32 ``||.||_p`` scale per block — ``2 + 32/B`` bits/dim.

Encode and server decode go through :mod:`repro_torch.kernels.ops`, which
launches the CUDA kernels (``quantize_pack_prng``, which draws the Bernoulli
bits in registers, and ``unpack_reduce*``) on a CUDA tensor and runs their
plain versions on a CPU tensor.  The bits are ``bits(key, (m, B))`` (per
leaf) or ``bits(keys[i], (m_i, B))`` per bucket segment, as the JAX
package's CPU route draws them, so given the same key every payload, decoded
sum and memory update equals the JAX package's jitted ``TernaryCompressor``
bit for bit (p = inf; p in {1, 2} up to the norm's summation order).  (On
its TPU the JAX package draws from the TPU's generator instead: equal in
distribution only.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quantization import alpha_p, pad_to_blocks
from repro_torch.kernels import ops

from .base import Compressor, Payload

__all__ = ["TernaryCompressor"]


class TernaryCompressor(Compressor):
    """Block p-quantization with optional DIANA memory.

    memory=True  -> the paper's DIANA (compress gradient differences,
                    alpha-memory with the Corollary-1 default alpha_p/2)
    memory=False -> Algorithm 2: QSGD (p=2) / TernGrad (p=inf) / DQGD.
    """

    name = "ternary"

    def __init__(self, *, p: float = math.inf, block_size: int = 2048,
                 alpha: Optional[float] = None, memory: bool = True):
        if block_size % 4:
            raise ValueError("block_size must be a multiple of 4 for 2-bit packing")
        self.p = p
        self.block_size = block_size
        self.alpha = alpha
        self.carries_state = memory

    # ---------------------------------------------------------------- wire

    def compress(self, delta: torch.Tensor, key: torch.Tensor) -> Payload:
        blocks = pad_to_blocks(delta.float(), self.block_size)
        packed, scales = ops.quantize_pack_prng_op(blocks, key.reshape(1, 2),
                                                   (blocks.shape[0],), p=self.p)
        return Payload(packed=packed, scales=scales[:, 0])

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        """One worker's ``signs * scale`` as the one-worker ``unpack_reduce``
        (``0 + sign * scale``: the same bits, since a quantized scale is never
        negative) — a kernel on the card instead of four int8/f32 temporaries
        the size of the model."""
        acc = ops.unpack_reduce_op(payload.packed[None], payload.scales[None, :, None])
        return acc.reshape(-1)[:d]

    def decode_sum(self, gathered: Payload, n: int, d: int) -> torch.Tensor:
        """ONE ``unpack_reduce`` over the stacked workers (sum from zeros, in
        worker order)."""
        acc = ops.unpack_reduce_op(gathered.packed, gathered.scales[..., None])
        return acc.reshape(-1)[:d]

    def decode_sum_apply(self, gathered: Payload, n: int, d: int, h_server: torch.Tensor):
        """ONE ``unpack_reduce_apply`` (or ``_mean`` for the memoryless
        aliases) whose epilogue runs the server rule on the accumulator."""
        packed, scales = gathered.packed, gathered.scales[..., None]
        if self.carries_state:
            return ops.unpack_reduce_apply_op(packed, scales, h_server,
                                              alpha=self.memory_alpha(d))
        ghat = ops.unpack_reduce_mean_op(packed, scales).reshape(-1)[:d]
        return ghat, h_server

    def bits_per_dim(self, d: Optional[int] = None) -> float:
        return 2.0 + 32.0 / self.block_size

    # ------------------------------------------------- bucketed (flat) path

    def bucket_align(self) -> int:
        """Segments align to the quantization block, so every block belongs
        to one leaf and the scales equal the per-leaf path's."""
        return self.block_size

    def compress_bucketed_keys(self, layout, delta: torch.Tensor, keys: torch.Tensor, *,
                               out: Optional[Payload] = None) -> Payload:
        """ONE fused quantize+pack over the whole block matrix, segment ``i``
        drawing ``bits(keys[i], (m_i, B))`` in the kernel over its own padded
        rows (counter mode: the JAX package's vmapped per-segment draw, with
        no (Dp,) bits buffer)."""
        blocks = delta.float().reshape(-1, self.block_size)
        seg_rows = [ps // self.block_size for ps in layout.padded_sizes]
        packed, scales = ops.quantize_pack_prng_op(blocks, keys, seg_rows, p=self.p)
        if out is None:
            return Payload(packed=packed, scales=scales[:, 0])
        out.packed.copy_(packed)
        out.scales.copy_(scales[:, 0])
        return out

    def gathered_bucketed(self, layout, n: int, device) -> Payload:
        m = layout.padded_size // self.block_size
        return Payload(
            packed=torch.empty((n, m, self.block_size // 4), dtype=torch.uint8, device=device),
            scales=torch.empty((n, m), dtype=torch.float32, device=device))

    def decode_bucketed(self, layout, payload: Payload) -> torch.Tensor:
        return self.decode(payload, layout.padded_size)

    def decode_sum_bucketed(self, layout, gathered: Payload, n: int) -> torch.Tensor:
        return self.decode_sum(gathered, n, layout.padded_size)

    def decode_sum_apply_bucketed(self, layout, gathered: Payload, n: int, h_server):
        """The flat buffer is block-aligned, so the fused kernel applies
        verbatim; alpha depends only on the block size."""
        return self.decode_sum_apply(gathered, n, layout.padded_size, h_server)

    # -------------------------------------------------------- memory rule

    def memory_alpha(self, d: Optional[int] = None) -> float:
        if not self.carries_state:
            return 0.0
        if self.alpha is not None:
            return self.alpha
        return alpha_p(self.p, self.block_size) / 2.0  # Corollary 1
