"""Plain PyTorch versions of the CUDA kernels (the ternary family).

The port's copy of ``repro.kernels.ref`` (``:44-91``).  These run on the CPU
wherever a kernel would run on the card (``repro_torch.kernels.ops`` picks
them by tensor device), and ``chip_smoke.py`` holds each kernel against them
on the card.  The JAX package jits its round, and XLA contracts
``h + alpha * dm`` into one FMA there; :func:`ref_apply_server` computes that
FMA exactly with :func:`repro_torch.core.numerics.fma32` (an eager
``h + alpha * dm`` is 1 ulp off on some coordinates — the parity tests check
which formulation reproduces JAX's bits).
"""

from __future__ import annotations

import torch

from repro_torch.core.numerics import fma32
from repro_torch.core.packing import pack2bit, unpack2bit
from repro_torch.core.quantization import lp_norm, uniform_from_bits

__all__ = [
    "ref_quantize_pack",
    "ref_unpack_reduce",
    "ref_unpack_reduce_mean",
    "ref_apply_server",
    "ref_unpack_reduce_apply",
]


def ref_quantize_pack(delta: torch.Tensor, bits: torch.Tensor, p: float):
    """delta (m, B) f32, bits (m, B) uint32 as int32 -> (packed (m, B/4)
    uint8, scales (m, 1) f32)."""
    scales = lp_norm(delta, p, dim=-1, keepdim=True)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    probs = torch.abs(delta) / safe
    xi = (uniform_from_bits(bits) < probs).to(torch.int8)
    signs = torch.sign(delta).to(torch.int8) * xi
    return pack2bit(signs), scales.float()


def ref_unpack_reduce(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """packed (n, m, B/4) uint8, scales (n, m, 1) f32 -> (m, B) f32 sum,
    accumulated worker by worker from zeros."""
    n, m, b4 = packed.shape
    acc = torch.zeros((m, 4 * b4), dtype=torch.float32, device=packed.device)
    for i in range(n):
        acc = acc + unpack2bit(packed[i]).float() * scales[i]
    return acc


def ref_unpack_reduce_mean(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The worker sum, then one true division by n."""
    return ref_unpack_reduce(packed, scales) / packed.shape[0]


def ref_apply_server(s: torch.Tensor, n: int, h: torch.Tensor, alpha: float):
    """``dm = s / n``; ``(ghat, new_h) = (h + dm, fma(alpha, dm, h))``."""
    dm = s / n
    return h + dm, fma32(alpha, dm, h)


def ref_unpack_reduce_apply(packed, scales, h, alpha: float, n: int):
    """Fused decode_sum + server update: flat ``(ghat, new_h)``, both (d,)."""
    s = ref_unpack_reduce(packed, scales).reshape(-1)[: h.shape[0]]
    return ref_apply_server(s, n, h, alpha)
