"""p-quantization and block p-quantization operators (paper Def. 1 / Def. 2).

The operator transforms ``delta`` into a random ternary vector

    qhat_j = ||delta||_p * sign(delta_j) * xi_j,   xi_j ~ Be(|delta_j| / ||delta||_p)

with one ``||.||_p`` scale per block of ``block_size`` coordinates.  The port's
copy of ``repro.core.quantization``; the bits -> uniform map is the one the
CUDA kernel applies, so kernel and plain routes agree bitwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import prng

__all__ = [
    "QuantizedBlocks",
    "alpha_p",
    "lp_norm",
    "pad_axis_to_multiple",
    "pad_to_blocks",
    "quantize_blocks",
    "quantize_blocks_from_uniform",
    "uniform_from_bits",
]


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (an int32 bit pattern) -> uniform [0, 1) f32 from the top
    24 bits: ``(bits >> 8) * 2^-24``.  The arithmetic shift of the int32
    pattern is masked back to the logical one."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def alpha_p(p: float, d: int) -> float:
    """``alpha_p(d) = inf_x ||x||_2^2 / (||x||_1 ||x||_p)`` (paper eq. 12)."""
    if d <= 0:
        raise ValueError(f"block size must be positive, got {d}")
    if d == 1:
        return 1.0
    if p == 1:
        return 1.0 / d
    if p == 2:
        return 1.0 / math.sqrt(d)
    if p == math.inf:
        return 2.0 / (1.0 + math.sqrt(d))
    if p > 2:
        return 1.0 / (d ** (1.0 - 1.0 / p))
    raise ValueError(f"unsupported quantization norm power p={p}")


def lp_norm(x: torch.Tensor, p: float, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``||x||_p`` along ``dim``."""
    if p == math.inf:
        return torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == 2:
        return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))
    if p == 1:
        return torch.sum(torch.abs(x), dim=dim, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=dim, keepdim=keepdim) ** (1.0 / p)


class QuantizedBlocks(NamedTuple):
    """signs int8 (num_blocks, block_size) in {-1,0,1}; scales f32 (num_blocks,)."""

    signs: torch.Tensor
    scales: torch.Tensor


def pad_axis_to_multiple(x: torch.Tensor, multiple: int, dim: int = 0) -> torch.Tensor:
    """Zero-pad ``x`` along ``dim`` up to the next multiple of ``multiple``."""
    pad = -x.shape[dim] % multiple
    if pad:
        pad_shape = list(x.shape)
        pad_shape[dim] = pad
        x = torch.cat([x, x.new_zeros(pad_shape)], dim=dim)
    return x


def pad_to_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flatten and zero-pad ``x`` to a (num_blocks, block_size) matrix."""
    return pad_axis_to_multiple(x.reshape(-1), block_size).reshape(-1, block_size)


def quantize_blocks_from_uniform(blocks: torch.Tensor, u: torch.Tensor, *,
                                 p: float) -> QuantizedBlocks:
    """Block p-quantization of an (m, B) block matrix given the uniforms."""
    scales = lp_norm(blocks, p, dim=-1)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    probs = torch.abs(blocks) / safe[:, None]
    xi = (u < probs).to(torch.int8)
    signs = torch.sign(blocks).to(torch.int8) * xi
    scales = torch.where(scales > 0, scales, torch.zeros_like(scales)).float()
    return QuantizedBlocks(signs=signs, scales=scales)


def quantize_blocks(x: torch.Tensor, key: torch.Tensor, *, p: float = math.inf,
                    block_size: int = 1024) -> QuantizedBlocks:
    """Block p-quantization (Def. 2) of an arbitrary-shaped tensor, drawing
    ``jax.random.bits(key, blocks.shape)`` through the plain PRNG."""
    blocks = pad_to_blocks(x.float(), block_size)
    b = prng.bits(key, blocks.shape, device=blocks.device)
    return quantize_blocks_from_uniform(blocks, uniform_from_bits(b), p=p)
