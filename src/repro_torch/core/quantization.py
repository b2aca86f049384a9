"""p-quantization and block p-quantization operators (paper Def. 1 / Def. 2).

The operator transforms ``delta`` into a random ternary vector

    qhat_j = ||delta||_p * sign(delta_j) * xi_j,   xi_j ~ Be(|delta_j| / ||delta||_p)

with one ``||.||_p`` scale per block of ``block_size`` coordinates.  It is
unbiased (Lemma 2), with variance ``||d||_1 ||d||_p - ||d||_2^2`` and
expected sparsity ``||d||_1 / ||d||_p`` (Theorem 1) per block.  The port's
copy of ``repro.core.quantization``; the bits -> uniform map is the one the
CUDA kernel applies, so kernel and plain routes agree bitwise.  The pytree
functions take the port's ``{path: tensor}`` dicts, leaves in
:func:`repro_torch.core.tree.paths` order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import prng
from .tree import paths

__all__ = [
    "QuantizedBlocks",
    "alpha_p",
    "lp_norm",
    "quantize_blocks",
    "dequantize_blocks",
    "quantize_pytree",
    "dequantize_pytree",
    "expected_sparsity",
    "quantization_variance",
    "pad_axis_to_multiple",
    "pad_to_blocks",
    "num_blocks",
    "np_prod",
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


def _narrow_norm(x: torch.Tensor, p: float, dtype: torch.dtype) -> torch.Tensor:
    """``||x||_p`` along the last dim of f32 ``x`` holding a narrower
    ``dtype``'s values, with the jitted JAX function's roundings of that
    dtype's norm: the elementwise work in f32, each reduction's output and
    the root rounded to ``dtype`` (XLA's CPU backend widens the arithmetic
    and keeps a fused intermediate unrounded, but a reduction's output is
    stored in the leaf's dtype)."""
    r = lambda t: t.to(dtype).to(x.dtype)  # noqa: E731
    if p == math.inf:
        return torch.amax(torch.abs(x), dim=-1)
    if p == 1:
        return r(torch.sum(torch.abs(x), dim=-1))
    if p == 2:
        return r(torch.sqrt(r(torch.sum(x * x, dim=-1))))
    return r(r(torch.sum(torch.abs(x) ** p, dim=-1)) ** (1.0 / p))


class QuantizedBlocks(NamedTuple):
    """signs int8 (num_blocks, block_size) in {-1,0,1}; scales f32 (num_blocks,)."""

    signs: torch.Tensor
    scales: torch.Tensor


def num_blocks(d: int, block_size: int) -> int:
    return -(-d // block_size)


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


def quantize_blocks_from_uniform(blocks: torch.Tensor, u: torch.Tensor, *, p: float,
                                 norm_dtype: Optional[torch.dtype] = None) -> QuantizedBlocks:
    """Block p-quantization of an (m, B) block matrix given the uniforms;
    ``norm_dtype`` computes the block norms as :func:`_narrow_norm` does."""
    scales = (lp_norm(blocks, p, dim=-1) if norm_dtype is None
              else _narrow_norm(blocks, p, norm_dtype))
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    probs = torch.abs(blocks) / safe[:, None]
    xi = (u < probs).to(torch.int8)
    signs = torch.sign(blocks).to(torch.int8) * xi
    scales = torch.where(scales > 0, scales, torch.zeros_like(scales)).float()
    return QuantizedBlocks(signs=signs, scales=scales)


def quantize_blocks(x: torch.Tensor, key: torch.Tensor, *, p: float = math.inf,
                    block_size: int = 1024) -> QuantizedBlocks:
    """Block p-quantization (Def. 2) of an arbitrary-shaped tensor, drawing
    ``jax.random.bits(key, blocks.shape)`` through the plain PRNG.  A bf16
    leaf is widened to f32, its block norms rounded as the jitted JAX
    function rounds them (:func:`_narrow_norm`)."""
    blocks = pad_to_blocks(x.float(), block_size)
    b = prng.bits(key, blocks.shape, device=blocks.device)
    narrow = x.dtype if x.dtype.itemsize < 4 else None
    return quantize_blocks_from_uniform(blocks, uniform_from_bits(b), p=p, norm_dtype=narrow)


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def dequantize_blocks(q: QuantizedBlocks, shape=None, dtype=torch.float32) -> torch.Tensor:
    """The dense (unbiased) estimate ``scale * signs``: the first
    ``prod(shape)`` entries of the padded flat vector in ``shape``, or the
    whole flat vector without one."""
    dense = q.signs.to(dtype) * q.scales[:, None].to(dtype)
    flat = dense.reshape(-1)
    if shape is None:
        return flat
    return flat[:np_prod(shape)].reshape(tuple(shape))


def quantize_pytree(tree, key: torch.Tensor, *, p: float, block_size: int):
    """Quantize every leaf of ``{path: tensor}`` with its own key: leaf ``i``
    (in :func:`~repro_torch.core.tree.paths` order) draws from
    ``split(key, n_leaves)[i]``.  Blocks never straddle leaves."""
    order = paths(tree)
    keys = prng.split(key, len(order))
    return {path: quantize_blocks(tree[path], keys[i], p=p, block_size=block_size)
            for i, path in enumerate(order)}


def dequantize_pytree(qtree, like):
    """Inverse of :func:`quantize_pytree`: each leaf in the shape and dtype
    of ``like``'s."""
    return {path: dequantize_blocks(qtree[path], shape=like[path].shape, dtype=like[path].dtype)
            for path in paths(like)}


def expected_sparsity(x: torch.Tensor, p: float, block_size: int) -> torch.Tensor:
    """Theorem 1: ``E ||qhat||_0 = sum_l ||x(l)||_1 / ||x(l)||_p`` (0-dim)."""
    blocks = pad_to_blocks(x, block_size)
    n1 = lp_norm(blocks, 1, dim=-1)
    np_ = lp_norm(blocks, p, dim=-1)
    ratio = n1 / torch.where(np_ > 0, np_, torch.ones_like(np_))
    return torch.sum(torch.where(np_ > 0, ratio, torch.zeros_like(ratio)))


def quantization_variance(x: torch.Tensor, p: float, block_size: int) -> torch.Tensor:
    """Lemma 2: ``E||qhat - x||_2^2 = sum_l ||x(l)||_1 ||x(l)||_p -
    ||x(l)||_2^2`` (0-dim)."""
    blocks = pad_to_blocks(x, block_size)
    n1 = lp_norm(blocks, 1, dim=-1)
    np_ = lp_norm(blocks, p, dim=-1)
    n2sq = torch.sum(blocks * blocks, dim=-1)
    return torch.sum(n1 * np_ - n2sq)
