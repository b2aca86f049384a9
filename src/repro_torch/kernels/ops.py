"""Dispatch by tensor device: a CUDA tensor goes to the hand-written kernel
(which raises if it cannot build or launch), a CPU tensor to the kernel's
plain version in :mod:`repro_torch.kernels.ref`.  There is no fallback from
the card to the plain versions.  The kernels are built, once for all
sources, by :func:`repro_torch.kernels.build.library`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import prng

from . import ref
from .dense import dense_copy, dense_decode_sum, dense_decode_sum_mean
from .nat_decode import nat_decode_sum, nat_decode_sum_apply, nat_decode_sum_mean
from .nat_pack import nat_pack, nat_pack_prng
from .quantize_pack import quantize_pack, quantize_pack_prng
from .sparse import sparse_decode_sum, sparse_decode_sum_mean, sparse_gather
from .threefry import threefry_bits
from .unpack_reduce import unpack_reduce, unpack_reduce_apply, unpack_reduce_mean

__all__ = [
    "bits_op",
    "segment_bits_op",
    "quantize_pack_op",
    "quantize_pack_prng_op",
    "unpack_reduce_op",
    "unpack_reduce_mean_op",
    "unpack_reduce_apply_op",
    "nat_pack_op",
    "nat_pack_prng_op",
    "nat_decode_sum_op",
    "nat_decode_sum_mean_op",
    "nat_decode_sum_apply_op",
    "sparse_gather_op",
    "sparse_decode_sum_op",
    "sparse_decode_sum_mean_op",
    "dense_copy_op",
    "dense_decode_sum_op",
    "dense_decode_sum_mean_op",
]


def _on_card(t_or_device) -> bool:
    dev = t_or_device.device if isinstance(t_or_device, torch.Tensor) else torch.device(t_or_device)
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}: the port runs on cuda, or on cpu "
                     "through the plain versions")


def bits_op(key: torch.Tensor, shape: Sequence[int], device,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int32, drawn on ``device``."""
    if _on_card(device):
        return threefry_bits(key, shape, device, out=out)
    b = prng.bits(key, shape)
    if out is not None:
        out.copy_(b.reshape(out.shape))
        return out.reshape(tuple(shape))
    return b


def segment_bits_op(keys: torch.Tensor, sizes: Sequence[int], device) -> torch.Tensor:
    """``concat_i bits(keys[i], (sizes[i],))`` as one int32 buffer on
    ``device``: one threefry launch per segment on the card.  The bits the
    in-kernel-PRNG encodes draw, materialised (for the pre-drawn-bits
    kernels)."""
    if not _on_card(device):
        return ref.ref_segment_bits(keys, sizes, device)
    keys = keys.reshape(-1, 2)
    out = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    off = 0
    for k, s in zip(keys, sizes):
        threefry_bits(k, (s,), device, out=out[off:off + s])
        off += s
    return out


def quantize_pack_op(delta2d: torch.Tensor, bits: torch.Tensor, *, p: float):
    if _on_card(delta2d):
        return quantize_pack(delta2d, bits, p=p)
    return ref.ref_quantize_pack(delta2d, bits, p)


def quantize_pack_prng_op(delta2d: torch.Tensor, keys: torch.Tensor, seg_rows: Sequence[int],
                          *, p: float):
    """The ternary encode with the bits drawn in the kernel: rows of segment
    ``i`` draw ``bits(keys[i], (seg_rows[i], B))``."""
    if _on_card(delta2d):
        return quantize_pack_prng(delta2d, keys, seg_rows, p=p)
    return ref.ref_quantize_pack_prng(delta2d, keys, seg_rows, p)


def unpack_reduce_op(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    if _on_card(packed):
        return unpack_reduce(packed, scales)
    return ref.ref_unpack_reduce(packed, scales)


def unpack_reduce_mean_op(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    if _on_card(packed):
        return unpack_reduce_mean(packed, scales)
    return ref.ref_unpack_reduce_mean(packed, scales)


def _f32_memory(h: torch.Tensor, name: str) -> None:
    """The apply kernels read and write the server memory in f32; the plain
    versions hold the callers to the same contract (a bf16 ``h_dtype`` is
    widened by the round before the server rule, and rounded back after)."""
    if h.dtype != torch.float32:
        raise ValueError(f"{name}: the server memory must be float32 (got {h.dtype}); "
                         "the round widens an h_dtype memory before the server rule")


def unpack_reduce_apply_op(packed: torch.Tensor, scales: torch.Tensor, h: torch.Tensor,
                           *, alpha: float):
    _f32_memory(h, "unpack_reduce_apply")
    if _on_card(packed):
        return unpack_reduce_apply(packed, scales, h, alpha=alpha)
    return ref.ref_unpack_reduce_apply(packed, scales, h, alpha, packed.shape[0])


def nat_pack_op(x: torch.Tensor, bits: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if _on_card(x):
        return nat_pack(x, bits, out=out)
    codes = ref.ref_nat_pack(x, bits)
    return codes if out is None else out.copy_(codes)


def nat_pack_prng_op(x: torch.Tensor, keys: torch.Tensor, sizes: Sequence[int],
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The natural encode with the bits drawn in the kernel: coordinates of
    segment ``i`` draw ``bits(keys[i], (sizes[i],))``."""
    if _on_card(x):
        return nat_pack_prng(x, keys, sizes, out=out)
    codes = ref.ref_nat_pack_prng(x, keys, sizes)
    return codes if out is None else out.copy_(codes)


def nat_decode_sum_op(codes: torch.Tensor) -> torch.Tensor:
    if _on_card(codes):
        return nat_decode_sum(codes)
    return ref.ref_nat_decode_sum(codes)


def nat_decode_sum_mean_op(codes: torch.Tensor) -> torch.Tensor:
    if _on_card(codes):
        return nat_decode_sum_mean(codes)
    return ref.ref_nat_decode_sum_mean(codes)


def nat_decode_sum_apply_op(codes: torch.Tensor, h: torch.Tensor, *, alpha: float):
    _f32_memory(h, "nat_decode_sum_apply")
    if _on_card(codes):
        return nat_decode_sum_apply(codes, h, alpha=alpha)
    return ref.ref_nat_decode_sum_apply(codes, h, alpha)


def sparse_gather_op(x: torch.Tensor, idx: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if _on_card(x):
        return sparse_gather(x, idx, out=out)
    vals = ref.ref_sparse_gather(x, idx)
    return vals if out is None else out.copy_(vals)


def sparse_decode_sum_op(idx: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                         d: int) -> torch.Tensor:
    if _on_card(values):
        return sparse_decode_sum(idx, values, scale, d)
    return ref.ref_sparse_decode_sum(idx, values, scale, d)


def sparse_decode_sum_mean_op(idx: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                              d: int) -> torch.Tensor:
    if _on_card(values):
        return sparse_decode_sum_mean(idx, values, scale, d)
    return ref.ref_sparse_decode_sum_mean(idx, values, scale, d)


def dense_copy_op(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if _on_card(x):
        return dense_copy(x, out=out)
    vals = ref.ref_dense_copy(x)
    return vals if out is None else out.copy_(vals)


def dense_decode_sum_op(values: torch.Tensor) -> torch.Tensor:
    if _on_card(values):
        return dense_decode_sum(values)
    return ref.ref_dense_decode_sum(values)


def dense_decode_sum_mean_op(values: torch.Tensor) -> torch.Tensor:
    if _on_card(values):
        return dense_decode_sum_mean(values)
    return ref.ref_dense_decode_sum_mean(values)
