"""Plain PyTorch versions of the CUDA kernels (the ternary, natural, sparse
and dense families, and the in-kernel-PRNG encodes).

The port's copy of ``repro.kernels.ref`` (``:44-147``).  The in-kernel-PRNG
encodes have no plain version in the JAX package (its TPU kernels draw from
the TPU's own generator); theirs here is the bits encode fed
``concat_i bits(keys[i], shape_i)``, which the CUDA kernels reproduce bit for
bit in registers.  These run on the CPU
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

from repro_torch.core import prng
from repro_torch.core.numerics import div_n, fma32
from repro_torch.core.packing import pack2bit, unpack2bit
from repro_torch.core.quantization import lp_norm, uniform_from_bits

__all__ = [
    "ref_segment_bits",
    "ref_quantize_pack",
    "ref_quantize_pack_prng",
    "ref_unpack_reduce",
    "ref_unpack_reduce_mean",
    "ref_apply_server",
    "ref_unpack_reduce_apply",
    "NAT_BIAS",
    "ref_nat_pack",
    "ref_nat_pack_prng",
    "ref_nat_decode",
    "ref_nat_decode_sum",
    "ref_nat_decode_sum_mean",
    "ref_nat_decode_sum_apply",
    "ref_sparse_gather",
    "ref_sparse_decode_sum",
    "ref_sparse_decode_sum_mean",
    "ref_dense_copy",
    "ref_dense_decode_sum",
    "ref_dense_decode_sum_mean",
]

NAT_BIAS = 160  # int16 code bias: repro/core/compressors/natural.py ``_BIAS``
_FLT_MIN = 2.0 ** -126


def ref_segment_bits(keys: torch.Tensor, sizes, device) -> torch.Tensor:
    """``concat_i bits(keys[i], (sizes[i],))`` as one int32 (sum sizes,)
    buffer on ``device``, drawn segment by segment (the int64 emulation's
    temporaries are those of the largest segment)."""
    keys = keys.reshape(-1, 2)
    out = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    off = 0
    for k, s in zip(keys, sizes):
        out[off:off + s] = prng.bits(k, (s,), device=device)
        off += s
    return out


def ref_quantize_pack(delta: torch.Tensor, bits: torch.Tensor, p: float):
    """delta (m, B) f32, bits (m, B) uint32 as int32 -> (packed (m, B/4)
    uint8, scales (m, 1) f32)."""
    scales = lp_norm(delta, p, dim=-1, keepdim=True)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    probs = torch.abs(delta) / safe
    xi = (uniform_from_bits(bits) < probs).to(torch.int8)
    signs = torch.sign(delta).to(torch.int8) * xi
    return pack2bit(signs), scales.float()


def ref_quantize_pack_prng(delta: torch.Tensor, keys: torch.Tensor, seg_rows, p: float):
    """The in-kernel-PRNG encode: delta (m, B) f32, keys (nseg, 2), segment
    ``i`` of ``seg_rows[i]`` rows drawing ``bits(keys[i], (seg_rows[i], B))``
    -> :func:`ref_quantize_pack` of those bits."""
    m, b = delta.shape
    bits = ref_segment_bits(keys, [r * b for r in seg_rows], delta.device)
    return ref_quantize_pack(delta, bits.reshape(m, b), p)


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
    return div_n(ref_unpack_reduce(packed, scales), packed.shape[0])


def ref_apply_server(s: torch.Tensor, n: int, h: torch.Tensor, alpha: float):
    """``dm = s / n``; ``(ghat, new_h) = (h + dm, fma(alpha, dm, h))``."""
    dm = div_n(s, n)
    return h + dm, fma32(alpha, dm, h)


def ref_unpack_reduce_apply(packed, scales, h, alpha: float, n: int):
    """Fused decode_sum + server update: flat ``(ghat, new_h)``, both (d,)."""
    s = ref_unpack_reduce(packed, scales).reshape(-1)[: h.shape[0]]
    return ref_apply_server(s, n, h, alpha)


def ref_nat_pack(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Natural-compression encode, the literal frexp formulation
    (``repro/kernels/ref.py:94``): x (d,) f32, bits (d,) uint32 as int32 ->
    (d,) int16 ``sign * (chosen + 160)``, where ``|x|`` in ``[2^(e-1), 2^e)``
    rounds up to ``2^e`` when ``u < 2|mant| - 1``.

    Zeros code to 0, and so do subnormals: the JAX package's CPU build treats
    a subnormal input as zero (``x == 0.0`` holds for it), so that is the
    reference's code for them.  torch's ``frexp`` is exact on subnormals; the
    mask makes the choice explicit."""
    x = x.float()
    u = uniform_from_bits(bits)
    mant, expo = torch.frexp(x)
    p_up = 2.0 * torch.abs(mant) - 1.0             # exact (Sterbenz)
    chosen = expo - 1 + (u < p_up).to(expo.dtype)
    code = torch.sign(x).to(torch.int32) * (chosen + NAT_BIAS)
    return torch.where(torch.abs(x) < _FLT_MIN, 0, code).to(torch.int16)


def ref_nat_pack_prng(x: torch.Tensor, keys: torch.Tensor, sizes) -> torch.Tensor:
    """The in-kernel-PRNG encode: x (d,) f32, keys (nseg, 2), segment ``i``
    of ``sizes[i]`` coordinates drawing ``bits(keys[i], (sizes[i],))`` ->
    :func:`ref_nat_pack` of those bits."""
    return ref_nat_pack(x, ref_segment_bits(keys, sizes, x.device))


def ref_nat_decode(codes: torch.Tensor) -> torch.Tensor:
    """int16 codes -> f32 ``sign * 2^(|code| - 160)``, the power of two built
    from its bits: exact for every code (normal, subnormal, 0 below 2^-149,
    inf at 2^128), with the code's sign on a zero (a negative code below
    2^-149 decodes to -0.0; code 0 to +0.0)."""
    c = codes.to(torch.int32)
    k = torch.abs(c) - NAT_BIAS
    word = torch.where(k >= -126, (torch.clamp(k, max=128) + 127) << 23,
                       torch.where(k >= -149, 1 << torch.clamp(k + 149, min=0, max=22), 0))
    word = word | torch.where(c < 0, torch.iinfo(torch.int32).min, 0)
    return word.to(torch.int32).view(torch.float32)


def ref_nat_decode_sum(codes: torch.Tensor) -> torch.Tensor:
    """codes (n, d) int16 -> (d,) f32: the sequential worker recurrence from
    worker 0's decode (``repro/kernels/ref.py:116``), so a -0.0 survives."""
    acc = ref_nat_decode(codes[0])
    for i in range(1, codes.shape[0]):
        acc = acc + ref_nat_decode(codes[i])
    return acc


def ref_nat_decode_sum_mean(codes: torch.Tensor) -> torch.Tensor:
    """The worker sum, then one true division by n."""
    return div_n(ref_nat_decode_sum(codes), codes.shape[0])


def ref_nat_decode_sum_apply(codes: torch.Tensor, h: torch.Tensor, alpha: float):
    """Fused decode_sum + server update: ``(h + dm, fma(alpha, dm, h))`` with
    ``dm = sum / n``, both (d,)."""
    return ref_apply_server(ref_nat_decode_sum(codes), codes.shape[0], h, alpha)


def ref_sparse_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Compress-side value gather (``repro/kernels/ref.py:124``): x (d,) f32,
    idx (k,) unsigned integer -> (k,) f32 ``x[idx]``."""
    return x.float()[idx.to(torch.int64)]


def _sparse_row(idx: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                d: int) -> torch.Tensor:
    """One worker's dense decode ``zeros(d).at[idx].add(values * scale)``:
    each kept coordinate holds ``0.0 + v * s``, so a ``-0.0`` product reads
    ``+0.0``."""
    row = torch.zeros(d, dtype=torch.float32, device=values.device)
    return row.index_put_((idx.to(torch.int64),), values.float() * scale, accumulate=True)


def ref_sparse_decode_sum(idx: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                          d: int) -> torch.Tensor:
    """Sparse server decode (``repro/kernels/ref.py:129``): idx / values
    (n, k) (indices unique within a worker), scale (k,) f32 -> (d,) f32,
    the rows summed from worker 0's in worker order."""
    acc = _sparse_row(idx[0], values[0], scale, d)
    for i in range(1, idx.shape[0]):
        acc = acc + _sparse_row(idx[i], values[i], scale, d)
    return acc


def ref_sparse_decode_sum_mean(idx: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                               d: int) -> torch.Tensor:
    """The worker sum, then one true division by n."""
    return div_n(ref_sparse_decode_sum(idx, values, scale, d), idx.shape[0])


def ref_dense_copy(x: torch.Tensor) -> torch.Tensor:
    """Identity encode: x (d,) -> a (d,) f32 copy."""
    return x.to(torch.float32, copy=True)


def ref_dense_decode_sum(values: torch.Tensor) -> torch.Tensor:
    """Dense (identity) decode (``repro/kernels/ref.py:143``): values (n, d)
    f32 -> (d,) f32, the rows summed from row 0's, in order (a -0.0
    survives)."""
    acc = values[0].clone()
    for i in range(1, values.shape[0]):
        acc = acc + values[i]
    return acc


def ref_dense_decode_sum_mean(values: torch.Tensor) -> torch.Tensor:
    """The worker sum, then one true division by n."""
    return div_n(ref_dense_decode_sum(values), values.shape[0])
