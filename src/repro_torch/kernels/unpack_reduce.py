"""Server-side decode on the card: unpack n 2-bit ternary payloads and sum
them over workers, with the plain sum, the mean, or DIANA's server update as
the epilogue.

Replaces ``src/repro/kernels/unpack_reduce.py:unpack_reduce``,
``:unpack_reduce_mean`` and ``:unpack_reduce_apply`` (Pallas TPU kernels;
``pallas_call`` at ``:95``, ``:123``, ``:164``) with one source,
``csrc/unpack_reduce.cu``, templated on the epilogue.  The TPU grid revisits
each output tile once per worker; here one thread block owns a block row,
each thread the 4 coordinates of one code byte, and the workers are looped
in registers, from 0.0f, in worker order — deterministic, no atomics,
bitwise the plain versions in ``kernels/ref.py``.

Bound: bytes, 0.25 B per coordinate per worker in, plus 4 B out (sum/mean)
or 4 B in + 8 B out (apply).
"""

from __future__ import annotations

import numpy as np
import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_unpack_reduce, ref_unpack_reduce_apply, ref_unpack_reduce_mean

__all__ = ["unpack_reduce", "unpack_reduce_mean", "unpack_reduce_apply", "plain"]

plain = {
    "unpack_reduce": ref_unpack_reduce,
    "unpack_reduce_mean": ref_unpack_reduce_mean,
    "unpack_reduce_apply": ref_unpack_reduce_apply,
}

_SUM, _MEAN, _APPLY = 0, 1, 2


def _check_payload(packed: torch.Tensor, scales: torch.Tensor):
    if not packed.is_cuda:
        raise ValueError(f"unpack_reduce launches a CUDA kernel; got {packed.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 3:
        raise ValueError("unpack_reduce: packed must be (n, m, B/4) uint8")
    n, m, b4 = packed.shape
    if scales.dtype != torch.float32 or scales.numel() != n * m \
            or scales.device != packed.device:
        raise ValueError("unpack_reduce: scales must be (n, m, 1) float32 on the "
                         "payload's device")
    if not 0 < m < 2**31:
        raise ValueError(f"unpack_reduce: {m} rows (one thread block each) out of range")
    return packed.contiguous(), scales.contiguous(), n, m, 4 * b4


def _launch(epi: int, name: str, packed, scales, h, out0, out1, n, m, b, alpha):
    check(library().unpack_reduce(
        epi, packed.data_ptr(), scales.data_ptr(),
        None if h is None else h.data_ptr(), out0.data_ptr(),
        None if out1 is None else out1.data_ptr(), n, m, b,
        float(np.float32(alpha)), stream_ptr(packed.device)), name)
    LAUNCHES[name] += 1


def unpack_reduce(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """packed (n, m, B/4) u8, scales (n, m, 1) f32 -> (m, B) f32 sum over n."""
    packed, scales, n, m, b = _check_payload(packed, scales)
    out = torch.empty((m, b), dtype=torch.float32, device=packed.device)
    _launch(_SUM, "unpack_reduce", packed, scales, None, out, None, n, m, b, 0.0)
    return out


def unpack_reduce_mean(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Fused decode_sum + divide: (m, B) f32 mean over n."""
    packed, scales, n, m, b = _check_payload(packed, scales)
    out = torch.empty((m, b), dtype=torch.float32, device=packed.device)
    _launch(_MEAN, "unpack_reduce_mean", packed, scales, None, out, None, n, m, b, 0.0)
    return out


def unpack_reduce_apply(packed: torch.Tensor, scales: torch.Tensor, h: torch.Tensor,
                        *, alpha: float):
    """Fused decode_sum + DIANA server update: h (d,) f32 with d <= m * B ->
    flat ``(ghat, new_h) = (h + dm, fma(alpha, dm, h))``, ``dm = sum / n``."""
    packed, scales, n, m, b = _check_payload(packed, scales)
    d = h.shape[0]
    if h.dim() != 1 or h.dtype != torch.float32 or h.device != packed.device:
        raise ValueError("unpack_reduce_apply: h must be a flat float32 tensor on the "
                         "payload's device")
    if -(-d // b) != m:
        raise ValueError(f"h rows {-(-d // b)} != packed rows {m}")
    hp = h.contiguous()
    if d != m * b:
        hp = torch.cat([hp, hp.new_zeros(m * b - d)])
    if hp.data_ptr() % 16:
        raise ValueError("unpack_reduce_apply: h must be 16-byte aligned")
    ghat = torch.empty_like(hp)
    newh = torch.empty_like(hp)
    _launch(_APPLY, "unpack_reduce_apply", packed, scales, hp, ghat, newh, n, m, b, alpha)
    return ghat[:d], newh[:d]
