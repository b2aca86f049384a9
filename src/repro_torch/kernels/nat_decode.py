"""Server-side decode of natural-compression payloads on the card: decode n
int16 code rows and sum them over workers, with the plain sum, the mean, or
DIANA's server update as the epilogue.

Replaces ``src/repro/kernels/nat_pack.py:nat_decode_sum``,
``:nat_decode_sum_mean`` and ``:nat_decode_sum_apply`` (Pallas TPU kernels;
``pallas_call`` at ``:228``, ``:250``, ``:283``) with one source,
``csrc/nat_decode.cu``, templated on the epilogue.  Each thread owns 8
coordinates and loops the workers in registers from worker 0's decode (a
-0.0 survives), in worker order: bitwise the plain versions in
``kernels/ref.py``.  A worker's own decode is the one-worker sum.

Bound: bytes, 2 B per coordinate per worker in, plus 4 B out (sum/mean) or
4 B in + 8 B out (apply).
"""

from __future__ import annotations

import numpy as np
import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_nat_decode_sum, ref_nat_decode_sum_apply, ref_nat_decode_sum_mean

__all__ = ["nat_decode_sum", "nat_decode_sum_mean", "nat_decode_sum_apply", "plain"]

plain = {
    "nat_decode_sum": ref_nat_decode_sum,
    "nat_decode_sum_mean": ref_nat_decode_sum_mean,
    "nat_decode_sum_apply": ref_nat_decode_sum_apply,
}

_SUM, _MEAN, _APPLY = 0, 1, 2


def _check_codes(codes: torch.Tensor):
    """(n, d) int16 on the card, each row contiguous; rows may sit any
    multiple of 2 bytes apart (a view of a wider gathered buffer)."""
    if not codes.is_cuda:
        raise ValueError(f"nat_decode launches a CUDA kernel; got {codes.device}")
    if codes.dtype != torch.int16 or codes.dim() != 2 or codes.shape[0] < 1:
        raise ValueError("nat_decode: codes must be (n, d) int16 with n >= 1")
    if codes.stride(1) != 1:
        codes = codes.contiguous()
    n, d = codes.shape
    return codes, n, d, (codes.stride(0) if n > 1 else 0)


def _launch(epi: int, name: str, codes, ld, n, d, h, out0, out1, alpha):
    check(library().nat_decode(
        epi, codes.data_ptr(), ld, n, d, None if h is None else h.data_ptr(),
        out0.data_ptr(), None if out1 is None else out1.data_ptr(),
        float(np.float32(alpha)), stream_ptr(codes.device)), name)
    LAUNCHES[name] += 1


def nat_decode_sum(codes: torch.Tensor) -> torch.Tensor:
    """codes (n, d) int16 -> (d,) f32 sum of the decodes over n."""
    codes, n, d, ld = _check_codes(codes)
    out = torch.empty(d, dtype=torch.float32, device=codes.device)
    _launch(_SUM, "nat_decode_sum", codes, ld, n, d, None, out, None, 0.0)
    return out


def nat_decode_sum_mean(codes: torch.Tensor) -> torch.Tensor:
    """Fused decode_sum + divide: (d,) f32 mean over n."""
    codes, n, d, ld = _check_codes(codes)
    out = torch.empty(d, dtype=torch.float32, device=codes.device)
    _launch(_MEAN, "nat_decode_sum_mean", codes, ld, n, d, None, out, None, 0.0)
    return out


def nat_decode_sum_apply(codes: torch.Tensor, h: torch.Tensor, *, alpha: float):
    """Fused decode_sum + DIANA server update: h (d,) f32 ->
    ``(ghat, new_h) = (h + dm, fma(alpha, dm, h))``, ``dm = sum / n``."""
    codes, n, d, ld = _check_codes(codes)
    if h.shape != (d,) or h.dtype != torch.float32 or h.device != codes.device:
        raise ValueError(f"nat_decode_sum_apply: h must be ({d},) float32 on the codes' "
                         "device")
    h = h.contiguous()
    ghat = torch.empty_like(h)
    newh = torch.empty_like(h)
    _launch(_APPLY, "nat_decode_sum_apply", codes, ld, n, d, h, ghat, newh, alpha)
    return ghat, newh
