"""Dense (identity-operator) payload kernels on the card: the compress-side
copy of the f32 values and the server-side worker sum (sum, or mean).

Replaces ``src/repro/kernels/dense.py:dense_copy``, ``:dense_decode_sum``
and ``:dense_decode_sum_mean`` (Pallas TPU kernels; ``pallas_call`` at
``:41``, ``:79``, ``:95``) with one source, ``csrc/dense.cu``.  The copy is a
float4 streaming pass.  The sum and the mean share one template: each thread
owns 4 coordinates and loops the workers in registers from worker 0's value
(a -0.0 survives), in worker order, and the mean divides once by n (IEEE):
bitwise the plain versions in ``kernels/ref.py``.

Bound: bytes.  Copy: 8 B per coordinate.  Sum / mean: 4 B per coordinate
per worker in, 4 B out.
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import LAUNCHES, check, library, stream_ptr
from .ref import ref_dense_copy, ref_dense_decode_sum, ref_dense_decode_sum_mean

__all__ = ["dense_copy", "dense_decode_sum", "dense_decode_sum_mean", "plain"]

plain = {
    "dense_copy": ref_dense_copy,
    "dense_decode_sum": ref_dense_decode_sum,
    "dense_decode_sum_mean": ref_dense_decode_sum_mean,
}


def dense_copy(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (d,) f32 on a CUDA device -> (d,) f32 copy, written into ``out`` when
    given (a contiguous (d,) f32 tensor there, e.g. a worker's row of a
    gathered buffer; any 4-byte alignment)."""
    if not x.is_cuda:
        raise ValueError(f"dense_copy launches a CUDA kernel; got {x.device}")
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"dense_copy: x must be (d,) float32, got {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    if out is None:
        out = torch.empty_like(x)
    elif (out.dtype != torch.float32 or out.shape != x.shape or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError("dense_copy: out must be a contiguous float32 tensor shaped like x "
                         "on its device")
    check(library().dense_copy(x.data_ptr(), out.data_ptr(), x.numel(), stream_ptr(x.device)),
          "dense_copy")
    LAUNCHES["dense_copy"] += 1
    return out


def _decode(mean: int, name: str, values: torch.Tensor) -> torch.Tensor:
    if not values.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel; got {values.device}")
    if values.dtype != torch.float32 or values.dim() != 2 or values.shape[0] < 1:
        raise ValueError(f"{name}: values must be (n, d) float32 with n >= 1")
    if values.stride(1) != 1:
        values = values.contiguous()
    n, d = values.shape
    out = torch.empty(d, dtype=torch.float32, device=values.device)
    check(library().dense_decode(mean, values.data_ptr(), values.stride(0) if n > 1 else 0, n,
                                 d, out.data_ptr(), stream_ptr(values.device)), name)
    LAUNCHES[name] += 1
    return out


def dense_decode_sum(values: torch.Tensor) -> torch.Tensor:
    """values (n, d) f32 -> (d,) f32 ``v_0 + v_1 + ... + v_{n-1}`` from
    worker 0's row, in order.  Rows may sit any number of elements apart
    (views of a gathered buffer)."""
    return _decode(0, "dense_decode_sum", values)


def dense_decode_sum_mean(values: torch.Tensor) -> torch.Tensor:
    """The same sum, then one IEEE division by n."""
    return _decode(1, "dense_decode_sum_mean", values)
