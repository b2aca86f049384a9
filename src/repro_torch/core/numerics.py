"""Float32 arithmetic the way the JAX package's jitted round rounds it:
a fused multiply-add rounded once, and a true division by the worker count.

The JAX package runs its DIANA round inside jitted graphs, where XLA
contracts every ``h + alpha * x`` into one FMA (``repro.kernels.ref``'s
``ref_apply_server`` note).  Eager torch rounds the product first, which is
1 ulp off on a fraction of coordinates.  :func:`fma32` reproduces the FMA
exactly with float64 arithmetic:

* ``a * b`` of two float32 values is exact in float64 (48 significant bits);
* ``t = p + c`` rounds to 53 bits; TwoSum recovers its exact error ``e``;
* rounding to odd (where ``t`` is inexact and its last bit even, step one ulp
  toward ``e``) then rounding to float32 gives the correctly rounded
  ``fma(a, b, c)``, because 53 >= 24 + 2 bits.

It works on any device and processes ``CHUNK`` elements at a time to bound
the float64 temporaries (the trainer's flat buffers hold ~1e9 coordinates).
The rate is one scalar, or one scalar per segment of a flat buffer
(:class:`SegmentRates`: rand-k's ``k/d`` per leaf), applied on each
segment's view so no ``(Dp,)`` rate vector is ever built; under ``jax.jit``
XLA contracts the JAX package's ``h + alpha_vec * x`` with a constant rate
vector into one FMA as well.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

__all__ = ["fma32", "div_n", "CHUNK", "SegmentRates"]

CHUNK = 1 << 24


def _fma_chunk(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    p = b.double() * a
    c64 = c.double()
    t = p + c64
    bb = t - p
    err = (p - (t - bb)) + (c64 - bb)
    inexact_even = (err != 0) & ((t.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(t, float("inf")),
                         torch.full_like(t, float("-inf")))
    return torch.where(inexact_even, torch.nextafter(t, toward), t).float()


class SegmentRates(NamedTuple):
    """One rate per segment of a flat buffer: ``rates[i]`` applies to
    ``[offsets[i], offsets[i] + sizes[i])``; the segments tile the buffer."""

    rates: Tuple[float, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]


def fma32(a: Union[float, SegmentRates], b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` for float32 tensors ``b``, ``c`` of one shape
    and a Python float ``a``, rounded to float32 first as JAX rounds its
    weak-typed scalars (and its f32 rate vectors).  With :class:`SegmentRates`
    the flat buffer (1-D ``b``, ``c``) takes each segment's rate."""
    if b.shape != c.shape:
        raise ValueError(f"fma32 shapes differ: {tuple(b.shape)} vs {tuple(c.shape)}")
    if isinstance(a, SegmentRates):
        if c.dim() != 1 or sum(a.sizes) != c.numel():
            raise ValueError(f"segment rates cover {sum(a.sizes)} coordinates, not the "
                             f"flat buffer of shape {tuple(c.shape)}")
        segments = zip(a.rates, a.offsets, a.sizes)
    else:
        segments = [(a, 0, c.numel())]
    bf, cf = b.float().reshape(-1), c.float().reshape(-1)
    out = torch.empty_like(cf)
    for rate, off, size in segments:
        rate = float(np.float32(rate))
        for s in range(off, off + size, CHUNK):
            e = min(s + CHUNK, off + size)
            out[s:e] = _fma_chunk(rate, bf[s:e], cf[s:e])
    return out.reshape(c.shape)


def div_n(s: torch.Tensor, n: int) -> torch.Tensor:
    """``s / n`` as one IEEE division per element, on every device: torch's
    CUDA division by a Python scalar multiplies by the rounded reciprocal
    instead (not the same bits unless n is a power of two); a 0-dim tensor
    divisor on ``s``'s device takes the true division, as the CUDA kernels'
    epilogues do.  (The JAX package's jitted graphs divide by a constant n
    as ``s * f32(1/n)``, XLA's rewrite: the same bits for n a power of two,
    within 1 ulp otherwise; ROADMAP.md queue 3.)"""
    return s / torch.tensor(float(n), dtype=s.dtype, device=s.device)
