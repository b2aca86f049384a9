"""JAX's default PRNG (threefry2x32, partitionable mode) in plain torch.

Every stochastic draw of the ternary operator comes from ``jax.random.bits``
on keys made by ``PRNGKey`` / ``fold_in`` / ``split``.  Reproducing those bit
for bit is what lets the port's payloads equal the JAX package's.  The
functions follow ``jax/_src/prng.py`` (jax 0.9.0, ``jax_threefry_partitionable
=True``):

* ``PRNGKey(seed)``   -> ``[seed >> 32, seed & 0xFFFFFFFF]``
* ``fold_in(k, d)``   -> ``threefry2x32(k, (0, d))``
* ``split(k, n)[i]``  -> ``threefry2x32(k, (0, i))`` (both output words)
* ``bits(k, shape)``  -> ``x0 ^ x1`` of ``threefry2x32(k, (i >> 32, i & M))``
  over the flat index ``i`` (counter mode: a batched draw over several keys
  is the per-key draws, bit for bit).

On top of ``bits``, four draws of ``jax/_src/random.py`` (float32 and int32,
JAX's defaults without x64): :func:`uniform` (``_uniform``: the top 23 bits
as the mantissa of a float in [1, 2), minus 1), :func:`bernoulli`
(``uniform < p``), :func:`randint` (``_randint``: two 32-bit draws from
``split(key)``, folded into the span with a multiplier) and
:func:`exponential` (``_exponential``: ``-log1p(-uniform)``).  The VR coins,
the participation masks and the convex harness's minibatch indices come
from them.

Keys are int64 CPU tensors of shape ``(..., 2)`` holding uint32 words.  Torch
has no uint32 arithmetic on the CPU, so words live in int64 and every add is
masked with ``& 0xFFFFFFFF``.  Drawn bits come back as int32 tensors holding
the uint32 bit pattern (the layout the CUDA kernels read as ``uint32``).
:func:`bits` is the plain version of the threefry CUDA helper
(``repro_torch.kernels.threefry``), which the trainer uses on the card.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["MASK", "PRNGKey", "fold_in", "split", "bits", "threefry2x32",
           "key_words", "to_int32", "uniform", "bernoulli", "randint", "exponential"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 hash on int64 tensors of uint32 words
    (``k0``/``k1`` broadcast against the counters)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``(2,)`` tensor."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64)


def key_words(key: torch.Tensor):
    """The two uint32 words of one key as Python ints."""
    return int(key[0]), int(key[1])


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for one key and an integer ``data``."""
    k0, k1 = key_words(key)
    x0, x1 = threefry2x32(k0, k1, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & MASK], dtype=torch.int64))
    return torch.cat([x0, x1])


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``(num, 2)`` keys."""
    k0, k1 = key_words(key)
    lo = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([x0, x1], dim=-1)


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 uint32 words -> int32 tensor with the same bit pattern."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


# counters per pass of the int64 emulation in :func:`bits`: its temporaries
# are ~8 int64 words per counter, so a 210 M-word leaf drawn whole would
# take ~13 GB of a card shared by four ranks
BITS_CHUNK = 1 << 24


def bits(key: torch.Tensor, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, dtype=uint32)`` as an int32 bit pattern
    (plain int64 emulation, on ``device``), drawn :data:`BITS_CHUNK`
    counters at a time: each word depends on its counter alone, so the
    chunks give the same bits."""
    k0, k1 = key_words(key)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int32, device=device)
    for lo in range(0, n, BITS_CHUNK):
        idx = torch.arange(lo, min(n, lo + BITS_CHUNK), dtype=torch.int64, device=device)
        x0, x1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
        out[lo:lo + idx.numel()] = to_int32(x0 ^ x1)
    return out.reshape(tuple(shape))


def _words(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``bits(key, shape)`` as int64 uint32 words."""
    return bits(key, shape).to(torch.int64) & MASK


def uniform(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)): the word's top
    23 bits OR ``0x3F800000`` read as a float in [1, 2), minus 1.0 (exact).
    Not :func:`repro_torch.core.quantization.uniform_from_bits`, the
    quantizers' ``(bits >> 8) * 2^-24``."""
    w = (_words(key, shape) >> 9) | 0x3F800000
    return to_int32(w).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < float32(p)``."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 values, as
    int64): ``higher, lower = bits(split(key)[0]), bits(split(key)[1])``,
    ``span = maxval - minval`` (1 when empty), ``mult = (2^16 % span)^2 %
    span`` and ``minval + ((higher % span) * mult + lower % span) % span``,
    every product and sum wrapped to 32 bits as uint32 arithmetic wraps."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError(f"randint: [{minval}, {maxval}) is outside int32")
    k1, k2 = split(key, 2)
    hi, lo = _words(k1, shape), _words(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (((2**16 % span) ** 2) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return minval + off % span


def exponential(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.exponential(key, shape)`` (float32): ``-log1p(-u)`` of
    the :func:`uniform` draw ``u``.  torch's ``log1p`` and XLA's may differ
    in the last place."""
    return -torch.log1p(-uniform(key, shape))
