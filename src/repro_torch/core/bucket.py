"""Flat-buffer (bucketed) aggregation layout — one wire object per step.

* :class:`BucketLayout` — the static layout of a parameter tree as ONE flat
  f32 buffer: per-leaf offsets (in ``jax.tree_util`` leaf order), segments
  padded to the operator's block alignment, zero pads.
* :class:`BucketedCompressor` — the ordinary compressor interface over that
  buffer, delegating to the operator's ``*_bucketed`` hooks, so a round is
  one compress, one payload and one fused decode per worker set.
* :class:`GroupedBucketLayout` — one :class:`BucketLayout` per group of a
  compression policy (:mod:`repro_torch.core.policy`), each aligned to its
  own operator: a grouped round fuses each group, not the whole model.
* :func:`fuse_payload` / :func:`unfuse_payload` — the wire object: every
  populated payload field byte-cast into ONE uint8 buffer, so the worker
  all-gather is one collective (``repro/core/bucket.py:291-343``);
  :func:`wire_roundtrip` puts the downlink's payload through it.

Bitwise contract (as in ``repro.core.bucket``): the bucketed round equals the
per-leaf round — same per-segment PRNG draws, same per-block scales, same
f32 recurrences.  The chunked schedule and wire checksums are later slices
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from . import tree as T
from .compressors.base import Compressor, Payload

__all__ = ["BucketLayout", "GroupedBucketLayout", "BucketedCompressor", "bucketed_compressor",
           "payload_recipe", "fuse_payload", "unfuse_payload", "wire_roundtrip"]


@dataclass(frozen=True)
class BucketLayout:
    """Static flat layout of a ``{path: tensor}`` tree (hashable).

    paths:        leaf paths in flatten order
    shapes/dtypes per-leaf shapes and dtypes
    sizes:        per-leaf element counts (unpadded)
    padded_sizes: ``sizes`` rounded up to ``align``
    offsets:      start of each leaf's segment in the flat buffer
    align:        segment alignment (the operator's ``bucket_align()``)
    """

    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    padded_sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    align: int

    @classmethod
    def for_tree(cls, tree: Mapping[str, torch.Tensor], align: int = 1) -> "BucketLayout":
        paths = tuple(T.paths(tree))
        shapes = tuple(tuple(tree[p].shape) for p in paths)
        dtypes = tuple(tree[p].dtype for p in paths)
        sizes = tuple(math.prod(s) for s in shapes)
        padded = tuple(-(-s // align) * align for s in sizes)
        offsets = tuple(sum(padded[:i]) for i in range(len(padded)))
        return cls(paths=paths, shapes=shapes, dtypes=dtypes, sizes=sizes,
                   padded_sizes=padded, offsets=offsets, align=align)

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    @property
    def size(self) -> int:
        return sum(self.sizes)

    @property
    def padded_size(self) -> int:
        return sum(self.padded_sizes)

    def flatten(self, tree: Mapping[str, torch.Tensor],
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Tree -> ONE padded flat f32 buffer (segment pads are zeros),
        written into ``out`` when given (the trainer reuses one buffer)."""
        first = tree[self.paths[0]]
        if out is None:
            out = torch.empty(self.padded_size, dtype=torch.float32, device=first.device)
        for p, off, size, ps in zip(self.paths, self.offsets, self.sizes, self.padded_sizes):
            out[off:off + size].copy_(tree[p].reshape(-1))
            if ps > size:
                out[off + size:off + ps].zero_()
        return out

    def unflatten(self, flat: torch.Tensor, cast: bool = True) -> Dict[str, torch.Tensor]:
        """Flat buffer -> tree (dropping pads); ``cast`` restores leaf dtypes."""
        outs = {}
        for p, off, size, shape, dt in zip(self.paths, self.offsets, self.sizes,
                                           self.shapes, self.dtypes):
            seg = flat[off:off + size].reshape(shape)
            outs[p] = seg.to(dt) if cast else seg
        return outs

    def split_padded(self, flat: torch.Tensor):
        """The per-leaf padded segment views of the flat buffer."""
        return [flat[off:off + ps] for off, ps in zip(self.offsets, self.padded_sizes)]


@dataclass(frozen=True)
class GroupedBucketLayout:
    """One :class:`BucketLayout` per compression-policy group
    (``repro/core/bucket.py:254``): ``names`` are the group names (the keys
    of a grouped state), ``rule_ids`` each group's rule."""

    names: Tuple[str, ...]
    rule_ids: Tuple[int, ...]
    layouts: Tuple[BucketLayout, ...]

    @property
    def n_groups(self) -> int:
        return len(self.layouts)

    @property
    def size(self) -> int:
        return sum(l.size for l in self.layouts)

    @property
    def padded_size(self) -> int:
        return sum(l.padded_size for l in self.layouts)

    @property
    def n_leaves(self) -> int:
        return sum(l.n_leaves for l in self.layouts)


class BucketedCompressor(Compressor):
    """A :class:`Compressor` over a :class:`BucketLayout`'s flat buffer."""

    def __init__(self, base: Compressor, layout: BucketLayout):
        self.base = base
        self.layout = layout
        self.name = f"bucketed:{base.name}"
        self.carries_state = base.carries_state

    def compress(self, delta: torch.Tensor, key: torch.Tensor, *,
                 out: Optional[Payload] = None) -> Payload:
        """ONE encode of the flat buffer, into ``out`` (a row of
        :meth:`gathered`) when given."""
        return self.base.compress_bucketed(self.layout, delta, key, out=out)

    def gathered(self, n: int, device) -> Payload:
        """An uninitialised stacked payload of ``n`` workers (the all-gather's
        output shape); worker ``w`` encodes into ``gathered(...).select(w)``."""
        return self.base.gathered_bucketed(self.layout, n, device)

    def decode(self, payload: Payload, d: Optional[int] = None) -> torch.Tensor:
        return self.base.decode_bucketed(self.layout, payload)

    def decode_sum(self, gathered: Payload, n: int, d: Optional[int] = None) -> torch.Tensor:
        return self.base.decode_sum_bucketed(self.layout, gathered, n)

    def decode_sum_apply(self, gathered: Payload, n: int, d, h_server):
        return self.base.decode_sum_apply_bucketed(self.layout, gathered, n, h_server)

    def bits_per_dim(self, d: Optional[int] = None) -> float:
        """Size-weighted mean of the per-leaf costs."""
        lay = self.layout
        return sum(self.base.bits_per_dim(s) * s for s in lay.sizes) / max(lay.size, 1)

    # -------------------------------------------------------- memory rule

    def memory_alpha(self, d: Optional[int] = None) -> float:
        return self.base.memory_alpha(d)

    def compress_input(self, g, h):
        return self.base.compress_input(g, h)

    def compress_input_(self, g, h):
        return self.base.compress_input_(g, h)

    def next_memory(self, h, dhat, delta):
        return self.base.next_memory_bucketed(self.layout, h, dhat, delta)

    def next_server_memory(self, h, dhat_mean):
        return self.base.next_server_memory_bucketed(self.layout, h, dhat_mean)

    def server_direction(self, h, dhat_mean):
        return self.base.server_direction(h, dhat_mean)


@functools.lru_cache(maxsize=None)
def bucketed_compressor(cfg, layout: BucketLayout) -> BucketedCompressor:
    """Cached ``(CompressionConfig, BucketLayout) -> BucketedCompressor``."""
    return BucketedCompressor(cfg.make(), layout)


# ---------------------------------------------------------------------------
# Payload wire fusion: one uint8 buffer per gather
# ---------------------------------------------------------------------------

def payload_recipe(pay: Payload):
    """Static ``(field, shape, dtype)`` description used to un-fuse the buffer."""
    return tuple((i, tuple(f.shape), f.dtype) for i, f in enumerate(pay) if f is not None)


def fuse_payload(pay: Payload) -> torch.Tensor:
    """Byte-cast and concatenate every populated field into ONE uint8 buffer
    of shape ``(lead, W)`` (``lead`` = the fields' shared leading dim), so the
    worker all-gather is a single collective.  ``Tensor.view(torch.uint8)``
    is exact, like ``bitcast_convert_type``: on a little-endian host the
    bytes are the JAX package's."""
    parts = []
    lead = None
    for f in pay:
        if f is None:
            continue
        lead = f.shape[0] if lead is None else lead
        if f.shape[0] != lead:
            raise ValueError("payload fields must share the leading dim")
        parts.append(f.contiguous().view(torch.uint8).reshape(lead, -1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def unfuse_payload(buf: torch.Tensor, recipe) -> Payload:
    """Inverse of :func:`fuse_payload`; tolerates extra leading (worker) dims
    on ``buf`` from the gather.  Each field comes back contiguous."""
    batch = tuple(buf.shape[:-2])
    fields: list = [None] * len(Payload._fields)
    start = 0
    for fi, shape, dt in recipe:
        width = math.prod(shape[1:]) * dt.itemsize
        part = buf[..., start:start + width].contiguous()
        start += width
        fields[fi] = part.view(dt).reshape(*batch, *shape)
    return Payload(*fields)


def wire_roundtrip(pay: Payload) -> Payload:
    """A payload through its one-buffer wire object and back
    (``repro/core/bucket.py:316``): the compressed downlink's broadcast in
    the bucketed layout.  The byte casts are exact, so the fields come back
    bitwise; a single-field payload already is one wire object and passes
    as it is."""
    if sum(f is not None for f in pay) <= 1:
        return pay
    return unfuse_payload(fuse_payload(pay), payload_recipe(pay))
