"""Flat-buffer (bucketed) aggregation layout — one wire object per step.

* :class:`BucketLayout` — the static layout of a parameter tree as ONE flat
  f32 buffer: per-leaf offsets (in ``jax.tree_util`` leaf order), segments
  padded to the operator's block alignment, zero pads.
* :class:`BucketedCompressor` — the ordinary compressor interface over that
  buffer, delegating to the operator's ``*_bucketed`` hooks, so a round is
  one compress, one payload and one fused decode per worker set.
* :class:`ChunkedSchedule` — the layout split into consecutive whole-leaf
  chunks: the chunked wire compresses, gathers and decodes one chunk at a
  time, chunk ``c`` with its slice of the monolithic per-leaf keys.
* :class:`GroupedBucketLayout` — one :class:`BucketLayout` per group of a
  compression policy (:mod:`repro_torch.core.policy`), each aligned to its
  own operator: a grouped round fuses each group, not the whole model.
* :func:`fuse_payload` / :func:`unfuse_payload` — the wire object: every
  populated payload field byte-cast into ONE uint8 buffer, so the worker
  all-gather is one collective (``repro/core/bucket.py:291-343``);
  :func:`wire_roundtrip` puts the downlink's payload through it.
* :func:`add_checksum` / :func:`verify_checksum` — the 8-byte tail the wire
  carries when faults are armed (``repro/core/bucket.py:351-402``).

Bitwise contract (as in ``repro.core.bucket``): the bucketed round equals the
per-leaf round — same per-segment PRNG draws, same per-block scales, same
f32 recurrences; and the chunked round equals the monolithic one, since
chunks hold whole leaves, keys are slices of the monolithic schedule and every
decode and memory recurrence is per coordinate.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from . import tree as T
from .compressors.base import Compressor, Payload

__all__ = ["BucketLayout", "ChunkedSchedule", "GroupedBucketLayout", "BucketedCompressor", "bucketed_compressor",
           "payload_recipe", "fuse_payload", "unfuse_payload", "wire_roundtrip",
           "CHECKSUM_BYTES", "checksum_words", "add_checksum", "verify_checksum",
           "checksum_tail_bits_per_dim"]


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
class ChunkedSchedule:
    """A :class:`BucketLayout` split into consecutive whole-leaf chunks
    (``repro/core/bucket.py:156``).

    Chunk boundaries sit on leaf boundaries, so each leaf keeps its place in
    the monolithic key schedule (:meth:`chunk_keys`) and its ``align``-padded
    segment: sum-of-chunks is bitwise the monolithic round.  ``bounds`` are
    the leaf indices where chunks begin and end (``bounds[0] == 0``,
    ``bounds[-1] == n_leaves``)."""

    layout: BucketLayout
    bounds: Tuple[int, ...]

    @classmethod
    def for_layout(cls, layout: BucketLayout, chunk_bytes: int) -> "ChunkedSchedule":
        """Greedy whole-leaf packing: a chunk closes once it holds at least
        ``chunk_bytes`` of padded f32 buffer (4 bytes per element), so chunk
        sizes need not divide the buffer.  ``chunk_bytes <= 0``, or more than
        the buffer, gives one chunk."""
        if chunk_bytes <= 0:
            return cls(layout=layout, bounds=(0, layout.n_leaves))
        bounds = [0]
        acc = 0
        for i, ps in enumerate(layout.padded_sizes):
            if acc >= chunk_bytes and acc > 0:
                bounds.append(i)
                acc = 0
            acc += 4 * ps
        bounds.append(layout.n_leaves)
        return cls(layout=layout, bounds=tuple(bounds))

    @property
    def n_chunks(self) -> int:
        return len(self.bounds) - 1

    @property
    def chunk_layouts(self) -> Tuple[BucketLayout, ...]:
        """Per-chunk sub-layouts, offsets rebased to the chunk's origin, so
        every ``*_bucketed`` hook (and a sparse payload's indices) works per
        chunk unchanged."""
        return _chunk_layouts(self)

    @property
    def chunk_offsets(self) -> Tuple[int, ...]:
        """Element offset of each chunk in the monolithic flat buffer."""
        lay = self.layout
        return tuple(lay.offsets[b] if b < lay.n_leaves else lay.padded_size
                     for b in self.bounds[:-1])

    @property
    def chunk_sizes(self) -> Tuple[int, ...]:
        """Padded element count of each chunk."""
        return tuple(l.padded_size for l in self.chunk_layouts)

    def split(self, flat: torch.Tensor):
        """Flat buffer -> the per-chunk VIEWS (no copies: writing into a
        chunk writes the buffer).  Splits the last dim, so a stacked ``(n,
        Dp)`` buffer gives ``(n, Dp_c)`` views."""
        return [flat[..., off:off + sz] for off, sz in zip(self.chunk_offsets, self.chunk_sizes)]

    def chunk_keys(self, keys: torch.Tensor, c: int) -> torch.Tensor:
        """Chunk ``c``'s slice of the MONOLITHIC per-leaf key schedule
        ``split(key, n_leaves)``: chunking never re-splits keys."""
        return keys[self.bounds[c]:self.bounds[c + 1]]


@functools.lru_cache(maxsize=None)
def _chunk_layouts(sched: ChunkedSchedule) -> Tuple[BucketLayout, ...]:
    lay = sched.layout
    outs = []
    for b0, b1 in zip(sched.bounds[:-1], sched.bounds[1:]):
        base = lay.offsets[b0] if b0 < lay.n_leaves else lay.padded_size
        outs.append(BucketLayout(paths=lay.paths[b0:b1], shapes=lay.shapes[b0:b1],
                                 dtypes=lay.dtypes[b0:b1], sizes=lay.sizes[b0:b1],
                                 padded_sizes=lay.padded_sizes[b0:b1],
                                 offsets=tuple(o - base for o in lay.offsets[b0:b1]),
                                 align=lay.align))
    return tuple(outs)


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
        self.fused_downlink_input = base.fused_downlink_input

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

    def compress_input_scaled(self, total, scale, h):
        return self.base.compress_input_scaled(total, scale, h)

    def next_memory(self, h, dhat, delta):
        return self.base.next_memory_bucketed(self.layout, h, dhat, delta)

    def next_server_memory(self, h, dhat_mean):
        return self.base.next_server_memory_bucketed(self.layout, h, dhat_mean)

    def server_direction(self, h, dhat_mean):
        return self.base.server_direction(h, dhat_mean)

    def scaled_direction(self, h, total, scale):
        return self.base.scaled_direction(h, total, scale)


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


# ---------------------------------------------------------------------------
# Wire checksums (the fault harness, repro_torch.core.participation)
# ---------------------------------------------------------------------------

# The tail on the fused wire: two uint32 words, the byte sum and the
# position-weighted byte sum (positions 1..L as uint32, so they wrap past
# 2^32), both mod 2^32, little-endian.  An integrity check, not a
# cryptographic one: one XOR-corrupted byte always changes the byte sum.
CHECKSUM_BYTES = 8
_MASK32 = 0xFFFFFFFF
_CHECKSUM_CHUNK = 1 << 24


def checksum_words(flat: torch.Tensor, chunk: int = _CHECKSUM_CHUNK, pos0: int = 0):
    """``(..., L)`` uint8 -> ``[(s1, s2), ...]``, one pair of Python ints per
    row (``repro/core/bucket.py:362``'s ``_checksum_words``): ``s1 = sum_j
    b_j`` and ``s2 = sum_j b_j * ((pos0 + j) mod 2^32)`` over ``j = 1..L``,
    both mod 2^32; ``pos0`` shifts the positions (0 on the wire).

    torch has no uint32 arithmetic, and an int64 copy of a multi-GB wire
    would not fit, so the rows are read in chunks of ``chunk`` bytes: per
    chunk at byte ``c`` the device sums ``b`` and ``b * j`` over the chunk's
    own positions ``j = 1..chunk`` (exact in int64: ``j <= 2^24``), and the
    host adds ``(pos0 + c) * sum(b)`` in Python integers, which is ``s2``'s
    chunk term mod 2^32 whatever the wrap."""
    lead = tuple(flat.shape[:-1])
    L = flat.shape[-1]
    rows = flat.reshape(-1, L)
    j = torch.arange(1, min(chunk, max(L, 1)) + 1, dtype=torch.int64, device=flat.device)
    parts = []
    for c in range(0, L, chunk):
        b = rows[:, c:c + chunk]
        parts.append(torch.stack([b.sum(-1, dtype=torch.int64),
                                  (b * j[:b.shape[1]]).sum(-1)], dim=-1))
    sums = torch.stack(parts).tolist() if parts else []   # (chunks, rows, 2), one sync
    out = []
    for r in range(rows.shape[0]):
        s1 = s2 = 0
        for ci, c in enumerate(range(0, L, chunk)):
            sb, sbj = sums[ci][r]
            s1 += sb
            s2 += (pos0 + c) * sb + sbj
        out.append((s1 & _MASK32, s2 & _MASK32))
    return out if lead else out[0]


def _tail(words, device) -> torch.Tensor:
    s1, s2 = words
    return torch.tensor(list((s1 | (s2 << 32)).to_bytes(8, "little")), dtype=torch.uint8,
                        device=device)


def add_checksum(buf: torch.Tensor) -> torch.Tensor:
    """ONE worker's fused ``(lead, W)`` uint8 buffer -> the 1-D wire
    ``(lead * W + 8,)``: the payload bytes, then the checksum tail
    (``repro/core/bucket.py:371``)."""
    flat = buf.reshape(-1)
    return torch.cat([flat, _tail(checksum_words(flat), flat.device)])


def verify_checksum(wire: torch.Tensor):
    """Inverse of :func:`add_checksum` over any leading (worker) dims:
    ``(..., L + 8) -> ((..., L) payload bytes, (...,) bool ok)`` with ``ok``
    a CPU tensor, False exactly where the recomputed words disagree with the
    tail (``:380``).  The bytes of a failed payload are not sanitised: the
    round excludes it."""
    flat, tail = wire[..., :-CHECKSUM_BYTES], wire[..., -CHECKSUM_BYTES:]
    lead = tuple(wire.shape[:-1])
    got = checksum_words(flat)
    tails = tail.reshape(-1, CHECKSUM_BYTES).cpu().tolist()
    words = got if lead else [got]
    ok = [int.from_bytes(bytes(t), "little") == (s1 | (s2 << 32))
          for t, (s1, s2) in zip(tails, words)]
    return flat, torch.tensor(ok, dtype=torch.bool).reshape(lead)


def checksum_tail_bits_per_dim(layout: BucketLayout, chunk_bytes: int = 0) -> float:
    """Wire bits per coordinate of the checksum tails when faults are armed
    (``:388``): one 8-byte tail per wire buffer, that is one per chunk of the
    :class:`ChunkedSchedule` (the monolithic wire is one chunk)."""
    n_chunks = ChunkedSchedule.for_layout(layout, chunk_bytes).n_chunks
    return CHECKSUM_BYTES * 8.0 * n_chunks / max(layout.size, 1)
