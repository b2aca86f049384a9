"""Compression configuration — a frozen, hashable factory over the registry.

The port's copy of ``repro.core.compression.CompressionConfig`` with the
fields the flat (uniform) round reads, VR-DIANA's, the compressed
downlink's, elastic participation's and the wire schedule's (chunks and the
two-level topology) included, and the tree-level helpers over the
compressor interface (:func:`compress_tree`, :func:`decompress_tree`).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from . import prng
from .compressors import make_compressor
from .compressors.registry import canonical_name
from .compressors.ternary import TernaryCompressor
from .packing import unpack2bit
from .participation import ParticipationSpec
from .quantization import QuantizedBlocks
from .tree import paths

__all__ = ["CompressionConfig", "compress_tree", "decompress_tree", "payload_bits_per_dim"]


@dataclass(frozen=True)
class CompressionConfig:
    """method:     ``diana`` / ``qsgd`` / ``terngrad`` / ``dqgd`` / ``ternary`` /
                ``natural`` / ``randk`` (``rand-k``) / ``topk_ef`` (``top-k-ef``) /
                ``identity`` (``none``)
    p:          quantization norm power (``math.inf``, 2.0, 1.0, or > 2)
    block_size: quantization block d_l (Def. 2; ternary only)
    alpha:      memory learning rate override (None: alpha_p/2, Cor. 1, for
                ternary; 8/9 for natural; k/d per leaf for rand-k)
    k:          kept coordinates per leaf for rand-k / top-k
    h_dtype:    dtype of the DIANA memories
    bucketed:   aggregate the whole model as ONE flat buffer (bitwise the
                per-leaf layout; the flag selects the execution layout)
    vr:         VR-DIANA (arXiv:1904.05115): a per-worker L-SVRG control
                variate under the compressed differences (:mod:`.vr`)
    vr_p:       its snapshot-refresh probability (None: the caller resolves
                the paper's 1/m with :func:`.vr.resolve_vr_p`)
    down_method: the downlink (server -> worker) operator for ``ghat``, with
                its own memory ``h_down``; None keeps the broadcast exact
    down_k:     kept coordinates of a sparse downlink (None: ``k``)
    down_bucketed: the downlink's layout (None: follows ``bucketed``)
    participation: elastic participation
                (:class:`~repro_torch.core.participation.ParticipationSpec`):
                None or a trivial spec keep the all-workers round
    chunk_bytes: target bytes (of padded f32 buffer) per chunk of the bucketed
                wire (:class:`~repro_torch.core.bucket.ChunkedSchedule`):
                chunk i+1's gather is issued before chunk i's decode; 0 keeps
                the one-chunk wire.  Bitwise either way; bucketed only
    topology:   ``"flat"`` or ``"hierarchical"`` (an uncompressed mean over
                ``node_size`` workers, then the compressed exchange between
                nodes, with one memory per node).  Bucketed only
    node_size:  workers per node under ``"hierarchical"`` (divides n; 1 is flat)"""

    method: str = "diana"
    p: float = math.inf
    block_size: int = 2048
    alpha: Optional[float] = None
    k: int = 64
    h_dtype: torch.dtype = torch.float32
    bucketed: bool = False
    vr: bool = False
    vr_p: Optional[float] = None
    down_method: Optional[str] = None
    down_k: Optional[int] = None
    down_bucketed: Optional[bool] = None
    participation: Optional[ParticipationSpec] = None
    chunk_bytes: int = 0
    topology: str = "flat"
    node_size: int = 1

    def __post_init__(self):
        canonical_name(self.method)  # raises on unknown methods
        if self.down_method is not None:
            canonical_name(self.down_method)
        if self.block_size % 4:
            raise ValueError("block_size must be a multiple of 4 for 2-bit packing")
        if self.vr_p is not None and not 0.0 < self.vr_p <= 1.0:
            raise ValueError(f"vr_p must be in (0, 1], got {self.vr_p}")
        if self.participation is not None and not isinstance(self.participation,
                                                             ParticipationSpec):
            raise TypeError("participation must be a ParticipationSpec")
        if self.chunk_bytes < 0:
            raise ValueError(f"chunk_bytes must be >= 0, got {self.chunk_bytes}")
        if self.topology not in ("flat", "hierarchical"):
            raise ValueError(
                f"topology must be 'flat' or 'hierarchical', got {self.topology!r}")
        if self.node_size < 1:
            raise ValueError(f"node_size must be >= 1, got {self.node_size}")
        if self.topology == "hierarchical" and not self.bucketed:
            raise ValueError("topology='hierarchical' requires bucketed=True "
                             "(the two-level round runs on the fused wire)")

    def make(self):
        """The configured compressor (memoized: compressors are stateless)."""
        return _make_cached(self)

    def down_config(self) -> Optional["CompressionConfig"]:
        """The downlink operator's config, or None: ``down_method`` through
        the same factory, ``down_k`` / ``down_bucketed`` defaulting to the
        uplink's ``k`` / layout, never VR (a worker-side transform) and never
        participation (the broadcast reaches every worker; a degraded step
        freezes ``h_down`` at the caller).  The broadcast chunks as the uplink
        does; the topology is an uplink concern and resets to flat."""
        if self.down_method is None:
            return None
        return replace(self, method=self.down_method,
                       k=self.k if self.down_k is None else self.down_k,
                       bucketed=self.bucketed if self.down_bucketed is None
                       else self.down_bucketed,
                       down_method=None, down_k=None, down_bucketed=None, vr=False, vr_p=None,
                       participation=None, topology="flat", node_size=1)


@functools.lru_cache(maxsize=None)
def _make_cached(cfg: CompressionConfig):
    return make_compressor(cfg)


def compress_tree(tree, key: torch.Tensor, cfg: CompressionConfig):
    """Compress a ``{path: tensor}`` gradient (difference) leaf by leaf: leaf
    ``i`` (in :func:`~repro_torch.core.tree.paths` order), flattened to f32,
    through ``cfg``'s compressor with ``split(key, n_leaves)[i]``.

    Returns ``(payloads, locals)``: one :class:`Payload` per leaf (the wire
    format), and the worker's decode-ready form, a
    :class:`~repro_torch.core.quantization.QuantizedBlocks` for the ternary
    family and the payload itself otherwise.  On the card each leaf runs the
    operator's encode kernel."""
    comp = cfg.make()
    order = paths(tree)
    keys = prng.split(key, len(order))
    payloads, locals_ = {}, {}
    for i, path in enumerate(order):
        pay = comp.compress(tree[path].reshape(-1).float(), keys[i])
        payloads[path] = pay
        locals_[path] = (QuantizedBlocks(signs=unpack2bit(pay.packed), scales=pay.scales)
                         if isinstance(comp, TernaryCompressor) else pay)
    return payloads, locals_


def decompress_tree(payload, like, cfg: CompressionConfig):
    """Decode ``{path: Payload}`` back to dense leaves in the shapes and
    dtypes of ``like``'s (one worker's decode per leaf: a kernel on the
    card)."""
    comp = cfg.make()
    out = {}
    for path in paths(like):
        leaf = like[path]
        dense = comp.decode(payload[path], leaf.numel())
        out[path] = dense.to(leaf.dtype).reshape(leaf.shape)
    return out


def payload_bits_per_dim(cfg: CompressionConfig, d: Optional[int] = None) -> float:
    """Communication cost per coordinate of the configured operator."""
    return cfg.make().bits_per_dim(d)
