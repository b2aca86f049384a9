"""The collectives of the port's rounds and tensor-parallel layers, counted.

Each function calls its ``torch.distributed`` counterpart (looked up at call
time, so a caller that wraps ``dist``'s function sees every call) and adds
the call and its bytes to :data:`STATS`, from which a caller reports what
crossed the wire in a step.  A ``tag`` counts the call and its bytes under
``(tag, ...)`` as well (the model code's ``"moe"`` and ``"frontend"``).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

__all__ = ["STATS", "all_reduce", "all_gather_into_tensor", "all_gather_bytes"]

# (collective or tag, "calls" | "bytes") -> count
STATS: Counter = Counter()


def _count(name: str, nbytes: int, tag) -> None:
    for key in (name,) if tag is None else (name, tag):
        STATS[(key, "calls")] += 1
        STATS[(key, "bytes")] += nbytes


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None, tag=None):
    """``dist.all_reduce`` in place."""
    _count("all_reduce", t.numel() * t.element_size(), tag)
    return dist.all_reduce(t, op=op, group=group)


def all_gather_into_tensor(out: torch.Tensor, src: torch.Tensor, group=None,
                           async_op: bool = False, tag=None):
    """``dist.all_gather_into_tensor``."""
    _count("all_gather_into_tensor", out.numel() * out.element_size(), tag)
    return dist.all_gather_into_tensor(out, src, group=group, async_op=async_op)


def all_gather_bytes(t: torch.Tensor, n: int, group=None, tag=None) -> torch.Tensor:
    """``(n, *t.shape)``: ``t`` from each of the ``n`` ranks of ``group`` in
    group-rank order, gathered as its bytes (gloo gathers no uint16, uint32
    or int16; bytes cross every backend)."""
    src = t.contiguous().view(torch.uint8).reshape(-1)
    out = torch.empty((n * src.numel(),), dtype=torch.uint8, device=src.device)
    all_gather_into_tensor(out, src, group=group, tag=tag)
    return out.view(n, src.numel()).view(t.dtype).reshape(n, *t.shape)
