"""The collectives of the port's rounds and tensor-parallel layers, counted.

Each function calls its ``torch.distributed`` counterpart (looked up at call
time, so a caller that wraps ``dist``'s function sees every call) and adds
the call and its bytes to :data:`STATS`, from which a caller reports what
crossed the wire in a step.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

__all__ = ["STATS", "all_reduce", "all_gather_into_tensor", "all_gather_bytes"]

# (collective, "calls" | "bytes") -> count
STATS: Counter = Counter()


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    """``dist.all_reduce`` in place."""
    STATS[("all_reduce", "calls")] += 1
    STATS[("all_reduce", "bytes")] += t.numel() * t.element_size()
    return dist.all_reduce(t, op=op, group=group)


def all_gather_into_tensor(out: torch.Tensor, src: torch.Tensor, group=None,
                           async_op: bool = False):
    """``dist.all_gather_into_tensor``."""
    STATS[("all_gather_into_tensor", "calls")] += 1
    STATS[("all_gather_into_tensor", "bytes")] += out.numel() * out.element_size()
    return dist.all_gather_into_tensor(out, src, group=group, async_op=async_op)


def all_gather_bytes(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """``(n, *t.shape)``: ``t`` from each of the ``n`` ranks of ``group`` in
    group-rank order, gathered as its bytes (gloo gathers no uint16, uint32
    or int16; bytes cross every backend)."""
    src = t.contiguous().view(torch.uint8).reshape(-1)
    out = torch.empty((n * src.numel(),), dtype=torch.uint8, device=src.device)
    all_gather_into_tensor(out, src, group=group)
    return out.view(n, src.numel()).view(t.dtype).reshape(n, *t.shape)
