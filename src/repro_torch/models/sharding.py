"""Tensor parallelism over the model axis: the collectives the model code
runs across the ranks that hold one replica's shards (the model group), and
the context that turns them on.

The counterpart of ``repro.models.sharding``: where the JAX model code
annotates activations with logical axes and GSPMD inserts the collectives,
the port's model code calls these four functions, which are identities
outside :func:`model_parallel` (a mesh with no model axis, and every path
that runs no mesh): those paths stay bitwise what they were.

* :func:`copy_to_model` — before a column-parallel product: identity
  forward, all-reduce of the gradient backward (the replicated input's
  gradient sums every shard's part);
* :func:`reduce_from_model` — after a row-parallel product: all-reduce
  forward, identity backward;
* :func:`gather_from_model` — all-gather along a dimension forward, the
  rank's slice of the gradient backward: the last dimension of the
  feature-sharded embedding and the frontend projection, the first of the
  expert-partitioned MoE's per-expert outputs, and the split dimension of
  the Mamba-2 mixer's ``in_proj``, ``conv_w`` and ``out_proj`` (whole
  leaves);
* :func:`vocab_parallel_ce` — the cross-entropy of vocabulary-sharded
  logits: the max and the log-sum-exp all-reduced over the model group,
  the target logit taken from the shard that owns it.

An all-reduce gives the same bits on every rank, so every replicated value
(the residual stream, the norms' inputs, the loss) and every replicated
leaf's gradient is identical across a worker's model ranks.

Each function takes a ``tag`` that :mod:`repro_torch.core.transport` counts
its collectives under besides their own names (the MoE layer's ``"moe"``,
the frontend projection's ``"frontend"``, the Mamba-2 mixer's
``"mamba"``, the serving head's ``"head"``), in the backward too.

Serving over a mesh also runs collectives across the data ranks (the
ranks holding the same model shard of the other workers): the
:class:`DataGroup` of :func:`data_parallel`, process-wide like the model
group and absent outside it.  Its ``split`` says what the data axes divide:
``"batch"``, each rank's rows of the batch (the MoE dispatch then counts
the choices of the earlier ranks' tokens, ``moe.py``), or ``"seq"``, each
rank's rows of the KV caches (the decode's softmax then combines across the
ranks, ``layers.py``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core import transport

__all__ = ["ModelGroup", "model_parallel", "current", "DataGroup", "data_parallel",
           "current_data", "copy_to_model", "reduce_from_model", "gather_from_model",
           "vocab_parallel_ce"]


class ModelGroup(NamedTuple):
    """The ranks holding one replica's shards: the process ``group``, its
    ``size`` (the model axis) and this rank's ``index`` in it."""

    group: object
    size: int
    index: int


# Process-wide, not thread-local: autograd runs a CUDA backward, and with it
# the recomputation of a checkpointed block, on its own device thread, which
# must see the same group as the forward.
_ACTIVE: Optional[ModelGroup] = None


def current() -> Optional[ModelGroup]:
    """The active model group, or None (no model axis)."""
    return _ACTIVE


@contextlib.contextmanager
def model_parallel(mp: Optional[ModelGroup]):
    """Run the model code, its backward included, tensor-parallel over
    ``mp`` (None: as one device)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mp
    try:
        yield
    finally:
        _ACTIVE = prev


class DataGroup(NamedTuple):
    """The serving data ranks: the process ``group``, its ``size`` (the
    flattened data axes), this rank's ``index`` in it, and what they split
    (``"batch"`` or ``"seq"``)."""

    group: object
    size: int
    index: int
    split: str


_DATA: Optional[DataGroup] = None


def current_data() -> Optional[DataGroup]:
    """The active serving data group, or None."""
    return _DATA


@contextlib.contextmanager
def data_parallel(dg: Optional[DataGroup]):
    """Serve with the batch or the caches' sequence split over ``dg``
    (None: every rank holds the whole batch and caches)."""
    global _DATA
    prev, _DATA = _DATA, dg
    try:
        yield
    finally:
        _DATA = prev


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        transport.all_reduce(g, group=ctx.group, tag=ctx.tag)
        return g, None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        out = x.contiguous().clone()
        transport.all_reduce(out, group=group, tag=tag)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` (the shards in group-rank order) forward;
    the rank's slice of the gradient backward: the gathered value feeds
    replicated code, so its gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, mp, dim, tag):
        ctx.mp, ctx.dim, ctx.width = mp, dim, x.shape[dim]
        parts = transport.all_gather_bytes(x, mp.size, mp.group, tag=tag)   # (M, ...)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        w, i = ctx.width, ctx.mp.index
        return g.narrow(ctx.dim, i * w, w).contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, tag=None) -> torch.Tensor:
    mp = current()
    return x if mp is None else _CopyToModel.apply(x, mp.group, tag)


def reduce_from_model(x: torch.Tensor, tag=None) -> torch.Tensor:
    mp = current()
    return x if mp is None else _ReduceFromModel.apply(x, mp.group, tag)


def gather_from_model(x: torch.Tensor, dim: int = -1, tag=None) -> torch.Tensor:
    """The model group's shards of ``x`` along ``dim``, concatenated in
    group-rank order (``all_gather(x, "model", axis=dim, tiled=True)``).
    The backward keeps the rank's slice and adds nothing up: the code after
    the gather is replicated, its gradient whole on every rank."""
    mp = current()
    return x if mp is None else _GatherFromModel.apply(x, mp, dim % x.dim(), tag)


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``sum(logsumexp(logits) - logits[label])`` (f32) of ``logits`` whose
    last dimension is this rank's vocabulary shard, against ``labels``
    (global ids).  The max is all-reduced as a constant (``logsumexp``'s
    stop-gradient shift); the sum of exponentials and the target logit
    (zero on every shard but its owner's) are summed across the model group
    by :func:`reduce_from_model`, so the gradient is ``softmax - onehot`` on
    the shard's columns."""
    mp = current()
    vl = logits.shape[-1]
    gmax = logits.detach().amax(dim=-1)
    transport.all_reduce(gmax, op=dist.ReduceOp.MAX, group=mp.group)
    sumexp = reduce_from_model(torch.exp(logits - gmax[..., None]).sum(dim=-1))
    local = labels.long() - mp.index * vl
    inside = (local >= 0) & (local < vl)
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    picked = reduce_from_model(torch.where(inside, picked, torch.zeros_like(picked)))
    return torch.sum(gmax + torch.log(sumexp) - picked)
