"""Serving: batched prefill and the cached single-token decode (the port of
``repro/launch/serve.py``), with no compression.

``decode_32k`` decodes one token per sequence for 128 sequences against
caches of 32,768 positions; ``long_500k`` serves one sequence of 524,288
positions, an attention model through its sliding window (a ring-buffer
cache of ``cfg.sliding_window`` rows), an SSM or hybrid model through its
recurrent state.  The step updates the caches in place, the counterpart of
the JAX step's donated caches: a functional update would hold the cache
twice and copy it every token.  The position stays on the device, so the
decode loop never waits for the host.

Over a mesh (``--mesh NxM``, one rank per device under ``torchrun``, as the
trainer's ranks) the builders run the JAX serve step's GSPMD placement
(``serve_cache_shardings``, ``cache_specs``) by hand:

* the parameters are the rank's shards (``param_specs``: attention and MLP
  tensor-parallel over the model group, the LM head's vocabulary columns,
  whose logits are gathered whole, the MoE experts by expert or by
  ``d_ff``);
* the batch splits over the data axes when they divide it (each rank its
  rows, its caches' rows; the MoE keeps the global batch's choices,
  ``models/moe.py``), else the KV caches' sequence does (long_500k's batch
  of one: each rank its rows of the cache, the softmax combined across the
  data ranks, ``models/layers.py``), else neither;
* the KV heads split over the model axis as the column-parallel ``wk`` /
  ``wv`` give them;
* the Mamba-2 mixers run replicated on the model group (``mamba2.py``):
  their split leaves are gathered once, when the step is built, and their
  ``conv`` / ``ssm`` caches are whole on each model rank, split over the
  data ranks by batch (:func:`~repro_torch.launch.sharding_rules.held_cache_specs`;
  the JAX placement splits them over ``model``).

What a model axis does not divide as the JAX nested paths do is refused
(:func:`check_serve_mesh`).  With no mesh, or ``1x1``, the builders serve
on one device exactly as before.

Usage::

    python -m repro_torch.launch.serve --arch llama3.2-1b --shape long_500k --tokens 16
    python -m repro_torch.launch.serve --arch llama3.2-1b --reduced --device cpu --tokens 4
    OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch llama3.2-1b --reduced --device cpu --mesh 2x2 --tokens 4
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (ShapeConfig, get_config, get_shape, list_archs, reduced,
                                 shape_applicable)
from repro_torch.core import prng
from repro_torch.launch.mesh import MeshSpec, mesh_groups, parse_mesh
from repro_torch.launch.sharding_rules import (cache_specs, held_cache_specs, local_shape,
                                               param_specs, shard_tree)
from repro_torch.launch.train import check_model_split, init_distributed, resolve_device
from repro_torch.models.mamba2 import SPLIT
from repro_torch.models.sharding import (DataGroup, ModelGroup, data_parallel,
                                         gather_from_model, model_parallel)
from repro_torch.models.transformer import decode_step, forward, head_logits, init_caches, init_model

__all__ = ["decode_window", "serve_cache_shardings", "check_serve_mesh", "ServeLayout",
           "serve_layout", "init_serve_caches", "build_serve_step", "build_prefill", "main"]


def decode_window(cfg, shape) -> Optional[int]:
    """long_500k engages the sliding window on attention archs (hybrids keep
    full attention: their Mamba layers carry the long context)."""
    if shape.name == "long_500k" and not cfg.has_mamba():
        return cfg.sliding_window
    return None


def serve_cache_shardings(cfg, mesh: MeshSpec, shape):
    """``(specs, caches, window)``: the JAX placement of the decode caches
    on ``mesh`` (:func:`~repro_torch.launch.sharding_rules.cache_specs`,
    a :class:`~repro_torch.launch.sharding_rules.CacheSpec` per leaf), the
    global caches as ``meta`` tensors (shapes and dtypes), and the window
    (``repro/launch/serve.py:42``)."""
    window = decode_window(cfg, shape)
    caches = init_caches(cfg, shape.global_batch, shape.seq_len, window=window, device="meta")
    return cache_specs(caches, cfg, mesh, batch=shape.global_batch), caches, window


def check_serve_mesh(cfg, mesh: MeshSpec) -> None:
    """Refuse what serving over ``mesh`` does not hold to the JAX serve
    step, naming ROADMAP.md queue 1 item 12(g): query or KV heads the model
    axis does not divide (the JAX rules then split ``Dh``), a tied
    embedding, an MoE split the axis does not divide, and every other
    matrix it leaves whole (the trainer's model checks,
    :func:`~repro_torch.launch.train.check_model_split`)."""
    check_model_split(cfg, mesh)


@dataclass(frozen=True)
class ServeLayout:
    """One rank's place in serving over a mesh: its coordinates, its model
    group (None without a model axis) and its data group (None when every
    data rank holds the whole batch and caches)."""

    mesh: MeshSpec
    worker: int = 0
    shard: int = 0
    model: Optional[ModelGroup] = None
    data: Optional[DataGroup] = None

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor (B, ...)."""
        if self.data is None or self.data.split != "batch":
            return x
        return x.chunk(self.data.size, dim=0)[self.data.index]

    @contextlib.contextmanager
    def context(self):
        """The model code under this rank's groups."""
        with model_parallel(self.model), data_parallel(self.data):
            yield


def serve_layout(cfg, shape, mesh: Optional[MeshSpec] = None) -> ServeLayout:
    """This rank's :class:`ServeLayout` for ``shape`` (a decode or prefill
    shape) on ``mesh``: refused by :func:`check_serve_mesh`, collective
    over the default group (it builds the mesh's groups) when the mesh has
    more than one rank."""
    if mesh is None or mesh.world == 1:
        return ServeLayout(mesh or parse_mesh(None))
    check_serve_mesh(cfg, mesh)
    groups = mesh_groups(mesh)
    n = mesh.n_workers
    split = None
    if n > 1 and shape.global_batch % n == 0:
        split = "batch"
    elif n > 1 and shape.kind == "decode":
        specs = serve_cache_shardings(cfg, mesh, shape)[0]
        if any(getattr(c, "k", None) is not None and c.k.data is not None for c in specs):
            split = "seq"
    return ServeLayout(mesh, groups.worker, groups.shard,
                       groups.model if mesh.model > 1 else None,
                       DataGroup(groups.data, n, groups.worker, split) if split else None)


def init_serve_caches(cfg, shape, mesh: Optional[MeshSpec] = None, device=None) -> tuple:
    """This rank's decode caches for ``shape``: the global caches with no
    mesh (or ``1x1``); on a mesh, zeros at the shapes
    :func:`~repro_torch.launch.sharding_rules.held_cache_specs` gives the
    rank."""
    if mesh is None or mesh.world == 1:
        return init_caches(cfg, shape.global_batch, shape.seq_len,
                           window=decode_window(cfg, shape), device=device)
    specs, meta, _ = serve_cache_shardings(cfg, mesh, shape)
    return tuple(type(c)(*(torch.zeros(local_shape(t.shape, s, mesh), dtype=t.dtype,
                                       device=device) for t, s in zip(c, cs)))
                 for c, cs in zip(meta, held_cache_specs(specs)))


def _whole_mixers(cfg, lay: ServeLayout, params) -> dict:
    """``{path: (shard, whole)}`` of the Mamba-2 mixers' split leaves of
    ``params`` (the rank's shards), gathered once over the model group
    (tagged ``"mamba"``); empty without a model group or params."""
    if lay.model is None or params is None or not cfg.has_mamba():
        return {}
    names = tuple(f"mixer/{k}" for k in SPLIT)
    split = [p for p in params if p.startswith("blocks/") and p.endswith(names)]
    specs = param_specs({p: params[p].shape for p in split}, cfg, lay.mesh.model)
    held = {}
    with torch.inference_mode(), model_parallel(lay.model):
        for p in split:
            held[p] = (params[p], gather_from_model(params[p].detach(), specs[p], tag="mamba"))
    return held


def _with_whole(params, held: dict):
    """``params`` with each held shard that it still holds replaced by its
    gathered whole leaf."""
    if not held:
        return params
    return {**params, **{p: w for p, (src, w) in held.items() if params.get(p) is src}}


def build_serve_step(cfg, shape, mesh: Optional[MeshSpec] = None, params=None):
    """``step(params, caches, tokens (B, 1)) -> (logits (B, 1, V_pad) f32,
    caches)``, the caches (:func:`init_serve_caches`) updated in place.

    On a mesh, ``params`` are the rank's shards, ``tokens`` its rows
    (:meth:`ServeLayout.rows`) and the logits its rows over the whole
    vocabulary; the builder is collective over the default group.  Given
    the shards here as well, the builder gathers the Mamba-2 mixers' split
    leaves once, and a step handed the same shards makes no ``mamba``
    collective."""
    window = decode_window(cfg, shape)
    lay = serve_layout(cfg, shape, mesh)
    held = _whole_mixers(cfg, lay, params)

    def step(params, caches, tokens):
        with torch.inference_mode(), lay.context():
            return decode_step(_with_whole(params, held), tokens, caches, cfg, window)

    return step


def build_prefill(cfg, shape, mesh: Optional[MeshSpec] = None, params=None):
    """``prefill(params, batch) -> next-token logits (B, 1, V_pad) f32``:
    the forward over the whole prompt, the head applied to the last
    position alone (the (B, S, V) logits are never formed).  On a mesh as
    :func:`build_serve_step`: the rank's shards, its rows of the batch
    (:meth:`ServeLayout.rows` of each tensor), its rows of the logits."""
    lay = serve_layout(cfg, shape, mesh)
    held = _whole_mixers(cfg, lay, params)

    def prefill(params, batch):
        params = _with_whole(params, held)
        with torch.inference_mode(), lay.context():
            x, _ = forward(params, batch, cfg, last_token_only=True)
            return head_logits(params, x, cfg)

    return prefill


def main(argv=None):
    ap = argparse.ArgumentParser(description="serving demo (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--tokens", type=int, default=16, help="tokens to decode")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="sequences (with --reduced)")
    ap.add_argument("--cache-len", type=int, default=256, help="cache length (with --reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card) or cpu (the plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="NxM (data, model), PxNxM (pod, data, model) or M: one rank per "
                         "device under torchrun (gloo with --device cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        shape = ShapeConfig("reduced-decode", args.cache_len, args.batch, "decode")
    else:
        shape = get_shape(args.shape)
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            ap.error(why)
    mesh = parse_mesh(args.mesh)
    distributed = mesh.world > 1
    if distributed:
        check_serve_mesh(cfg, mesh)
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--mesh {mesh} serves one rank per device: torchrun "
                             f"--nproc-per-node {mesh.world}")
        dev = init_distributed(args.device, mesh)
    else:
        dev = resolve_device(args.device)
    try:
        lay = serve_layout(cfg, shape, mesh)
        params = init_model(cfg, dev, seed=0)
        if distributed:
            params = shard_tree({p: x.detach() for p, x in params.items()},
                                param_specs(params, cfg, mesh.model), mesh.model, lay.shard)
        caches = init_serve_caches(cfg, shape, mesh, device=dev)
        step_fn = (build_serve_step(cfg, shape, mesh, params=params) if distributed
                   else build_serve_step(cfg, shape))
        tokens = lay.rows(prng.randint(prng.PRNGKey(0), (shape.global_batch, 1), 0,
                                       cfg.vocab)).to(dev)
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            logits, caches = step_fn(params, caches, tokens)
            tokens = torch.argmax(logits[:, -1:], dim=-1) % cfg.vocab
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if not distributed or dist.get_rank() == 0:
            print(f"decoded {args.tokens} tokens x {shape.global_batch} seqs in {dt:.2f}s "
                  f"({args.tokens * shape.global_batch / dt:.1f} tok/s)"
                  + (f" on --mesh {mesh}" if distributed else ""))
    finally:
        if distributed and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
