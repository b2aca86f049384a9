"""The DIANA trainer (CLI + step builders).

``--mesh`` reads the JAX CLI's flag (:mod:`repro_torch.launch.mesh`):
``NxM`` is N data-parallel DIANA workers times M model shards each.  Two
step builders share the step:

* :func:`build_train_step` — one process runs the N workers in turn on one
  device, writing their payloads straight into the rows of one stacked
  buffer (the all-gather's output shape); the one-process mirror of the
  distributed round, and the CLI's mode without ``WORLD_SIZE``;
* :func:`build_distributed_step` — one worker per ``torch.distributed``
  rank, as the JAX trainer's shard_map body (``repro/launch/train.py:404-495``)
  runs ``aggregate_shardmap``: the CLI's mode under ``torchrun``
  (``WORLD_SIZE`` set), N must equal the world size, NCCL on
  ``cuda:LOCAL_RANK`` (gloo with ``--device cpu``).

On a model mesh (M > 1, the dense and MoE transformers and the frontend
models, one rank per shard: N·M ranks) each rank holds its shards of the
parameters (:mod:`~repro_torch.launch.sharding_rules`), runs the model
tensor-parallel over its worker's model group
(:mod:`repro_torch.models.sharding`; the MoE layers as the JAX package's
nested fully-manual path), and runs the per-leaf round on its gradient
shards with shard-local memories over its data group
(``aggregate_distributed(group=)``, the JAX package's nested fully-manual
mode).  A bucketed config runs per leaf there
(:func:`resolve_bucketed`, one ``RuntimeWarning``), and what this slice
does not hold to the JAX trainer on such a mesh is refused
(:func:`check_model_axis`).

Each step:

1. the step key is ``fold_in(PRNGKey(0), step)``;
2. worker ``w`` takes rows ``[w*b/n, (w+1)*b/n)`` of the batch (the JAX
   trainer's ``P(workers)`` batch sharding), computes its loss and gradient,
   and flattens the gradient into the f32 bucket;
3. it encodes its input (``delta = g - h_worker[w]`` for the alpha-memory
   rule, ``g + h_worker[w]`` for top-k's error feedback) with keys
   ``split(fold_in(step_key, w), n_leaves)`` (``quantize_pack_prng`` for
   the ternary family and ``nat_pack_prng`` for ``natural``, which draw the
   bits in the kernel; a per-segment selection and ``sparse_gather`` for
   ``randk`` / ``topk_ef``; ``dense_copy`` for ``none`` in turn), decodes
   its own payload and updates ``h_worker[w]`` with the operator's rule
   (``next_memory``; the memoryless operators skip both);
4. the n payloads meet (rows of the stacked buffer in turn; ONE all-gather
   of the fused payload across ranks, or for ``none`` ONE all-reduce and no
   kernel), and ONE fused decode over them (``unpack_reduce_apply`` /
   ``nat_decode_sum_apply``; ``randk``'s ``sparse_decode_sum`` and its
   per-segment server rule; ``topk_ef``'s ``sparse_decode_sum_mean``;
   ``none``'s ``dense_decode_sum_mean`` in turn) updates ``h_server`` and
   gives ``ghat``, rounded to the leaf dtypes;
5. momentum and the parameter write-back.

``--vr`` (VR-DIANA) adds a second forward and backward per worker, at the
worker's snapshot on the same batch: the worker encodes the control variate
``g - g_snap + mu_w`` instead of ``g``, and its coin (forced at step 0)
refreshes its snapshot to the parameters and ``mu_w`` to ``g``
(``repro/launch/train.py:413-428``).  ``--down-method`` compresses the f32
``ghat`` once more on the server's side (its own memory ``h_down``, the key
``fold_in(step_key, DOWN_FOLD)``) before step 5: one more encode and one
decode per step.

``--per-leaf-agg`` runs steps 2-4 leaf by leaf (each worker encodes every
leaf with its own key ``split(fold_in(step_key, w), n_leaves)[i]``; one
decode per leaf).  ``--comp-policy`` runs them once per policy group, each
in its group's layout with the key ``fold_in(fold_in(step_key, w),
GROUP_FOLD + g)``: llama3.2-1b's curated policy (``default``) keeps the norm
scales exact (``dense_copy`` / ``dense_decode_sum_mean`` in turn, one
all-reduce across ranks), top-k's the embedding and the LM head and
ternary-quantizes the rest.

``--participation-q`` / ``--participation-dropout`` / ``--min-workers``
make the rounds elastic (``repro_torch.core.participation``): the step's
mask is drawn from ``fold_in(step_key, PART_FOLD)`` with the optimizer's
step counter, the non-participants' rows of the stacked payload are zeroed
before the server's sum (identity then sums with ``dense_decode_sum``, and
gathers across ranks instead of all-reducing), only the participants'
memory rows advance, and a step with fewer than ``--min-workers``
participants applies ``ghat = 0``.  ``--faults`` (the bucketed layout)
puts each worker's fused payload on a wire with an 8-byte checksum,
injects the plan's faults and excludes the payloads that fail.

``--chunk-bytes`` splits each bucketed wire into whole-leaf chunks (one
stacked payload per chunk in turn; across ranks chunk c+1's all-gather is
issued before chunk c's decode); ``--topology hierarchical --node-size K``
averages each node's K gradients before one encode per node, keyed
``fold_in(step_key, node)``.  ``--budget-bits-per-dim`` (with
``--controller-interval`` and ``--warmup-dense-steps``) runs the bit-budget
controller between steps (:func:`controller_tick`): the steps report each
policy group's telemetry, and a switch migrates the memories and rebuilds
the step.  ``--checkpoint-dir`` saves ``{"params": params}`` at step
``--steps`` when the run ends (rank 0 under ``torchrun``), the policy's JSON
(and the controller's state) in the manifest's metadata, as the JAX trainer
does; like it, the CLI has no resume flag (``repro_torch.checkpoint``'s
``restore_checkpoint`` takes any template).

The logged loss is the mean over the workers (all-reduced across ranks).
Entry points run on ``cuda`` and raise without a GPU unless the caller asks
for the CPU (``--device cpu``), where the kernels' plain versions run.

    python -m repro_torch.launch.train --arch llama3.2-1b --compression natural \\
        --mesh 4x1 --steps 3 --batch 8 --seq 4096
    python -m repro_torch.launch.train --arch llama3.2-1b --comp-policy default \\
        --mesh 4x1 --steps 3 --batch 8 --seq 4096
    python -m repro_torch.launch.train --arch llama3.2-1b --mesh 4x1 --steps 3 \\
        --batch 8 --seq 4096 --participation-q 0.6 --participation-dropout 0.1 \\
        --min-workers 3 --faults corrupt:step=1,worker=0
    torchrun --nproc-per-node 1 -m repro_torch.launch.train --arch llama3.2-1b \\
        --mesh 1x1 --steps 3 --batch 2 --seq 4096
    OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3.2-1b --reduced --device cpu --mesh 4x1 --steps 2 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import os
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ShapeConfig, get_config, get_shape, list_archs, reduced
from repro_torch.core import prng, transport
from repro_torch.core import tree as T
from repro_torch.core.bucket import (ChunkedSchedule, bucketed_compressor, unfuse_payload,
                                     verify_checksum)
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import available_methods
from repro_torch.core.compressors.base import Payload
from repro_torch.core.controller import (BudgetController, controller_metadata,
                                         init_controller_state, maybe_reallocate,
                                         migrate_diana_state, observe)
from repro_torch.core.diana import (DOWN_FOLD, GROUP_FOLD, PART_FOLD, _check_topology,
                                    _chunk_decode_own, _chunk_payloads, _chunk_wire_meta,
                                    _frozen_downlink, _group_downlink,
                                    _hier_node_size, _masked_server_tail, _node_scale,
                                    _resolve_participation, _server_chunks, _split_spec, _taker,
                                    _wire_exchange, aggregate_distributed, bucket_layout,
                                    check_faults, step_part, worker_key)
from repro_torch.core.participation import ParticipationSpec, parse_faults
from repro_torch.core.policy import (ChannelSpec, CompressionPolicy, load_policy, partition_for,
                                     policy_bits_per_dim)
from repro_torch.core.telemetry import GroupTelemetry, from_moments, group_moments
from repro_torch.core.vr import control_variate, reference_coins, resolve_vr_p
from repro_torch.core.numerics import div_n
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch.mesh import MeshSpec, mesh_groups, parse_mesh
from repro_torch.launch.sharding_rules import gather_tree, param_specs, shard_tree, undivided
from repro_torch.models.sharding import model_parallel
from repro_torch.models.transformer import init_model, meta_params, train_loss
from repro_torch.optim.diana_optimizer import DianaOptimizer
from repro_torch.optim.optimizers import adamw, constant_schedule, momentum, sgd

__all__ = ["resolve_device", "resolve_policy_arg", "make_optimizer", "init_train_state",
           "build_train_step", "build_distributed_step", "init_distributed", "parse_mesh",
           "resolve_bucketed", "resolved_layout", "check_model_split", "check_model_axis",
           "controller_tick", "main"]


def resolve_device(device: Optional[str] = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on the card "
                           "(pass device='cpu' / --device cpu for the plain versions)")
    return dev


def resolve_bucketed(opt: DianaOptimizer, mesh: MeshSpec) -> DianaOptimizer:
    """Downgrade a bucketed layout to per leaf on a live model axis
    (``repro/launch/train.py:61``): every group, both directions
    (``CompressionPolicy.force_perleaf``), with one structured
    ``RuntimeWarning``.  The port's own reason: the JAX package's bucketed
    round over a live model axis does not lower on its toolchain (jax 0.9.0
    aborts in XLA's SPMD partitioner), so there is nothing to hold a port of
    it to.  Worker meshes (M = 1) keep the layout."""
    if mesh.model == 1 or not opt.policy.any_bucketed():
        return opt
    warnings.warn(
        "resolve_bucketed: downgrading the aggregation layout [reason=no-bucketed-reference "
        "inner_axes=('model',) resulting_layout=per-leaf topology=flat]: the JAX package's "
        "bucketed round over a live model axis does not lower on jax 0.9.0 (XLA's SPMD "
        "partitioner aborts), so the port runs the shard-local per-leaf round there.  "
        "Results are the per-leaf round's; step time and collective count differ.",
        RuntimeWarning, stacklevel=2)
    return _with_policy(opt, opt.policy.force_perleaf())


def resolved_layout(opt: DianaOptimizer, mesh: MeshSpec) -> str:
    """The layout :func:`resolve_bucketed` runs on ``mesh``: ``"bucketed"``,
    ``"per-leaf"``, or ``"per-leaf (downgraded)"`` when the config asked for
    bucketed (``repro/launch/train.py:102``)."""
    if not opt.policy.any_bucketed():
        return "per-leaf"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        resolved = resolve_bucketed(opt, mesh)
    return "bucketed" if resolved.policy.any_bucketed() else "per-leaf (downgraded)"


def check_model_split(cfg, mesh: MeshSpec) -> None:
    """Refuse a model that a model axis (M > 1) does not divide as the JAX
    nested paths divide it, naming ROADMAP.md queue 1 item 12(g): an MoE
    split the JAX nested path does not take, a tied embedding, heads or
    matrices (a Mamba-2 mixer's packed projections and conv taps among
    them) the model axis does not divide.  The trainer
    (:func:`check_model_axis`) and serving
    (``repro_torch.launch.serve.check_serve_mesh``) share it."""
    if mesh.model == 1:
        return
    m, item = mesh.model, "ROADMAP.md queue 1 item 12"
    if any(spec.mlp == "moe" for spec in cfg.pattern):
        mc = cfg.moe
        size = mc.n_experts if mc.partition == "expert" else mc.d_ff
        if mc.partition not in ("expert", "ffn") or size % m:
            # the JAX nested path's condition (repro/models/moe.py:160-169)
            raise NotImplementedError(
                f"{cfg.name}: MoE partition {mc.partition!r} of {size} over a model axis of "
                f"{m} (the JAX package's pure GSPMD fallback; {item}(g))")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: a tied embedding over the model axis ({item}(g))")
    whole = undivided(meta_params(cfg), cfg, m)
    heads = cfg.has_attention() and (cfg.n_heads % m or cfg.n_kv_heads % m)
    if heads or whole:
        raise NotImplementedError(
            f"--mesh {mesh}: the model axis must divide the query and KV heads ({cfg.n_heads}, "
            f"{cfg.n_kv_heads}) and every matrix ({whole} stay whole) ({item}(g))")


def check_model_axis(cfg, opt: DianaOptimizer, mesh: MeshSpec, faults=None,
                     telemetry: bool = False) -> None:
    """Refuse, on a model mesh (M > 1), what this slice does not hold to the
    JAX trainer on a (2, 2) mesh, naming its ROADMAP.md item: an MoE split
    the JAX nested path does not take, a tied embedding, heads or matrices
    (a Mamba-2 mixer's packed projections and conv taps among them) the
    model axis does not divide,
    ``remat="dots"``, and VR, the downlink, a grouped policy, participation
    and faults, the chunked and two-level schedules and the controller.
    The leaves the JAX rules replicate by design (the router, the norm
    scales, the biases) stay whole on every rank
    (:func:`~repro_torch.launch.sharding_rules.undivided` leaves them out)."""
    if mesh.model == 1:
        return
    item = "ROADMAP.md queue 1 item 12"
    check_model_split(cfg, mesh)
    if cfg.remat == "dots":
        raise NotImplementedError(f"remat='dots' over the model axis ({item}(g))")
    pol = opt.policy
    down = pol.is_uniform and pol.flat_config().down_method is not None
    refused = {"VR-DIANA": pol.vr, "the compressed downlink": down,
               "a grouped policy": not pol.is_uniform,
               "participation and faults": pol.participation is not None or faults is not None,
               "the chunked wire": bool(pol.chunk_bytes),
               "the two-level topology": pol.topology == "hierarchical",
               "the bit-budget controller": telemetry}
    for what, on in refused.items():
        if on:
            raise NotImplementedError(f"{what} on a model mesh ({item}(e))")


def resolve_policy_arg(cfg, policy) -> CompressionPolicy:
    """The ``--comp-policy`` surface as a policy (``repro/launch/train.py
    :116``): a :class:`CompressionPolicy`, a ``.json`` path, inline rules
    (:func:`~repro_torch.core.policy.parse_rules`), ``"default"`` (the
    model's curated ``ModelConfig.comp_policy``) or ``"size-adaptive"``
    (small leaves dense, the rest by the model's flat ``compression``).  The
    model config gives the model-wide fields (layout, h dtype, VR) unless a
    JSON document sets them."""
    if policy == "default":
        if cfg.comp_policy is None:
            raise ValueError(f"--comp-policy default: {cfg.name} defines no default policy "
                             "(ModelConfig.comp_policy is None)")
        policy = cfg.comp_policy
    model_wide = dict(bucketed=cfg.comp_bucketed, h_dtype=cfg.h_dtype, vr=cfg.vr,
                      vr_p=cfg.vr_p)
    if policy == "size-adaptive":
        large = ChannelSpec(method=cfg.compression, k=cfg.comp_k, block_size=cfg.comp_block,
                            p=cfg.comp_p)
        return CompressionPolicy.size_adaptive(meta_params(cfg), large=large, **model_wide)
    return load_policy(policy, **model_wide)


def make_optimizer(cfg, *, lr: float = 3e-4, inner: str = "momentum", beta: float = 0.9,
                   compression: Optional[CompressionConfig] = None,
                   policy=None, participation=None) -> DianaOptimizer:
    """The training optimizer: the policy ``policy`` names
    (:func:`resolve_policy_arg`), else the model config's flat ``comp_*``
    fields; ``participation`` (a
    :class:`~repro_torch.core.participation.ParticipationSpec`) rides
    either whole.  ``inner`` is ``momentum`` (heavy-ball, ``beta``),
    ``adamw`` (the JAX package's defaults) or ``sgd``."""
    inners = {"momentum": lambda: momentum(beta), "adamw": adamw, "sgd": sgd}
    if inner not in inners:
        raise ValueError(f"unknown inner optimizer {inner!r}; available: {sorted(inners)}")
    inner_opt = inners[inner]()
    if policy is not None:
        if compression is not None:
            raise ValueError("pass either compression= or policy=, not both")
        return DianaOptimizer(inner=inner_opt, schedule=constant_schedule(lr),
                              policy=resolve_policy_arg(cfg, policy),
                              participation=participation)
    comp = compression or CompressionConfig(
        method=cfg.compression, p=cfg.comp_p, block_size=cfg.comp_block, k=cfg.comp_k,
        h_dtype=cfg.h_dtype, bucketed=cfg.comp_bucketed, vr=cfg.vr, vr_p=cfg.vr_p,
        down_method=cfg.comp_down_method, down_k=cfg.comp_down_k)
    return DianaOptimizer(comp, inner_opt, schedule=constant_schedule(lr),
                          participation=participation)


def init_train_state(cfg, opt: DianaOptimizer, n_workers: int, device, seed: int = 0,
                     model: int = 1, shard: int = 0):
    """Random parameters (``torch.Generator(seed)``) and the zero optimizer
    state; with a model axis (``model`` > 1) the parameters' shard ``shard``
    (:func:`~repro_torch.launch.sharding_rules.param_specs`) and its
    shard-local memories."""
    params = init_model(cfg, device, seed=seed)
    if model > 1:
        params = {p: torch.nn.Parameter(x.detach()) for p, x in shard_tree(
            params, param_specs(params, cfg, model), model, shard).items()}
    return params, opt.init(params, n_workers)


def _worker_batch(batch, w: int, n_workers: int):
    """Worker ``w``'s rows ``[w*b/n, (w+1)*b/n)`` of the global batch."""
    b = batch["tokens"].shape[0]
    if b % n_workers:
        raise ValueError(f"global batch {b} does not split over {n_workers} workers")
    rows = b // n_workers
    return {k: v[w * rows:(w + 1) * rows] for k, v in batch.items()}


def _finish(opt: DianaOptimizer, params, opt_state, ghat, loss, gnorm=None):
    """Step 5 and the metrics: momentum and the write-back (the DIANA state
    is already updated in place)."""
    if gnorm is None:
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in ghat.values()))
    new_opt = opt.apply_direction(params, ghat, opt_state, opt_state.diana)
    return params, new_opt, {"loss": loss, "ghat_norm": gnorm, "step": new_opt.step}


def _snapshot_grads(cfg, snapshot, w: int, batch):
    """VR's second backward: the gradient at worker ``w``'s snapshot on the
    worker's batch (``train_loss`` is functional in its parameters)."""
    snap = {p: s[w].detach().requires_grad_() for p, s in snapshot.items()}
    grads = torch.autograd.grad(train_loss(snap, batch, cfg), list(snap.values()))
    return dict(zip(snap, grads))


def _copy_into(held, fresh):
    """Write a fresh state (tensor, dict, list or NamedTuple of them) into
    the held buffers, so that each memory stays one buffer."""
    if held is None or fresh is held:
        return
    if isinstance(held, torch.Tensor):
        held.copy_(fresh)
    elif isinstance(held, dict):
        for p in held:
            _copy_into(held[p], fresh[p])
    else:
        for h, f in zip(held, fresh):
            _copy_into(h, f)


class _Elastic:
    """A round's participation in turn: the step's context ``part`` (None:
    the all-workers round), the fault plan and step, and the wire verdicts
    as the workers encode (``valid``, one bool per worker)."""

    def __init__(self, part, faults=None, step=None):
        self.part, self.faults, self.step = part, faults, step
        self.valid = []

    def reset(self, w, rows):
        """A rejoining worker's memory rows are zeroed before its encode, and
        stay so whatever the step (``_reinit_zero``)."""
        if self.part is not None and bool(self.part.reinit[w]):
            for h in rows:
                h.zero_()

    def advances(self, w) -> bool:
        """Whether worker ``w``'s memory rows advance: it participates, the
        step is not degraded and (faults armed) its wire verified."""
        if self.part is None:
            return True
        return (bool(self.part.mask[w]) and self.part.ok
                and (self.faults is None or self.valid[w]))

    def effective(self) -> torch.Tensor:
        """The (n,) mask the server sums: scheduled AND verified."""
        if self.faults is None:
            return self.part.mask
        return self.part.mask & torch.tensor(self.valid, dtype=torch.bool)

    def wire(self, pays, w):
        """Worker ``w``'s chunk payloads (rows of the stacked buffers; one,
        unchunked) across the checksummed wire: each fused, checksummed,
        this worker's faults injected through the chunk's window of the
        round's body, verified; returns the received bodies as payloads, to
        be written back into the rows after the worker's own decode.  The
        worker's verdict is the AND over its chunks."""
        offs, body_total = _chunk_wire_meta(pays)
        received, ok = [], True
        for c, pay in enumerate(pays):
            wire, shape, recipe = _wire_exchange(pay, self.faults, self.step, w, offs[c],
                                                 body_total if len(pays) > 1 else None)
            flat, ok_c = verify_checksum(wire)
            ok = ok and bool(ok_c)
            received.append(unfuse_payload(flat.reshape(shape)[None], recipe).select(0))
        self.valid.append(ok)
        return received


def _write_back(row, received):
    """The received bytes of a payload into its row of the stacked buffer."""
    for f, r in zip(row, received):
        if f is not None:
            f.copy_(r)


class _BucketedRound:
    """One bucketed group's round in turn: each worker's input flattened
    into one f32 buffer and encoded straight into its row of one stacked
    payload (the all-gather's output shape), its memory row updated in
    place; then ONE ``decode_sum_apply`` over the rows.  Elastic (``el``
    with a context): rejoining rows reset before the encode, only advancing
    rows updated, under faults each payload through the checksummed wire,
    and the server's sum over the effective rows (zeroed in place in the
    stacked buffer) then :func:`~repro_torch.core.diana._masked_server_tail`.

    Chunked (``cfg.chunk_bytes``): one stacked buffer per chunk, each worker
    encoding chunk by chunk into its rows, its memory updated once over the
    whole buffer; the server decodes chunk by chunk into slices of ``ghat``
    and of the held ``h_server``.  Hierarchical (``node_size`` s > 1): the
    node's workers pool into one f32 buffer in turn (worker 0's flat
    gradient, then ``+`` each next, then ``/ s``), and the node encodes once,
    at its last worker, with the node key into row ``node`` of an ``(n / s)``
    -row stack; its memory row is copied to the node's other rows."""

    def __init__(self, cfg, params, hw, hs, n_workers, device, el=None, defer=False):
        self.cfg, self.defer = cfg, defer
        self.layout = bucket_layout(cfg, params)
        self.comp = bucketed_compressor(cfg, self.layout)
        self.sched = ChunkedSchedule.for_layout(self.layout, cfg.chunk_bytes)
        self.hw, self.hs, self.n = hw, hs, n_workers
        self.s = _hier_node_size(cfg)
        self.el = el if el is not None else _Elastic(None)
        self.g_flat = torch.empty(self.layout.padded_size, dtype=torch.float32, device=device)
        # the node's pooled gradient: one more (Dp,) f32 buffer
        self.pool = self.g_flat if self.s == 1 else torch.empty_like(self.g_flat)
        self.rows = n_workers // self.s
        self.gathered = [bucketed_compressor(cfg, cl).gathered(self.rows, device)
                         for cl in self.sched.chunk_layouts]

    def load(self, grads, w=0):
        """Flatten a worker's input tree into the buffer (the caller may
        then free the tree before the encode); hierarchical, add it into the
        node's pool."""
        if self.s == 1 or w % self.s == 0:
            self.layout.flatten(grads, out=self.pool)
        else:
            self.pool.add_(self.layout.flatten(grads, out=self.g_flat))
            if w % self.s == self.s - 1:
                _node_scale(self.pool, self.s)

    def encode(self, w, key):
        """Worker ``w``'s encode (``key`` its worker key; hierarchical, the
        node key, and nothing before the node's last worker)."""
        if w % self.s != self.s - 1:
            return
        comp, hw, dp, el = self.comp, self.hw, self.layout.padded_size, self.el
        r, lead = w // self.s, w - self.s + 1     # the node, and its leader's row
        el.reset(w, [hw[w]])
        # The input (g - h, or g + h for error feedback), computed in place
        # in the gradient buffer.
        delta = comp.compress_input_(self.pool, hw[lead])
        rows = [g.select(r) for g in self.gathered]
        if self.sched.n_chunks > 1:
            pays = _chunk_payloads(self.cfg, self.sched, delta, key, outs=rows)
        else:
            pays = [comp.compress(delta, key, out=rows[0])]
        received = None if el.faults is None else el.wire(pays, w)
        if comp.carries_state and el.advances(w):
            # h_w <- h_w + alpha * dhat_w (or delta - dhat_w), into the state row.
            dhat = (_chunk_decode_own(self.cfg, self.sched, pays) if self.sched.n_chunks > 1
                    else comp.decode(pays[0], dp))
            hw[lead].copy_(comp.next_memory(hw[lead], dhat, delta))
            del dhat
            for i in range(lead + 1, w + 1):   # the node's other rows
                hw[i].copy_(hw[lead])
        if received is not None:
            for pay, rec in zip(pays, received):
                _write_back(pay, rec)

    def finish(self):
        """``(ghat, scale)``: ``ghat`` as f32 leaves, ``scale`` the masked
        tail's deferred one (or None); ``h_server`` updated in place.  The
        server rule reads the memory in f32 and writes it back in
        ``h_dtype``, as the JAX round does (a bf16 memory: an f32 copy in,
        each chunk's new slice rounded into the held buffer)."""
        self.g_flat = self.pool = None
        part, sched = self.el.part, self.sched
        take = _taker(self.gathered)
        if part is None:
            ghat_flat, _ = _server_chunks(self.cfg, sched, take, self.rows, self.hs.float(),
                                          hs_out=self.hs)
            self.gathered = None
            return self.layout.unflatten(ghat_flat, cast=False), None
        m_eff = self.el.effective()
        total = _server_chunks(self.cfg, sched, take, self.n, mask=m_eff)
        self.gathered = None   # freed before the tail allocates
        ghat_flat, new_hs, scale = _masked_server_tail(self.comp, self.hs.float(), total,
                                                       self.n, part, m_eff, inplace=True,
                                                       defer=self.defer)
        _copy_into(self.hs, new_hs)
        return self.layout.unflatten(ghat_flat, cast=False), scale


class _PerLeafRound:
    """One per-leaf group's round in turn (``_reference_agg_perleaf``):
    each worker encodes leaf by leaf, leaf ``i`` keyed ``split(key,
    n_leaves)[i]``, its memory rows updated in place; the payloads stack
    per leaf, and ONE ``decode_sum_apply`` per leaf (elastic: the masked
    sum and the masked tail, as the bucketed round)."""

    def __init__(self, cfg, params, hw, hs, n_workers, device, el=None, defer=False):
        self.comp, self.n, self.defer = cfg.make(), n_workers, defer
        self.paths = T.paths(params)
        self.shapes = {p: params[p].shape for p in self.paths}
        self.hw, self.hs = hw, hs    # {path: (n, d)}, {path: (d,)}
        self.el = el if el is not None else _Elastic(None)
        self.payloads = {p: [] for p in self.paths}
        self.pending = {}

    def load(self, grads, w=0):
        self.pending = dict(grads)

    def encode(self, w, key):
        comp, el = self.comp, self.el
        el.reset(w, [self.hw[p][w] for p in self.paths])
        advance = comp.carries_state and el.advances(w)
        for p, k in zip(self.paths, prng.split(key, len(self.paths))):
            h = self.hw[p][w]
            delta = comp.compress_input(self.pending.pop(p).reshape(-1).float(), h)
            pay = comp.compress(delta, k)
            if advance:
                h.copy_(comp.next_memory(h, comp.decode(pay, h.numel()), delta))
            del delta
            self.payloads[p].append(pay)

    def finish(self):
        """``(ghat, scale)``, as :meth:`_BucketedRound.finish`."""
        ghat, part, scale = {}, self.el.part, None
        for p in self.paths:
            stacked = Payload.stack(self.payloads.pop(p))
            d = self.hs[p].numel()
            if part is None:
                g, new_hs = self.comp.decode_sum_apply(stacked, self.n, d, self.hs[p].float())
            else:
                total = self.comp.decode_sum(stacked.mask_workers_(part.mask), self.n, d)
                g, new_hs, scale = _masked_server_tail(self.comp, self.hs[p].float(), total,
                                                       self.n, part, part.mask, inplace=True,
                                                       defer=self.defer)
            del stacked
            _copy_into(self.hs[p], new_hs)
            ghat[p] = g.reshape(self.shapes[p])
        return ghat, scale


def _group_rounds(opt: DianaOptimizer, params, diana, key, n_workers, device, el):
    """The step's rounds: ``(paths, round, worker-key fold, downlink)`` per
    group; ONE group for a flat config (its worker keys unfolded), one per
    policy group otherwise (``fold_in(worker_key, GROUP_FOLD + g)``).  The
    downlink is None or ``(cfg, dcfg, h_down, down_key)``.  ``el`` (the
    step's :class:`_Elastic`) is shared by every group."""
    policy, cfg = _split_spec(opt.policy)
    if policy is None:
        rnd = (_BucketedRound if cfg.bucketed else _PerLeafRound)(
            cfg, params, diana.h_worker, diana.h_server, n_workers, device, el,
            defer=diana.h_down is not None)
        down = (None if diana.h_down is None
                else (cfg, cfg.down_config(), diana.h_down, prng.fold_in(key, DOWN_FOLD)))
        return [(T.paths(params), rnd, None, down)]
    part = partition_for(policy, params)
    rounds = []
    for g, (gname, leaves, paths) in enumerate(zip(part.group_names, part.split(params),
                                                   part.group_paths)):
        cfg_g, dcfg = part.configs[g], part.down_configs[g]
        hw, hs = diana.h_worker[gname], diana.h_server[gname]
        if cfg_g.bucketed:
            rnd = _BucketedRound(cfg_g, leaves, hw, hs, n_workers, device, el,
                                 defer=dcfg is not None)
        else:
            rnd = _PerLeafRound(cfg_g, leaves, dict(zip(paths, hw)), dict(zip(paths, hs)),
                                n_workers, device, el, defer=dcfg is not None)
        down = None
        if dcfg is not None:
            down = (cfg_g, dcfg, diana.h_down[gname],
                    prng.fold_in(prng.fold_in(key, DOWN_FOLD), GROUP_FOLD + g))
        rounds.append((paths, rnd, GROUP_FOLD + g, down))
    return rounds


def _check_schedule(opt: DianaOptimizer, n_workers: int, faults) -> int:
    """The wire schedule's gates at build time; returns the node size (1:
    the flat topology)."""
    policy, flat = _split_spec(opt.policy)
    _check_topology(policy, flat, _resolve_participation(policy, flat), faults,
                    True if opt.policy.vr else None, n_workers)
    return 1 if flat is None else _hier_node_size(flat)


def _step_telemetry(moments, el, enabled):
    """The step's telemetry metrics (``repro/launch/train.py:490-494``)
    from each group's ``(m2, var)``, or nothing."""
    if not enabled:
        return {}
    t = from_moments(moments, None if el.part is None else el.part.ok)
    return {"telemetry_m2": t.m2, "telemetry_var": t.var, "telemetry_ok": t.ok}


def build_train_step(cfg, opt: DianaOptimizer, n_workers: int, device, faults=None,
                     telemetry: bool = False):
    """Returns ``step(params, opt_state, batch, key) -> (params, opt_state,
    metrics)`` running the ``n_workers`` workers in turn, in the policy's
    layout: the whole model bucketed or per leaf, or one round per policy
    group.  ``params`` (``{path: nn.Parameter}``) and the optimizer state
    are updated in place; ``batch`` holds int tensors on ``device``.

    Under the policy's ``participation`` the step draws its mask from
    ``fold_in(key, PART_FOLD)`` with the optimizer's step counter, once,
    before the workers run: the rounds of ``reference_step``, worker by
    worker.  ``faults`` (a
    :class:`~repro_torch.core.participation.FaultPlan`, the flat bucketed
    layout only) puts each worker's payload on the checksummed wire.  The
    metrics then carry ``mask``, ``ok`` and ``valid`` (the wire verdicts).

    The policy's ``chunk_bytes`` chunks each bucketed group's wire, and
    ``topology="hierarchical"`` pools each node's gradients before one
    encode per node, keyed ``fold_in(key, node)``.  ``telemetry=True`` adds
    ``telemetry_m2`` / ``telemetry_var`` (per group) and ``telemetry_ok`` to
    the metrics, measured on each group's f32 served direction."""
    device = torch.device(device)
    if faults is not None:
        check_faults(opt.policy)
    node_size = _check_schedule(opt, n_workers, faults)

    def step(params, opt_state, batch, key):
        paths = T.paths(params)
        diana = opt_state.diana
        vr = diana.vr
        leaves = [params[p] for p in paths]
        el = _Elastic(step_part(opt.policy, faults, prng.fold_in(key, PART_FOLD), n_workers,
                                opt_state.step), faults, opt_state.step)
        if vr is not None:
            # reference_coins: worker w's coin is vr_coin(fold_in(key, w));
            # elastic, the scheduled mask gates it, never the wire verdict
            coins = reference_coins(key, opt.policy.vr_p, n_workers) | (opt_state.step == 0)
            if el.part is not None:
                coins = coins & el.part.mask & el.part.ok
            coins = coins.tolist()
        # The random bits live only inside each encode, not across the next
        # worker's backward.
        rounds = _group_rounds(opt, params, diana, key, n_workers, device, el)
        losses = []
        for w in range(n_workers):
            wbatch = _worker_batch(batch, w, n_workers)
            loss = train_loss(params, wbatch, cfg)
            grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
            losses.append(loss.detach())
            g_snap = None if vr is None else _snapshot_grads(cfg, vr.snapshot, w, wbatch)
            with torch.no_grad():
                x = grads
                if vr is not None:
                    x = control_variate(grads, g_snap, {p: m[w] for p, m in vr.mu.items()})
                    del g_snap
                    if coins[w]:   # refresh: w_w <- x, mu_w <- the minibatch gradient
                        for p in paths:
                            vr.snapshot[p][w].copy_(params[p])
                            vr.mu[p][w].copy_(grads[p])
                for gpaths, rnd, _, _ in rounds:
                    rnd.load({p: x[p] for p in gpaths}, w)
                # this worker's gradient is freed before its encode
                del grads, x
                wkey = worker_key(key, w // node_size)   # hierarchical: the node key
                for _, rnd, gfold, _ in rounds:
                    rnd.encode(w, wkey if gfold is None else prng.fold_in(wkey, gfold))
        ghat, moments = {}, []
        with torch.no_grad():
            for _, rnd, _, down in rounds:
                ghat_g, scale = rnd.finish()
                if down is not None:
                    # the compressed broadcast of the f32 ghat, before the cast
                    # (nothing on a degraded step: h_down frozen, ghat zero)
                    gcfg, dcfg, h_down, down_key = down
                    ghat_g, new_h_down = _frozen_downlink(
                        el.part, h_down, ghat_g,
                        lambda: _group_downlink(ghat_g, h_down, down_key, gcfg, dcfg,
                                                gcfg.h_dtype, scale))
                    _copy_into(h_down, new_h_down)
                if telemetry:
                    moments.append(group_moments([ghat_g[p] for p in T.paths(ghat_g)]))
                ghat.update({p: g.to(params[p].dtype) for p, g in ghat_g.items()})
                del ghat_g
        del rounds
        out = _finish(opt, params, opt_state, {p: ghat[p] for p in paths},
                      torch.stack(losses).mean())
        if el.part is not None:
            out[2].update(mask=el.part.mask.tolist(), ok=el.part.ok, valid=list(el.valid))
        out[2].update(_step_telemetry(moments, el, telemetry))
        return out

    return step


def build_distributed_step(cfg, opt: DianaOptimizer, faults=None, telemetry: bool = False,
                           mesh: Optional[MeshSpec] = None):
    """Returns ``step(params, opt_state, batch, key)`` as
    :func:`build_train_step`'s, where this process is worker ``r``, its rank
    in the default process group, of ``n`` = the world size: it
    takes rows ``[r*b/n, (r+1)*b/n)`` of the global batch, encodes with
    ``fold_in(key, r)`` (``repro/launch/train.py:459``) and runs
    :func:`~repro_torch.core.diana.aggregate_distributed`.  ``opt_state``
    holds the rank's own ``h_worker`` row (``opt.init(params, 1)``, in the
    policy's layout) and the replicated ``h_server``, updated in place; a
    grouped policy runs its groups inside the round.  The logged loss is
    the all-reduced mean (``:486``).  Under participation or ``faults``
    the round gets ``part_key = fold_in(key, PART_FOLD)`` and the step
    counter (``:440-452``).  Hierarchical, the key is folded with the rank's
    node ``rank // node_size`` (``:455-459``).  ``telemetry`` as in
    :func:`build_train_step`.  Given the same batch and keys, the
    parameters and memories equal :func:`build_train_step`'s with ``n``
    workers bit for bit (``none`` and identity groups: to the backend's
    all-reduce order).

    ``mesh`` with a model axis (M > 1) builds :func:`_mesh_step` instead:
    this rank is a model shard of a worker (:mod:`repro_torch.launch.mesh`),
    the world ``N * M`` ranks."""
    if mesh is not None and mesh.model > 1:
        return _mesh_step(cfg, opt, mesh, faults, telemetry)
    rank, n_workers = dist.get_rank(), dist.get_world_size()
    if faults is not None:
        check_faults(opt.policy)
    node_size = _check_schedule(opt, n_workers, faults)

    def step(params, opt_state, batch, key):
        paths = list(params)
        wbatch = _worker_batch(batch, rank, n_workers)
        loss = train_loss(params, wbatch, cfg)
        grads = dict(zip(paths, torch.autograd.grad(loss, [params[p] for p in paths])))
        extra = {}
        if opt_state.diana.vr is not None:
            extra.update(vr_aux=(_snapshot_grads(cfg, opt_state.diana.vr.snapshot, 0, wbatch),
                                 grads),
                         params_local=params, vr_force_refresh=opt_state.step == 0)
        if opt_state.diana.h_down is not None:
            extra["down_key"] = prng.fold_in(key, DOWN_FOLD)   # before the worker fold
        if opt.policy.participation is not None or faults is not None:
            extra.update(part_key=prng.fold_in(key, PART_FOLD), step=opt_state.step,
                         faults=faults)
        if telemetry:
            extra["telemetry"] = True
        with torch.no_grad():
            out = aggregate_distributed(grads, opt_state.diana,
                                        worker_key(key, rank // node_size), opt.policy, **extra)
            ghat, new, telem = out[0], out[1], (out[2] if telemetry else None)
            del grads, extra, out
            _copy_into(opt_state.diana, new)  # each memory stays one buffer
            del new
            loss = loss.detach().clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM)
            loss = div_n(loss, n_workers)
        res = _finish(opt, params, opt_state, ghat, loss)
        if telem is not None:
            res[2].update(telemetry_m2=telem.m2, telemetry_var=telem.var, telemetry_ok=telem.ok)
        return res

    return step


def _mesh_step(cfg, opt: DianaOptimizer, mesh: MeshSpec, faults=None, telemetry=False):
    """The step on a model mesh: ``step(params, opt_state, batch, key)``
    with this rank's shards of the parameters and of the memories
    (:func:`init_train_state` with ``model``, ``shard``), as the JAX
    trainer's shard_map body runs on a ``(data, model)`` mesh
    (``repro/launch/train.py:404-495``):

    1. the worker's rows of the batch (``P(workers)``), its loss and its
       gradient shards, tensor-parallel over the worker's model group;
    2. the round on the shards over the rank's data group, keyed
       ``fold_in(key, worker)`` on every shard of the worker (the JAX
       nested per-leaf round's shared leaf keys);
    3. the logged loss all-reduced over the data group and divided by N
       (``pmean``); ``ghat_norm`` sums the split leaves' squares over the
       model group and adds the replicated leaves' once;
    4. the inner optimizer and the write-back on the shards.

    The opt is taken as :func:`resolve_bucketed` leaves it (per leaf), and
    :func:`check_model_axis` refuses the rest."""
    opt = resolve_bucketed(opt, mesh)
    check_model_axis(cfg, opt, mesh, faults, telemetry)
    groups = mesh_groups(mesh)
    n = mesh.n_workers
    specs = param_specs(meta_params(cfg), cfg, mesh.model)

    def step(params, opt_state, batch, key):
        paths = list(params)
        wbatch = _worker_batch(batch, groups.worker, n)
        with model_parallel(groups.model):
            loss = train_loss(params, wbatch, cfg)
            grads = dict(zip(paths, torch.autograd.grad(loss, [params[p] for p in paths])))
        with torch.no_grad():
            ghat, new = aggregate_distributed(grads, opt_state.diana,
                                              worker_key(key, groups.worker), opt.policy,
                                              group=groups.data)
            del grads
            _copy_into(opt_state.diana, new)
            del new
            loss = loss.detach().clone()
            transport.all_reduce(loss, group=groups.data)
            loss = div_n(loss, n)
            sq = [sum(torch.sum(ghat[p].float() ** 2) for p in paths
                      if (specs[p] is None) == rep) for rep in (False, True)]
            split = torch.as_tensor(sq[0], dtype=torch.float32, device=loss.device)
            transport.all_reduce(split, group=groups.model.group)
            gnorm = torch.sqrt(split + sq[1])
        return _finish(opt, params, opt_state, ghat, loss, gnorm)

    return step


def init_distributed(device: str, mesh: MeshSpec) -> torch.device:
    """Join the ``torchrun`` world (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
    and the rendezvous in the environment) as one rank per device of the
    mesh: NCCL bound to ``cuda:LOCAL_RANK``, or gloo with ``device='cpu'``.
    Nothing falls back: without a card, or when NCCL fails to start, it
    raises.  Returns the rank's device."""
    world = int(os.environ["WORLD_SIZE"])
    if mesh.world != world:
        raise ValueError(f"--mesh {mesh} asks for {mesh.world} ranks, but torchrun started "
                         f"{world} ranks: one rank per worker and model shard")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if dev.type == "cuda":
            dist.init_process_group("nccl", device_id=dev)
        else:
            dist.init_process_group("gloo")
    return dev


def _with_policy(opt: DianaOptimizer, policy: CompressionPolicy) -> DianaOptimizer:
    """``opt`` with another policy (inner optimizer, schedule and
    regularizer shared)."""
    return DianaOptimizer(inner=opt.inner, schedule=opt.schedule, regularizer=opt.regularizer,
                          policy=policy)


def controller_tick(controller, cstate, opt, opt_state, step_fn, metrics, params, rows: int,
                    build, log: bool = True):
    """One turn of the budget controller after a step
    (``repro/launch/train.py:849``): fold the step's telemetry into the
    EMAs, ask for a (dwell- and hysteresis-gated) decision, and on a switch
    migrate the DIANA memories onto the new policy's layout
    (:func:`~repro_torch.core.controller.migrate_diana_state`: a memory
    whose shape changes is freed before its zeros are allocated) and build
    the new policy's step with ``build(opt)``.  ``rows`` is the number of
    ``h_worker`` rows the process holds.  Returns ``(opt, opt_state,
    step_fn, cstate)``."""
    telem = GroupTelemetry(m2=metrics["telemetry_m2"], var=metrics["telemetry_var"],
                           ok=metrics["telemetry_ok"])
    cstate = observe(controller, cstate, telem)
    cstate, new_policy = maybe_reallocate(controller, cstate, params)
    if new_policy is None or new_policy == opt.policy:
        return opt, opt_state, step_fn, cstate
    if log:
        print(f"controller: switching policy at step {cstate.step} (bits/dim "
              f"{policy_bits_per_dim(new_policy, params):.3f} <= budget "
              f"{controller.budget_bits_per_dim})")
    opt = _with_policy(opt, new_policy)
    carried, fresh = [], []
    with torch.no_grad():
        diana = migrate_diana_state(opt_state.diana, params, new_policy, rows, carried, fresh)
    if log:
        print(f"controller: memories carried {carried}; restarted from zeros {fresh}")
    opt_state = opt_state._replace(diana=diana)
    return opt, opt_state, build(opt), cstate


def main(argv=None):
    ap = argparse.ArgumentParser(description="DIANA trainer (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--inner", default="momentum", choices=["momentum", "adamw", "sgd"],
                    help="the inner optimizer on ghat (the JAX CLI's momentum and adamw, "
                         "and plain sgd)")
    ap.add_argument("--compression", default=None, choices=[None, *available_methods()])
    ap.add_argument("--comp-k", type=int, default=None,
                    help="coordinates kept per leaf by rand-k / top-k (default: the "
                         "config's comp_k, 64)")
    ap.add_argument("--down-method", default=None, choices=[None, *available_methods()],
                    help="compress the server broadcast too (bidirectional DIANA), with "
                         "its own memory h_down; default keeps it exact")
    ap.add_argument("--down-k", type=int, default=None,
                    help="coordinates kept by a sparse downlink (default: --comp-k)")
    ap.add_argument("--comp-policy", default=None,
                    help="per-parameter-group compression: a policy .json file, inline "
                         "rules (pattern=method[:opt=v...][/down_method...],...; '*' is the "
                         "catch-all), 'default' for the model's curated policy, or "
                         "'size-adaptive'; overrides --compression/--comp-k/--down-*")
    ap.add_argument("--per-leaf-agg", action="store_true",
                    help="compress, gather and decode each parameter leaf on its own "
                         "instead of the whole model (or each policy group) as one buffer")
    ap.add_argument("--vr", action="store_true",
                    help="VR-DIANA: L-SVRG control variates under the compressed "
                         "differences (a second backward per worker at its snapshot)")
    ap.add_argument("--vr-p", type=float, default=None,
                    help="snapshot-refresh probability (default 1/m, m the per-worker "
                         "batch)")
    ap.add_argument("--participation-q", type=float, default=None,
                    help="elastic rounds: each worker joins a step with probability q (the "
                         "participant sum is rescaled to stay unbiased); default 1.0 keeps "
                         "the all-workers round")
    ap.add_argument("--participation-dropout", type=float, default=None,
                    help="straggler model: a sampled worker misses the step with this "
                         "probability (its memory freezes)")
    ap.add_argument("--min-workers", type=int, default=None,
                    help="degraded-step floor: with fewer participants the step applies no "
                         "update (ghat = 0, every memory frozen)")
    ap.add_argument("--faults", default=None,
                    help="fault plan: ';'-separated 'kind:step=S,worker=W[,byte=B|delay=D]' "
                         "events, kind in {drop,delay,corrupt} (e.g. 'corrupt:step=3,"
                         "worker=1'), or 'checksum' to arm the wire checksum alone; needs the "
                         "bucketed layout")
    ap.add_argument("--chunk-bytes", type=int, default=None,
                    help="split the bucketed wire into whole-leaf chunks of about this many "
                         "bytes: chunk i+1's all-gather is issued before chunk i's decode; "
                         "0 (default) keeps one chunk; bitwise the same results either way")
    ap.add_argument("--topology", default=None, choices=[None, "flat", "hierarchical"],
                    help="'hierarchical': an uncompressed mean inside each node of "
                         "--node-size workers, then the compressed round between the nodes "
                         "(one memory per node); bucketed flat configs only")
    ap.add_argument("--node-size", type=int, default=None,
                    help="workers per node under --topology hierarchical (divides N; "
                         "required, since --mesh has no node axis)")
    ap.add_argument("--budget-bits-per-dim", type=float, default=None,
                    help="the bit-budget controller: telemetry per policy group feeds an "
                         "allocator that re-picks each group's operator from a candidate "
                         "lattice, every emitted policy within this many uplink bits per "
                         "coordinate")
    ap.add_argument("--controller-interval", type=int, default=50,
                    help="at most one policy switch per this many steps")
    ap.add_argument("--warmup-dense-steps", type=int, default=0,
                    help="the first N steps aggregate dense (identity on the policy's "
                         "skeleton) before the first allocation")
    ap.add_argument("--mesh", default=None,
                    help="NxM: N data-parallel workers (M = 1), run in turn on one device, "
                         "or one per rank under torchrun (N = the world size)")
    ap.add_argument("--reduced", action="store_true", help="toy config for CPU runs")
    ap.add_argument("--batch", type=int, default=None, help="override global batch")
    ap.add_argument("--seq", type=int, default=None, help="override sequence length")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="at the end of the run, save the parameters there (repro_torch."
                         "checkpoint: the JAX trainer's files), the policy (and the "
                         "controller's state) in the manifest's metadata")
    args = ap.parse_args(argv)

    from dataclasses import replace

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.compression:
        cfg = replace(cfg, compression=args.compression)
    if args.comp_k:
        cfg = replace(cfg, comp_k=args.comp_k)
    shape = get_shape(args.shape)
    if shape.kind == "decode":
        ap.error(f"--shape {args.shape} is a decode shape (one token per sequence); serve it "
                 "with python -m repro_torch.launch.serve")
    if args.batch or args.seq:
        shape = ShapeConfig(shape.name, args.seq or shape.seq_len,
                            args.batch or shape.global_batch, shape.kind)
    if args.down_method:
        cfg = replace(cfg, comp_down_method=args.down_method)
    if args.down_k:
        cfg = replace(cfg, comp_down_k=args.down_k)
    if args.per_leaf_agg:
        cfg = replace(cfg, comp_bucketed=False)
    mesh = parse_mesh(args.mesh, args.topology)
    n_workers = mesh.n_workers
    if args.vr:
        m_local = max(1, shape.global_batch // n_workers)
        cfg = replace(cfg, vr=True, vr_p=resolve_vr_p(args.vr_p, m_local))
    participation = None
    if (args.participation_q is not None or args.participation_dropout is not None
            or args.min_workers is not None):
        participation = ParticipationSpec(
            q=1.0 if args.participation_q is None else args.participation_q,
            dropout=args.participation_dropout or 0.0, min_workers=args.min_workers or 1)
    faults = parse_faults(args.faults)
    if faults is not None and (not cfg.comp_bucketed or args.comp_policy):
        raise SystemExit("--faults needs the flat bucketed layout (the checksum rides the "
                         "fused wire buffer)")
    distributed = "WORLD_SIZE" in os.environ
    opt = make_optimizer(cfg, lr=args.lr, inner=args.inner, policy=args.comp_policy,
                         participation=participation)
    if args.chunk_bytes is not None or args.topology or args.node_size:
        pol = opt.policy
        topology = args.topology or pol.topology
        # a (node, data, model) mesh declares the node boundary
        node_size = args.node_size or (mesh.node_size if mesh.node_size > 1 else pol.node_size)
        if topology == "hierarchical" and node_size == 1:
            raise SystemExit("--topology hierarchical needs --node-size K (K > 1, dividing the "
                             "worker count) or a 3-dim --mesh (node, data, model)")
        opt.policy = pol.replace(
            chunk_bytes=pol.chunk_bytes if args.chunk_bytes is None else args.chunk_bytes,
            topology=topology, node_size=node_size)
    controller = None
    if args.budget_bits_per_dim is not None:
        if faults is not None:
            raise SystemExit("--budget-bits-per-dim does not compose with --faults (the "
                             "checksum's budget tail depends on the fault plan, not the policy)")
        # the author's policy is the skeleton every emitted policy shares
        controller = BudgetController(base=opt.policy,
                                      budget_bits_per_dim=args.budget_bits_per_dim,
                                      interval=args.controller_interval,
                                      warmup_dense_steps=args.warmup_dense_steps)
        if args.warmup_dense_steps > 0:
            opt = _with_policy(opt, controller.warmup_policy())
    telemetry = controller is not None
    if mesh.model > 1:
        if not distributed:
            raise NotImplementedError(
                f"--mesh {mesh}: the model axis runs one rank per worker and shard: "
                f"torchrun --nproc-per-node {mesh.world} (the in-turn trainer holds whole leaves)")
        opt = resolve_bucketed(opt, mesh)
        check_model_axis(cfg, opt, mesh, faults, telemetry)
    if distributed:
        device = init_distributed(args.device, mesh)
        rows = 1
        params, opt_state = init_train_state(cfg, opt, rows, device, model=mesh.model,
                                             shard=dist.get_rank() % mesh.model)
        build = lambda o: build_distributed_step(cfg, o, faults, telemetry,  # noqa: E731
                                                 mesh)
        log = dist.get_rank() == 0
    else:
        device = resolve_device(args.device)
        rows = n_workers
        params, opt_state = init_train_state(cfg, opt, rows, device)
        build = lambda o: build_train_step(cfg, o, n_workers, device, faults,  # noqa: E731
                                           telemetry)
        log = True
    step_fn = build(opt)
    cstate = None
    if controller is not None:
        cstate = init_controller_state(controller, params)
    key = prng.PRNGKey(0)
    try:
        for step in range(args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in make_lm_batch(cfg, shape, step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 prng.fold_in(key, step))
            loss = float(metrics["loss"])
            if log:
                elastic = ("" if "mask" not in metrics else
                           f" mask {metrics['mask']} ok {metrics['ok']}"
                           + (f" valid {metrics['valid']}" if metrics["valid"] else ""))
                print(f"step {step:4d} loss {loss:8.4f} ghat "
                      f"{float(metrics['ghat_norm']):9.4f} ({time.perf_counter() - t0:5.2f}s)"
                      + elastic)
            if controller is not None:
                opt, opt_state, step_fn, cstate = controller_tick(
                    controller, cstate, opt, opt_state, step_fn, metrics, params, rows, build,
                    log=log)
        if args.checkpoint_dir and mesh.model > 1:
            # the shards gathered into the global arrays the JAX trainer saves
            params = gather_tree(params, param_specs(meta_params(cfg), cfg, mesh.model),
                                 mesh_groups(mesh).model)
        if args.checkpoint_dir and log:
            # the policy rides in the metadata, so a restore can rebuild the
            # matching (possibly grouped) state template; with the controller
            # on, its state and telemetry EMAs ride along
            metadata = {"policy": opt.policy.to_json_dict()}
            if controller is not None:
                metadata["controller"] = controller_metadata(controller, cstate)
            save_checkpoint(args.checkpoint_dir, args.steps, {"params": params},
                            metadata=metadata)
            print(f"checkpoint written to {args.checkpoint_dir}")
    finally:
        if distributed and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
