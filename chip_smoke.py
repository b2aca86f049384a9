"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit, the torch / CUDA versions, and the SM count and maximum SM
   clock that the integer bound (:func:`bound_int`) counts with;
2. build: compiles every kernel source of ``src/repro_torch/csrc`` (one nvcc
   each, in parallel) into ``build/torch_kernels/``;
3. kernels: each kernel's wrapper on the card at the trainer's shapes (the
   8-layer full-width llama3.2-1b bucket, n = 4 workers), held against its
   plain PyTorch version on the same inputs.  Ternary (B = 2048): threefry
   bits, ``unpack_reduce``, ``_mean`` and ``_apply`` bitwise,
   ``quantize_pack`` bitwise for p = inf and, for p in {1, 2}, scales within
   4 ulp and codes equal on >= 99.99% of coordinates; ``quantize_pack_prng``
   (bits drawn in the kernel from the 12 segments' keys) bitwise its plain
   version at p = inf and bitwise ``quantize_pack`` fed ``threefry_bits``
   at p in {inf, 2, 1}.  Natural (alignment 1, Dp = the parameter count):
   ``nat_pack``, ``nat_pack_prng`` (also bitwise ``nat_pack`` fed
   ``threefry_bits``), ``nat_decode_sum`` (n = 1 and 4), ``_mean`` and
   ``_apply`` bitwise, on inputs spliced with zeros, +-2^k, the float below
   2^k, subnormals, FLT_MAX and codes that decode to -0.0, subnormals and
   infinity.  Sparse (rand-k with k = 2^20 per leaf, K = 9,472,000 kept
   entries per worker): ``sparse_gather``, ``sparse_decode_sum`` (n = 1 and
   4) and ``_mean`` (n = 4) bitwise (and both at n = 513, more workers than
   one launch group, at a small d), on payloads from a real rand-k bucketed
   compress with -0.0, +-inf, subnormals, products that underflow to -0.0
   and indices 0 and Dp - 1 spliced in; the gather also over K uniform
   indices confined to windows of 32 MB, 256 MB, 1 GB and the whole bucket,
   beside ``index_select`` (what sets its pace); the n = 4 decode twice
   (the same bits), split into its phases (count, scan, bin, sort, tile) by
   ``torch.profiler`` at n = 1 and 4, with the most entries any coarse bin
   holds.  Dense (identity, alignment 1):
   ``dense_copy`` into the rows of the gathered (4, Dp) buffer,
   ``dense_decode_sum`` (n = 1 and 4) and ``_mean`` (n = 4) bitwise, with
   -0.0 (in every worker), +-inf, subnormals and FLT_MAX spliced in, and
   ``dense_copy`` against ``Tensor.copy_`` in 20 interleaved calls.  Median
   time (CUDA events) of kernel and plain version, the bound (bytes over HBM
   bandwidth, or operations over the peak rate; for the threefry cipher its
   integer instructions over the SMs' dispatch rate) and, where one PyTorch call
   computes the same function, that call's time (``index_select``,
   ``Tensor.copy_``, ``sum(0)``, ``mean(0)``; the port never calls them);
3b. harness kernels: ``quantize_pack_prng`` (p = inf bitwise the plain
   version; p = 2 bitwise ``quantize_pack`` fed ``threefry_bits``, within
   its tolerance of the plain version) and ``unpack_reduce`` / ``_mean`` /
   ``_apply`` (n = 1, 4, 10, bitwise) at the convex harness's shapes:
   blocks of 8, 16 and 64 over a leaf of d = 24 or 112 (1 to 14 rows);
3c. convex: the paper's convex harness (``repro_torch.benchmarks.common``)
   on the card: f*, law (a) batch DIANA, laws (b) and (c) in the stochastic
   regime (DIANA, VR-DIANA, QSGD), bidirectional DIANA, with the JAX
   suite's thresholds, and 200 steps on the mushrooms-scale problem at
   n = 10; each run's launches exact per step, its gap and us per step;
4. reference: two training steps of ``reduced(llama3.2-1b)`` (f32) on the
   card through the kernels, against the same steps with every kernel
   swapped for its plain version (bitwise: losses, parameters, memories),
   for ``diana``, ``natural``, ``randk``, ``topk_ef`` and ``none``, each
   bucketed and ``--per-leaf-agg`` (the kernels at one leaf's shapes,
   uint16 sparse indices included), and ``--comp-policy default`` (three
   groups side by side), and the step-0 loss against its float64
   evaluation (rel 1e-5);
5. the main path: the trainer's ``build_train_step`` on llama3.2-1b at full width
   (d_model 2048, 32/8 heads, d_ff 8192, vocab 128256, bf16, remat full),
   cut to 8 of 16 layers and a global batch of 8 at seq 4096, 4 workers,
   ``diana``, 3 steps; launch counters reset just before and read just
   after, exactly: 4 quantize_pack_prng, 4 unpack_reduce (each worker's own
   decode) and 1 unpack_reduce_apply per step, no threefry_bits;
6. the memoryless path (``terngrad``, 2 layers, 1 step): 4
   quantize_pack_prng and one ``unpack_reduce_mean``;
7. the natural main path: the same trainer and model with ``natural``,
   3 steps: 4 nat_pack_prng, 4 nat_decode_sum (each worker's own decode)
   and 1 nat_decode_sum_apply per step, no threefry_bits;
8. the memoryless natural round (``NaturalCompressor(memory=False)`` over
   the 8-layer bucket, 4 workers): 4 nat_pack_prng, one
   ``nat_decode_sum_mean``;
9. the pre-drawn-bits round: one bucketed encode per worker (4 workers) of
   the 8-layer bucket through ``threefry_bits`` + ``quantize_pack`` and
   ``nat_pack``, each payload bitwise the in-kernel-PRNG route's;
10. the rand-k main path: the same trainer and model with ``randk``,
   ``comp_k`` 2^20, 3 steps: per step 48 threefry draws (12 segments x 4
   workers), 4 sparse_gather, 4 sparse_decode_sum (each worker's own
   decode) and 1 sparse_decode_sum (the server sum); the selection
   (threefry + top-k of one worker's 12 segments) timed on its own;
11. the top-k EF main path: the same with ``topk_ef``: per step 4
   sparse_gather, 4 sparse_decode_sum and 1 sparse_decode_sum_mean; then,
   after the counts and the peak are read, one more step whose server
   decode's inputs are kept: on that real top-k EF payload,
   ``sparse_decode_sum`` (n = 1) and ``_mean`` (n = 4) bitwise, timed
   beside ``zero_`` + n x ``index_add_``, split into phases, with the most
   entries any coarse bin holds;
12. the ``none`` main path: the same trainer and model with ``none`` (the
   uncompressed baseline), 3 steps: 4 dense_copy and 1
   dense_decode_sum_mean per step, nothing else;
13. the dense-sum round: ``BucketedCompressor(IdentityCompressor(),
   layout).decode_sum`` over a gathered (4, Dp) payload of 4 workers: one
   ``dense_decode_sum``, bitwise its plain version;
13a. per-leaf: the in-turn trainer with ``--per-leaf-agg`` on the 4-layer
   full-width slice, 4 workers, batch 8 x 4096, 2 steps, for ``diana``,
   ``natural``, ``randk``, ``topk_ef`` and ``none``, bitwise (losses,
   parameters, every leaf's ``h_worker`` rows and ``h_server`` against its
   stretch of the bucket) the bucketed trainer's 2 steps from the same
   state, batches and keys, which stay on the card meanwhile (a memoryless
   operator's memories, zero on both sides, are checked zero instead);
   launches exact per step: each kernel once per leaf and worker, the
   server's once per leaf (12 leaves);
13b. policy: llama3.2-1b's curated ``--comp-policy default`` on the same
   slice and batch, in turn at n = 4, 2 steps: its three groups (identity
   on the norm scales, top-k EF k = 256 on ``embed`` and ``lm_head``,
   ternary on the rest) with their sizes and the uplink's wire bits per
   coordinate (``policy_bits_per_dim``), one worker's top-k selection over
   the top-k group timed alone, launches exact per step: ``dense_copy`` /
   ``dense_decode_sum_mean``, ``sparse_gather`` / ``sparse_decode_sum`` /
   ``sparse_decode_sum_mean`` and ``quantize_pack_prng`` /
   ``unpack_reduce`` / ``unpack_reduce_apply`` in one step;
14. distributed: the ``torch.distributed`` round through the trainer's
   ``build_distributed_step`` in a world of one over NCCL, in this process
   (a ``HashStore``; NCCL puts no two ranks on one GPU): for ``diana``,
   ``natural``, ``randk``, ``topk_ef`` and ``none``, 2 steps of the 8-layer
   full-width slice at a batch of 2 x 4096, held bitwise (losses,
   parameters, ``h_worker``, ``h_server``) to ``build_train_step`` at
   n = 1 on the same batches and keys; launch counts exact per step (1
   encode, 1 own decode, 1 server decode; ``randk`` 12 threefry draws and 2
   sparse decodes; ``none`` no kernel: its round is one all-reduce); the
   all-gather timed with CUDA events and its bytes printed (at world 1 a
   device copy of the payload, not a wire);
15. vr / downlink: the same world of one and the in-turn trainer at n = 1,
   2 steps each at 8 layers, for ``diana --vr``, ``diana --down-method
   diana`` and ``diana --vr --down-method topk_ef --down-k 2^20``:
   losses, parameters, both memories, the (snapshot, mu) rows and
   ``h_down`` bitwise; launches exact per step (VR none of its own, a diana
   downlink 1 quantize_pack_prng + 1 unpack_reduce, a top-k EF downlink 1
   sparse_gather + 1 sparse_decode_sum);
15b. policy in a world of one: ``--comp-policy default`` through
   ``build_distributed_step`` (the identity group one all-reduce, each
   other group one all-gather), 2 steps at a batch of 2 x 4096, bitwise
   the in-turn trainer at n = 1 (every group's memories);
15c. elastic: ``--participation-q 0.6 --participation-dropout 0.1
   --min-workers 3`` (the step keys' masks at n = 4: 1011, 1111, then a
   degraded 0101) with ``--faults corrupt:step=1,worker=0``, in turn at n =
   4 on the 4-layer slice, 3 steps of ``diana``: each step's mask, ``ok``
   and wire verdicts, and bitwise: the non-participant's row zero after
   step 0, the corrupted worker's row unchanged at step 1, ``h_server``
   unchanged and ghat zero on the degraded step; launches exact (the own
   decode of the advancing rows, one ``unpack_reduce`` server sum per
   step); the checksum of one worker's wire timed against its byte bound;
   steps 0-1 again with worker 0's churn leave at step 1 in place of the
   fault, parameters, momentum and memories bitwise the fault run's after
   step 1; ``none`` under participation, 2 steps: its masked server sum
   is ``dense_decode_sum``, one per step; the world of one over NCCL with
   participation and the corrupted wire (the checksummed wire crosses the
   all-gather), bitwise in turn at n = 1; and the five operators on the
   reduced model at n = 4, bucketed with the fault plan and per leaf, 3
   steps through the kernels bitwise the same steps through the plain
   versions;
15d. schedule: ``diana`` and ``randk`` with ``--chunk-bytes 2^29`` in turn
   at n = 4, 2 steps each, bitwise (losses, parameters, momentum,
   ``h_worker``, ``h_server``) the monolithic steps from the same state,
   which stay on the card meanwhile; the chunk count and sizes and the
   launches per step printed and exact (each encode, own decode and server
   decode once per chunk); the kernels on chunk views at full width (the
   second chunk of the ternary bucket, ``h_server`` a view; the natural and
   dense kernels on views 4 bytes into their buffers; ``sparse_gather``,
   ``sparse_decode_sum`` at n = 1 and 4 and ``sparse_decode_sum_mean`` on
   the second chunk of the rand-k and top-k EF buckets, indices
   chunk-local) bitwise their plain versions and timed; on the reduced model, ``natural``, ``topk_ef`` and
   ``none`` chunked and ``diana`` hierarchical (chunked and not) through
   the in-turn trainer, bitwise ``reference_step`` on the same per-worker
   gradients, and on a tree with leaf sizes 384, 260, 160, 279, 70 and 1
   (chunks at offsets that are not 16-byte aligned) the chunked and
   hierarchical ``reference_step`` of all five operators through the
   kernels bitwise the plain versions; ``diana --topology hierarchical
   --node-size 2`` at full width, n = 4, 2 steps: node rows bitwise
   duplicates, ``h_server`` within 8 roundings per step of the mean of the
   node rows, two encodes per step; and the chunked world of one over NCCL
   bitwise the chunked in-turn trainer at n = 1, through the round's own
   asynchronous gathers, each chunk's all-gather timed from its issue to
   the wait on it and the issue order of gathers and decodes checked;
15e. controller: ``--comp-policy default --budget-bits-per-dim 1.0
   --controller-interval 1 --warmup-dense-steps 1`` in turn at n = 4, 3
   steps: step 0 dense, then the allocation (its policy and
   ``policy_bits_per_dim`` <= 1.0, the memories carried and restarted),
   each step's time and launches, the peak, and the telemetry within 1e-4
   (relative to ``m2``) of a float64 recomputation of ``measure`` on the
   same served direction;
16. the full depth: the distributed ``diana`` path on all 16 layers,
   world of one, 2 steps (3 until serve-mesh): finite losses, step times
   and peak memory;
17. models: the other model families through the in-turn trainer at n = 4,
   batch 8 x 4096, 3 steps each: ``granite-moe-3b-a800m`` at full width
   (d_model 1536, 24/8 heads, 40 experts top-8 of d_ff 512, vocab 49155,
   bf16, remat full) cut to 4 of 32 layers (566,490,624 parameters in 13
   leaves; 8 layers until the ``mesh:`` phase needed the time) with ``--comp-policy default --inner adamw`` (identity on the
   router and the norm scales, top-k EF on ``embed`` / ``lm_head``,
   natural on the experts, ternary on attention: each group's encode and
   own decode 4 times and its server decode once per step, exact);
   ``mamba2-130m`` at full width cut to 8 of 24 layers (111,912,256
   parameters, 16 SSD chunks of 256 per sequence; 24 layers until the
   ``serve-mesh:`` phase needed the time), flat ``diana`` at its
   block of 1024 and then its ``--comp-policy default``; step times, peak,
   held bytes and launches printed; then every other registered arch,
   reduced (f32; the hybrid ``jamba`` pattern, the vision and audio
   frontends, GELU and squared ReLU, the three bf16-memory configs), 2
   workers, 2 steps through the kernels bitwise the same steps through the
   plain versions;
17a. checkpoint (:func:`checkpoint_phase`): the CLI's params-only
   ``--checkpoint-dir`` save of llama3.2-1b at full width and depth (one
   step at n = 1): its seconds and bytes, and the restore onto the card,
   bitwise; save-restore-step on the reduced model through the kernels (3
   steps, a save, the 4th step from the restore bitwise the 4th step in
   memory) for the five operators, ``--per-leaf-agg``, the curated policy,
   VR with a diana downlink, adamw, an elastic churn join and a world of
   one over NCCL; one full-state resume at full width cut to one layer, n
   = 1 (~8.4 GB), into a temporary directory deleted after, free disk
   printed before;
17b. helpers (:func:`helpers_phase`): ``compress_tree`` /
   ``decompress_tree`` for the five operators on the 8-layer full-width
   tree (12 bf16 leaves): each leaf's encode kernel and one-worker decode
   (``none`` decodes with a view), launches exact, every payload and
   decoded leaf bitwise the same calls through the plain versions, rand-k's
   tags (``threefry_bits`` at each leaf's size) bitwise theirs;
17c. remat (:func:`remat_phase`): the aten ops the ``remat="dots"`` policy
   sees in one block of reduced llama, granite-moe, mamba2 and jamba and
   of full-width llama, and the products it saves (as on the CPU); two
   ``diana`` steps of the slice under ``remat="full"`` and then ``"dots"``
   from the same state, bitwise, with step times, peaks and launches;
17d. mesh (:func:`mesh_phase`): the model axis, ``--mesh 2x2`` as four
   processes sharing the card over gloo (which collectives gloo takes CUDA
   tensors for is probed; the others cross the host, named on the line),
   llama3.2-1b at full width cut to 4 layers, 8 x 4096 global: 2 steps
   (:data:`MESH_STEPS`; 3 until serve-mesh) of ``diana`` (downgraded per
   leaf, its warning printed) and of ``none``,
   per rank the step times, peak, the round's time and collectives and the
   tensor-parallel ones, launches exact per rank; replicated leaves
   bitwise across model ranks; step 0's round bitwise its plain version
   on the same shards; then the MoE, frontend and Mamba-2 families
   (:data:`MESH_FAMILIES`: granite-moe's ``ffn`` and phi3.5-moe's
   ``expert`` partitions, internvl2-2b, musicgen-large and mamba2-130m at
   full width, the Jamba hybrid reduced) the same way, with their tagged
   MoE, frontend and Mamba-2 collectives (the ``mamba`` gathers exact) and
   their held bytes beside the reckoning, one full-width MoE layer of each
   partition against the unsharded layer (:data:`MOE_LAYER_BITWISE`,
   :data:`MOE_LAYER_TOL`) and one full-width Jamba Mamba-2 mixer against
   the unsharded mixer, bitwise;
   the four compressing
   operators on the reduced model over the mesh through the kernels
   bitwise the plain versions; ``none`` against the in-turn trainer at
   n = 2 within its stated tolerance.  The trainer runs of ``per-leaf:``,
   ``policy:``, ``elastic:`` and ``schedule:`` take llama at
   :data:`PHASE_LAYERS`;
18. serve: serving, which launches none of the kernels (:func:`serve_phase`):
   ``llama3.2-1b`` at full width and depth, decoding 16 tokens at batch 32
   against caches of 32,768 positions through ``build_serve_step`` (ms per
   token against the byte bound of reading the whole cache and the
   weights, twice from the same state bitwise, the logits against the
   forward over the same tokens), its prefill of one 16,384-token prompt
   (32,768 until serve-mesh)
   through ``build_prefill``, and ``long_500k`` through the CLI (the
   8192-slot ring buffer); ``mamba2-130m`` at full depth, decode_32k at
   its batch of 128 in process (the same checks) and through the CLI, then
   its prefill; ``granite-moe-3b-a800m`` at all 32 layers decoding 8
   tokens at batch 8 (capacity 2 per expert: the decode drops choices);
   every other arch reduced (f32) decoding 16 tokens within 1e-5 of the
   same decode on the CPU and within 2e-4 of the forward, and reduced
   llama through a ring buffer of 6;
19. serve-mesh (:func:`serve_mesh_phase`): serving over ``--mesh 2x2`` as
   four gloo processes sharing the card (no kernel launches), each path
   first on one device in this process as the reference: llama3.2-1b at
   full width and depth, decode_32k at batch 32 (16 rows and 4 KV heads a
   rank), long_500k (the ring buffer split over the data ranks, wrapping
   inside the run) and a 4 x 4096 prefill; mamba2-130m at batch 128 (no
   Mamba-2 gather in a step; the held caches beside their reckoning);
   granite-moe-3b-a800m at all 32 layers, batch 8, in f32 (the kept MoE
   choices equal to the single-device decode's); per rank ms per token,
   peak, the tagged collectives, the logits against the reference, the
   same bits twice.

Each timed step starts from a Python collection (outside its time); its
line gives the time of the collections inside it and the caching
allocator's device allocations, frees and retries.  Each kernel is credited
with the launches of the path or round that runs it (``launches``), and
with those of every other path that ran it (``paths``: path -> launches);
the kernels of the chunked path carry their time on a chunk view
(``chunk_view_ms``, ``chunk_view``).
Then one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak memory rate
F32_OPS_PER_S = 67e12          # H100 SXM non-tensor f32 peak (an FMA counts 2): float work
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak (f32 accumulation)
CIPHER_INSTRUCTIONS = 68       # threefry2x32-20 per word, from its specification (bound_int)
LANES_PER_SM_CLOCK = 128       # 4 warp-instructions dispatched per SM per clock
LAYERS, BATCH, SEQ, WORKERS, STEPS = 8, 8, 4096, 4, 3
PHASE_LAYERS = 4               # the trainer runs of per-leaf, policy, elastic and schedule
GRANITE_LAYERS = 4             # models: granite-moe-3b-a800m's depth (of 32)
MAMBA_LAYERS = 8               # models: mamba2-130m's depth (of 24; 24 until serve-mesh)
# steps of the cuts made to pay for serve-mesh (3 before it): the full
# depth's distributed diana run and each mesh: run
FULL_DEPTH_STEPS = MESH_STEPS = 2
SERVE_PREFILL = 16384          # serve: llama's and mamba2's prompt (32,768 before serve-mesh)
COMP_K = 1 << 20               # rand-k / top-k: coordinates kept per leaf


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median of per-call CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_int(words: float, nbytes: float, clock_hz: float, sms: int):
    """The least time for ``words`` threefry2x32 words plus ``nbytes`` of
    memory traffic: the larger of the bytes over the HBM rate and the
    cipher's integer instructions over the SMs' dispatch rate.

    Threefry2x32 with 20 rounds, counted from its specification, takes 68
    32-bit integer instructions per word: 1 for the counter's low word plus
    the key (the high word is the same for a run of words, below 2^32 words
    a constant, so x0's start is computed once); 60 for the 20 rounds (add,
    rotate, xor); 1 for x0's five key injections, whose first four fold
    into the next round's three-input add; 5 for x1's five injections; 1 for
    the final x0 ^ x1.  An SM dispatches at most 4 warp-instructions per
    clock, 128 lanes, on ``sms`` SMs at ``clock_hz`` (the card's maximum SM
    clock).  This ignores that xor and funnel shift issue only on the
    64-lane integer pipe, and the encode's own arithmetic, so it is a lower
    bound."""
    t_ops = words * CIPHER_INSTRUCTIONS / (LANES_PER_SM_CLOCK * sms * clock_hz) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def state_leaves(x):
    """The tensors of a DIANA state (memories, VR slot, h_down; bucketed,
    per leaf or grouped) in a fixed order; an optimizer state's step count
    is no tensor."""
    if x is None or isinstance(x, int):
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in state_leaves(x[k])]
    return [t for f in x for t in state_leaves(f)]

SERVE_TOKENS = 16
BF16_EPS = 2.0 ** -7
# decode - forward, in bf16 epsilons of the largest logit: twice the CPU
# bound of tests/test_torch_serve_prefill.py::test_bf16_decode_equals_forward
SERVE_PARITY = {"llama3.2-1b": 8, "mamba2-130m": 32}


def serve_phase(dev, card: str, get_cfg=None, sizes=None, cli_args=()) -> None:
    """Serving on the card (no kernel of the port runs here).

    ``get_cfg(arch)`` gives the full-width config and ``sizes`` the
    (batch, cache length) per path and the prefill length; a CPU rehearsal
    passes reduced configs, small sizes and the CLI's ``--reduced --device
    cpu`` as ``cli_args``."""
    import numpy as np

    from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs, reduced
    from repro_torch.core import prng
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch.serve import build_prefill, build_serve_step, decode_window
    from repro_torch.models.transformer import (count_active_params, count_params, decode_step,
                                                forward, head_logits, init_caches, init_model)

    get_cfg = get_cfg or get_config
    sizes = sizes or {"llama": (32, SHAPES["decode_32k"].seq_len),
                      "mamba": (SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len),
                      "granite": (8, SHAPES["decode_32k"].seq_len),
                      "prefill": SERVE_PREFILL}
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else 0

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def leaves(caches):
        return [t for c in caches for t in c]

    def bit_sums(caches):
        """Each cache leaf's bits summed as int64, block by block (exact)."""
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return [int(sum(int(t[i].view(ints[t.element_size()]).long().sum())
                        for i in range(t.shape[0]))) for t in leaves(caches)]

    def decode(label, cfg, params, batch, cache_len, steps):
        """``steps`` greedy tokens from empty caches through
        ``build_serve_step``, twice from the same state; returns the tokens
        fed (B, steps), the logits (B, steps, V_pad), the final caches and
        each run's per-token times."""
        shape = ShapeConfig("serve", cache_len, batch, "decode")
        caches = init_caches(cfg, batch, cache_len, device=dev)
        step = build_serve_step(cfg, shape)
        first = prng.randint(prng.PRNGKey(0), (batch, 1), 0, cfg.vocab).to(dev)
        runs = []
        for _ in range(2):
            for t in leaves(caches):
                t.zero_()
            toks, fed, out, evs = first, [], [], []
            sync()
            with torch.inference_mode():
                for _ in range(steps):
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)) if on_card else None
                    if ev:
                        ev[0].record()
                    lg, caches = step(params, caches, toks)
                    fed.append(toks)
                    out.append(lg)
                    toks = torch.argmax(lg[:, -1:], dim=-1) % cfg.vocab
                    if ev:
                        ev[1].record()
                    evs.append(ev)
            sync()
            ms = [a.elapsed_time(b) for a, b in evs] if on_card else []
            runs.append((torch.cat(fed, 1), torch.cat(out, 1), ms, bit_sums(caches)))
        (fed, out, ms, sums), (fed2, out2, ms2, sums2) = runs
        same = torch.equal(fed, fed2) and torch.equal(out, out2) and sums == sums2
        pos = [int(c.pos[0]) for c in caches]
        if not same or not bool(torch.isfinite(out).all()) or set(pos) != {steps}:
            fail(f"serve: {label}: the two decodes differ ({not same}), non-finite logits or "
                 f"cache positions {pos} (expected {steps})")
        if on_card:
            profile_step(label, lambda: step(params, caches, toks))
        return fed, out, caches, ms, ms2

    def profile_step(label, fn):
        """One more step under torch.profiler: the device's busy time
        against the step's wall time, and the kernels that take it."""
        sync()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.inference_mode():
                fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [(ev.key, ev.device_time_total / 1e3, ev.count) for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
                and ev.device_time_total > 0]
        busy = sum(t for _, t, _ in kern)
        top = sorted(kern, key=lambda k: -k[1])[:8]
        print(f"serve: {label} one more step under torch.profiler: device busy {busy} ms of "
              f"{wall} ms wall ({len(kern)} kernel names, {sum(c for *_, c in kern)} "
              f"launches); top by device time: "
              + "; ".join(f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in top))
        del prof

    def full_decode(arch, key, steps, parity_bound=None):
        cfg = get_cfg(arch)
        batch, cache_len = sizes[key]
        params = init_model(cfg, dev, seed=0)
        n = count_params(params)
        pbytes = nbytes(params.values())
        free()
        t0 = time.perf_counter()
        fed, out, caches, ms, ms2 = decode(arch, cfg, params, batch, cache_len, steps)
        wall = time.perf_counter() - t0
        top = peak()
        cbytes = nbytes(leaves(caches))
        bound_ms = (cbytes + pbytes) / HBM_BYTES_PER_S * 1e3
        med = statistics.median(ms2) if ms2 else float("nan")
        print(f"serve: {arch} ({cfg.citation}) decode: {cfg.n_layers} layers, {n} parameters "
              f"({pbytes} B), batch {batch} x cache {cache_len}: {steps} tokens from empty "
              f"caches through build_serve_step, twice, the same bits (logits, tokens, caches); "
              f"ms per token (CUDA events, second run) median {med}, all {ms2}; first run "
              f"{ms}; {batch / med * 1e3 if ms2 else float('nan')} tokens/s; cache {cbytes} B "
              f"({[str(t.dtype) for t in leaves(caches)][:3]}); byte bound per token "
              f"(cache + weights) / {HBM_BYTES_PER_S:.3g} B/s = {bound_ms} ms "
              f"({bound_ms / med if ms2 else float('nan')} of it); peak {top} B; both runs "
              f"{wall} s; {card}")
        if parity_bound is not None:
            # the decode's logits against the forward over the same tokens
            with torch.inference_mode():
                x, _ = forward(params, {"tokens": fed}, cfg)
                full = head_logits(params, x, cfg)
            err, scale = float((out - full).abs().max()), float(full.abs().max())
            agree = float((out.argmax(-1) == full.argmax(-1)).float().mean())
            del x, full
            print(f"serve: {arch} decode vs forward over the same {batch} x {steps} tokens: "
                  f"max |difference| {err} on logits up to {scale} ({err / (BF16_EPS * scale)} "
                  f"bf16 epsilons of the largest; bound {parity_bound}); argmax agrees on "
                  f"{agree} of the tokens")
            if not err <= parity_bound * BF16_EPS * scale:
                fail(f"serve: {arch}: the decode's logits differ from the forward's by {err}, "
                     f"more than {parity_bound} bf16 epsilons of {scale}")
        del caches, out, fed
        return cfg, params

    def prefill(arch, cfg, params):
        seq = sizes["prefill"]
        shape = ShapeConfig("prefill_32k", seq, 1, "prefill")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(cfg, shape, 0).items()}
        fn = build_prefill(cfg, shape)
        free()
        outs, secs = [], []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            outs.append(fn(params, batch))
            sync()
            secs.append(time.perf_counter() - t0)
        top = peak()
        lg = outs[0]
        # the least time: every matrix product at the bf16 tensor-core rate
        # (its operands are bf16, its sums f32) -- the projections of each
        # prompt token (the MoE's active experts; not the embedding, and the
        # head for the last token only) and the causal half of the attention
        # products -- or the weights read once, whichever is longer
        heads = [k for k in params if k in ("embed", "lm_head")]
        proj = count_active_params(cfg, params) - sum(params[k].numel() for k in heads)
        n_attn = sum(spec.mixer == "attn" for spec in cfg.pattern) * cfg.n_blocks
        ops = 2 * proj * seq + n_attn * 2 * seq * seq * cfg.n_heads * cfg.resolved_head_dim
        bound_ms = max(ops / BF16_OPS_PER_S, nbytes(params.values()) / HBM_BYTES_PER_S) * 1e3
        ok = (tuple(lg.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(lg).all())
              and torch.equal(outs[0], outs[1]))
        print(f"serve: {arch} prefill: one {seq}-token prompt through build_prefill "
              f"({cfg.n_layers} layers), next-token logits {tuple(lg.shape)}, twice the same "
              f"bits: {ok}; seconds {secs}; {seq / secs[-1]} prompt tokens/s; bound {bound_ms} ms "
              f"({ops:.4g} matrix-product operations at {BF16_OPS_PER_S:.3g}/s); peak {top} B; "
              f"{card}")
        if not ok:
            fail(f"serve: {arch} prefill: bad or non-deterministic logits")

    def cli(args):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args,
                              *cli_args], capture_output=True, text=True, env=env,
                             timeout=900, cwd=str(ROOT))
        line = (res.stdout.strip().splitlines() or [""])[-1]
        print(f"serve: python -m repro_torch.launch.serve {' '.join(args)}: exit "
              f"{res.returncode}, {time.perf_counter() - t0} s with the process's start: {line}")
        if res.returncode != 0 or not line.startswith("decoded "):
            fail(f"serve: the CLI failed ({args}): {res.stderr[-2000:]}")

    # (a) llama3.2-1b, full width and depth
    cfg, params = full_decode("llama3.2-1b", "llama", SERVE_TOKENS, SERVE_PARITY["llama3.2-1b"])
    prefill("llama3.2-1b", cfg, params)
    del params
    free()
    cli(["--arch", "llama3.2-1b", "--shape", "long_500k", "--tokens", str(SERVE_TOKENS)])

    # (b) mamba2-130m, full depth
    cfg, params = full_decode("mamba2-130m", "mamba", SERVE_TOKENS, SERVE_PARITY["mamba2-130m"])
    del params
    free()
    cli(["--arch", "mamba2-130m", "--shape", "decode_32k", "--tokens", str(SERVE_TOKENS)])
    cfg = get_cfg("mamba2-130m")
    params = init_model(cfg, dev, seed=0)
    prefill("mamba2-130m", cfg, params)
    del params
    free()

    # (c) granite-moe-3b-a800m, all 32 layers, batch 8: capacity 2 per expert
    gcfg = get_cfg("granite-moe-3b-a800m")
    batch = sizes["granite"][0]
    cap = max(1, int(gcfg.moe.capacity_factor * batch * gcfg.moe.top_k / gcfg.moe.n_experts))
    print(f"serve: granite-moe-3b-a800m decode capacity per expert at batch {batch}: {cap} "
          f"(top-{gcfg.moe.top_k} of {gcfg.moe.n_experts}, capacity factor "
          f"{gcfg.moe.capacity_factor})")
    _, params = full_decode("granite-moe-3b-a800m", "granite", 8)
    del params
    free()

    # (d) every other arch reduced (f32): the card against the CPU and the forward
    def teacher(cfg, params, tokens, window=None):
        caches = init_caches(cfg, tokens.shape[0], tokens.shape[1], window=window,
                             device=tokens.device)
        out = []
        with torch.inference_mode():
            for t in range(tokens.shape[1]):
                lg, caches = decode_step(params, tokens[:, t:t + 1], caches, cfg, window)
                out.append(lg)
        return torch.cat(out, 1), caches

    cases = [(a, None) for a in list_archs()
             if a not in ("llama3.2-1b", "mamba2-130m", "granite-moe-3b-a800m")]
    cases.append(("llama3.2-1b", 6))
    for arch, window in cases:
        cfg = reduced(get_config(arch))
        host = init_model(cfg, "cpu", seed=3)
        tokens = torch.from_numpy(
            np.random.default_rng(4).integers(0, cfg.vocab, (2, SERVE_TOKENS)))
        want, _ = teacher(cfg, host, tokens, window)
        params = {k: v.detach().to(dev) for k, v in host.items()}
        got, caches = teacher(cfg, params, tokens.to(dev), window)
        again, _ = teacher(cfg, params, tokens.to(dev), window)
        with torch.inference_mode():
            x, _ = forward(params, {"tokens": tokens.to(dev)}, cfg, window)
            full = head_logits(params, x, cfg)
        err_cpu = float((got.cpu() - want).abs().max())
        tol_cpu = 1e-5 * max(1.0, float(want.abs().max()))
        err_fwd = float((got - full).abs().max())
        rows = caches[0].k.shape[2] if window else None
        print(f"serve: reduced {arch}{f' window {window} ({rows} cache rows)' if window else ''}"
              f": {SERVE_TOKENS} tokens decoded on the card, max |card - CPU| {err_cpu} (bound "
              f"{tol_cpu}), max |decode - forward| {err_fwd} (bound 2e-4), twice the same bits: "
              f"{torch.equal(got, again)}")
        if not (err_cpu <= tol_cpu and err_fwd <= 2e-4 and torch.equal(got, again)):
            fail(f"serve: reduced {arch}: the card's decode is off")
        if window and not (rows == window < SERVE_TOKENS):
            fail(f"serve: reduced {arch}: the ring buffer has {rows} rows, not {window}")
    print(f"serve: the phase took {time.perf_counter() - t_phase:.1f} s")



# ----------------------------------------------- the checkpoint, helpers and remat phases

def _flat(tree, prefix=""):
    """``{key path: leaf}`` of a tree of tensors and ints (dicts,
    NamedTuples, lists, tuples; ``None`` dropped), as the checkpoint keys
    it."""
    if tree is None:
        return {}
    if isinstance(tree, (torch.Tensor, int)):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _same_bits(a, b) -> bool:
    """Two tensors (or ints) with the same dtype, shape and bits."""
    if not isinstance(a, torch.Tensor):
        return type(a) is type(b) and a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.is_floating_point():
        a, b = a.detach().view(ints[a.element_size()]), b.detach().view(ints[b.element_size()])
    return torch.equal(a, b)


def _same_trees(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return sorted(fa) == sorted(fb) and all(_same_bits(fa[k], fb[k]) for k in fa)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(tree).values()
               if isinstance(t, torch.Tensor))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def _reset_peak(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def checkpoint_phase(dev, card: str, get_cfg=None, cli_args=(), backend="nccl",
                     full_layers=1, seq=SEQ) -> dict:
    """The checkpoint (``repro_torch.checkpoint``) on the card:

    1. the CLI's params-only save (``--checkpoint-dir``) of llama3.2-1b at
       full width and depth after one step at n = 1: the save's seconds and
       bytes, then the restore onto the card into a template of another
       seed, bitwise the saved parameters;
    2. save-restore-step on the reduced model through the kernels: 3 steps,
       a save, the 4th step continued in memory and again from the
       checkpoint restored into a template of another seed, bitwise
       (losses, parameters, every optimizer-state leaf), for the five
       operators, ``--per-leaf-agg``, the curated policy, VR with a diana
       downlink, adamw, an elastic run whose 4th step is a churn join, and
       a world of one over ``backend``;
    3. one full-state resume at full width cut to ``full_layers`` layers at
       n = 1 (~8 GB on disk at one layer), into a ``tempfile.mkdtemp()``
       deleted after, free disk printed before.

    ``get_cfg(arch)`` gives the full-width config; a CPU rehearsal passes a
    reduced one, ``cli_args=("--reduced", "--device", "cpu")``, ``gloo`` and
    a short ``seq``.  Returns ``{path: launches}``."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import (participation_restore_hint, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core import prng
    from repro_torch.core.participation import ChurnEvent, ParticipationSpec
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_mod
    from repro_torch.models.transformer import count_params, init_model

    get_cfg = get_cfg or get_config
    t_phase = time.perf_counter()
    paths = {}
    scratch = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (1) the CLI's params-only save at full width
        free_b = shutil.disk_usage(scratch).free
        kept = {}
        cli_save = train_mod.save_checkpoint

        def timed_save(directory, step, tree, metadata=None):
            _sync(dev)
            t0 = time.perf_counter()
            path = cli_save(directory, step, tree, metadata=metadata)
            kept.update(tree=tree, seconds=time.perf_counter() - t0, path=path)
            return path
        train_mod.save_checkpoint = timed_save
        cli_dir = os.path.join(scratch, "cli")
        try:
            train_mod.main(["--arch", "llama3.2-1b", "--mesh", "1x1", "--steps", "1",
                            "--batch", "1", "--seq", str(seq), "--checkpoint-dir", cli_dir,
                            *cli_args])
        finally:
            train_mod.save_checkpoint = cli_save
        nbytes = os.path.getsize(kept["path"])
        cfg = get_cfg("llama3.2-1b")
        saved = kept["tree"]["params"]
        tmpl = init_model(cfg, dev, seed=1)
        _sync(dev)
        t0 = time.perf_counter()
        back, step = restore_checkpoint(cli_dir, {"params": tmpl})
        _sync(dev)
        t_restore = time.perf_counter() - t0
        same = step == 1 and all(_same_bits(back["params"][p], saved[p]) for p in saved)
        pbytes = _tree_bytes(saved)
        print(f"checkpoint: the CLI's params-only save (--checkpoint-dir) of llama3.2-1b "
              f"({cfg.n_layers} layers, {count_params(saved)} parameters, {pbytes} B of "
              f"{sorted({str(t.dtype) for t in saved.values()})}): {nbytes} B in "
              f"{kept['seconds']:.3f} s ({nbytes / kept['seconds'] / 1e9:.3f} GB/s; "
              f"{free_b} B free before); restored onto {dev.type} into a template of another "
              f"seed in {t_restore:.3f} s ({nbytes / t_restore / 1e9:.3f} GB/s), bitwise the "
              f"saved parameters: {same}")
        if not same:
            fail("checkpoint: the CLI's saved parameters did not restore bitwise")
        del kept, saved, tmpl, back
        shutil.rmtree(cli_dir)
        _reset_peak(dev)

        # (2) save-restore-step on the reduced model, through the kernels
        rcfg = replace(reduced(get_config("llama3.2-1b")), comp_k=4096)
        rshape = ShapeConfig("smoke", 64, 4, "train")
        rbatches = [{k: torch.from_numpy(v).to(dev) for k, v in
                     make_lm_batch(rcfg, rshape, s).items()} for s in range(4)]

        def steps(fn, params, state, start, stop):
            losses = []
            for s in range(start, stop):
                params, state, met = fn(params, state, rbatches[s],
                                        prng.fold_in(prng.PRNGKey(0), s))
                losses.append(met["loss"])
            return losses, params, state

        def resume(label, cfg_r, opt, build_fn, rows):
            d = os.path.join(scratch, "resume")
            build.reset_launches()
            params = init_model(cfg_r, dev, seed=3)
            _, params, state = steps(build_fn(), params, opt.init(params, rows), 0, 3)
            save_checkpoint(d, 3, {"params": params, "opt_state": state},
                            metadata={"policy": opt.policy.to_json_dict()})
            ref_loss, ref_params, ref_state = steps(build_fn(), params, state, 3, 4)
            tparams = init_model(cfg_r, dev, seed=11)
            tree, step = restore_checkpoint(d, {"params": tparams,
                                                "opt_state": opt.init(tparams, rows)})
            loss, params, state = steps(build_fn(), tree["params"], tree["opt_state"], 3, 4)
            counts = dict(build.LAUNCHES)
            same = (step == 3 and torch.equal(loss[0], ref_loss[0])
                    and _same_trees(params, ref_params) and _same_trees(state, ref_state)
                    and participation_restore_hint(d, opt.policy) is None)
            print(f"checkpoint: resume, reduced llama3.2-1b, {label}, n = {rows}: step 3's "
                  f"loss {float(loss[0])!r}, bitwise the uninterrupted step (loss, parameters, "
                  f"{len(_flat(state))} optimizer-state leaves): {same}; launches {counts}")
            if not same:
                fail(f"checkpoint: the {label} resume is not bitwise the uninterrupted run")
            shutil.rmtree(d)
            paths[f"checkpoint resume {label} (reduced, 5 steps)"] = counts

        churn = ParticipationSpec(q=0.7, dropout=0.1, min_workers=1,
                                  churn=(ChurnEvent(1, 1, "leave"), ChurnEvent(3, 1, "join")))
        variants = [(m, {"compression": m}, {}) for m in
                    ("diana", "natural", "randk", "topk_ef", "none")]
        variants += [(f"{m} --per-leaf-agg", {"compression": m, "comp_bucketed": False}, {})
                     for m in ("diana", "topk_ef")]
        variants += [("--comp-policy default", {}, {"policy": "default"}),
                     ("--vr --down-method diana", {"vr": True, "vr_p": 0.5,
                                                   "comp_down_method": "diana"}, {}),
                     ("--inner adamw", {}, {"inner": "adamw"}),
                     ("elastic, churn join at step 3", {}, {"participation": churn})]
        for label, over, kw in variants:
            c = replace(rcfg, **over)
            opt = train_mod.make_optimizer(c, **kw)
            resume(label, c, opt, lambda c=c, opt=opt: train_mod.build_train_step(c, opt, 2, dev),
                   2)
        own_group = not dist.is_initialized()
        if own_group:
            kw = {"device_id": dev} if backend == "nccl" else {}
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
        try:
            opt = train_mod.make_optimizer(rcfg)
            resume(f"world of one ({backend})", rcfg, opt,
                   lambda: train_mod.build_distributed_step(rcfg, opt), 1)
        finally:
            if own_group:
                dist.destroy_process_group()
        del rbatches
        _reset_peak(dev)

        # (3) one full-state resume at full width
        fcfg = replace(get_cfg("llama3.2-1b"), n_layers=full_layers)
        fshape = ShapeConfig("train_4k", seq, 1, "train")
        fbatches = [{k: torch.from_numpy(v).to(dev) for k, v in
                     make_lm_batch(fcfg, fshape, s).items()} for s in range(3)]
        opt = train_mod.make_optimizer(fcfg)
        params, state = train_mod.init_train_state(fcfg, opt, 1, dev, seed=0)
        fn = train_mod.build_train_step(fcfg, opt, 1, dev)
        for s in range(2):
            params, state, _ = fn(params, state, fbatches[s], prng.fold_in(prng.PRNGKey(0), s))
        d = os.path.join(scratch, "full")
        free_b = shutil.disk_usage(scratch).free
        _sync(dev)
        t0 = time.perf_counter()
        path = save_checkpoint(d, 2, {"params": params, "opt_state": state})
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        held = _tree_bytes(params) + _tree_bytes(state)
        params, state, met = fn(params, state, fbatches[2], prng.fold_in(prng.PRNGKey(0), 2))
        ref = (float(met["loss"]), params, state)
        tparams, tstate = train_mod.init_train_state(fcfg, opt, 1, dev, seed=5)
        _sync(dev)
        t0 = time.perf_counter()
        tree, step = restore_checkpoint(d, {"params": tparams, "opt_state": tstate})
        _sync(dev)
        t_restore = time.perf_counter() - t0
        del tparams, tstate
        fn = train_mod.build_train_step(fcfg, opt, 1, dev)
        params, state, met = fn(tree["params"], tree["opt_state"], fbatches[2],
                                prng.fold_in(prng.PRNGKey(0), 2))
        same = (step == 2 and float(met["loss"]) == ref[0] and _same_trees(params, ref[1])
                and _same_trees(state, ref[2]))
        print(f"checkpoint: full-state resume, llama3.2-1b at full width cut to {full_layers} "
              f"layer(s) ({count_params(params)} parameters), n = 1, diana: {free_b} B free on "
              f"disk before; save of parameters and optimizer state ({held} B on {dev.type}) "
              f"{nbytes} B in {t_save:.3f} s ({nbytes / t_save / 1e9:.3f} GB/s); restore "
              f"{t_restore:.3f} s ({nbytes / t_restore / 1e9:.3f} GB/s); step 2 from the "
              f"restore bitwise the uninterrupted step (loss {ref[0]!r}): {same}")
        if not same:
            fail("checkpoint: the full-width resume is not bitwise the uninterrupted run")
        del params, state, tree, ref, fbatches, fn
        _reset_peak(dev)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"checkpoint: the phase took {time.perf_counter() - t_phase:.1f} s")
    return paths


def helpers_phase(dev, card: str, get_cfg=None, comp_k=COMP_K, layers=LAYERS) -> dict:
    """The paper's tree helpers on the card: ``compress_tree`` /
    ``decompress_tree`` (``repro_torch.core.compression``) for the five
    operators on llama3.2-1b's full-width tree cut to ``layers`` layers
    (bf16 leaves of seeded normals): one encode kernel per leaf and one
    one-worker decode per leaf (``none`` decodes with a view), launches
    exact; every payload field and decoded leaf bitwise the same calls
    through the plain versions (each kernel at the per-leaf shapes); the
    ternary family's ``QuantizedBlocks``, and ``payload_nbits`` against
    ``bits_per_dim``.  Returns ``{path: launches}``."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.compression import CompressionConfig, compress_tree, decompress_tree
    from repro_torch.core.compressors.base import payload_nbits
    from repro_torch.kernels import build, ops
    from repro_torch.models.transformer import param_shapes

    get_cfg = get_cfg or get_config
    t_phase = time.perf_counter()
    cfg = replace(get_cfg("llama3.2-1b"), n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {p: torch.randn(s, generator=gen, device=dev).to(cfg.param_dtype)
            for p, s in param_shapes(cfg).items()}
    n_leaves, d = len(tree), sum(t.numel() for t in tree.values())
    key = prng.fold_in(prng.PRNGKey(0), 7)
    want = {
        "diana": {"quantize_pack_prng": n_leaves, "unpack_reduce": n_leaves},
        "natural": {"nat_pack_prng": n_leaves, "nat_decode_sum": n_leaves},
        "randk": {"threefry_bits": n_leaves, "sparse_gather": n_leaves,
                  "sparse_decode_sum": n_leaves},
        "topk_ef": {"sparse_gather": n_leaves, "sparse_decode_sum": n_leaves},
        "none": {"dense_copy": n_leaves},
    }
    paths = {}
    for method, expected in want.items():
        ccfg = CompressionConfig(method=method, block_size=cfg.comp_block, k=comp_k)
        runs = []
        for plain in (False, True):
            on_card = ops._on_card
            if plain:
                # the same calls, every kernel on a tensor -> its plain version; rand-k's
                # tags (threefry_bits, asked for by device) stay on the card, held to
                # their plain version below
                ops._on_card = lambda t: False if isinstance(t, torch.Tensor) else on_card(t)
            try:
                build.reset_launches()
                _sync(dev)
                t0 = time.perf_counter()
                pay, loc = compress_tree(tree, key, ccfg)
                _sync(dev)
                t1 = time.perf_counter()
                out = decompress_tree(pay, tree, ccfg)
                _sync(dev)
                runs.append((pay, loc, out, t1 - t0, time.perf_counter() - t1,
                             dict(build.LAUNCHES)))
            finally:
                ops._on_card = on_card
        (pay, loc, out, c_s, d_s, counts), (ppay, ploc, pout, pc_s, pd_s, _) = runs
        same = (_same_trees(pay, ppay) and _same_trees(out, pout) and _same_trees(loc, ploc)
                and all(out[p].dtype == tree[p].dtype and out[p].shape == tree[p].shape
                        for p in tree))
        nbits = sum(payload_nbits(pay[p]) for p in pay)
        print(f"helpers: compress_tree / decompress_tree {method} over {n_leaves} leaves "
              f"({d} coordinates, {cfg.param_dtype}): compress {c_s * 1e3:.1f} ms, decompress "
              f"{d_s * 1e3:.1f} ms with the kernels; {pc_s * 1e3:.1f} / {pd_s * 1e3:.1f} ms "
              f"through the plain versions; payloads, locals and decoded leaves bitwise the "
              f"plain versions': {same}; payload_nbits {nbits} ({nbits / d:.4f} bits per "
              f"coordinate in containers; the wire's bits_per_dim({d}) "
              f"{ccfg.make().bits_per_dim(d):.4f}); "
              f"launches {counts}")
        if not same:
            fail(f"helpers: {method}: the kernels' tree helpers differ from the plain versions")
        if counts != expected:
            fail(f"helpers: {method}: launches {counts}, expected {expected}")
        if method == "diana" and not all(set(loc[p].signs.unique().tolist()) <= {-1, 0, 1}
                                         for p in loc):
            fail("helpers: the ternary locals are not signs in {-1, 0, 1}")
        if method == "randk":
            # the tags at each leaf's shape: threefry_bits against its plain version
            keys = prng.split(key, n_leaves)
            tags = all(torch.equal(ops.bits_op(keys[i], (tree[p].numel(),), dev),
                                   prng.bits(keys[i], (tree[p].numel(),), device=dev))
                       for i, p in enumerate(sorted(tree, key=lambda q: tuple(q.split("/")))))
            print(f"helpers: randk's tags, threefry_bits at each leaf's size, bitwise the "
                  f"plain version: {tags}")
            if not tags:
                fail("helpers: threefry_bits at a leaf's size differs from its plain version")
        paths[f"helpers {method} ({layers} layers, per leaf)"] = counts
        del pay, loc, out, ppay, ploc, pout, runs
        _reset_peak(dev)
    del tree
    _reset_peak(dev)
    print(f"helpers: the phase took {time.perf_counter() - t_phase:.1f} s")
    return paths


# The products a remat="dots" block saves, per block of the reduced archs
# (tests/test_torch_remat.py: the no-batch dot_general outputs of the JAX
# block): llama q, k, v, o, w_in, w_gate, w_out; granite-moe q, k, v, o and
# the router; mamba2 in_proj, out_proj; jamba's eight layers
REMAT_SAVED = {"llama3.2-1b": 7, "granite-moe-3b-a800m": 5, "mamba2-130m": 2,
               "jamba-v0.1-52b": 34}


def remat_phase(dev, card: str, get_cfg=None, layers=LAYERS, batch=BATCH, seq=SEQ,
                workers=WORKERS) -> dict:
    """``remat="dots"`` on the card:

    1. which aten ops the selective checkpoint's policy sees in one block of
       each reduced family on this device, and which it saves (every
       ``aten.mm``; the batched einsums reach ``aten.bmm``): the saved count
       per block as on the CPU (:data:`REMAT_SAVED`);
    2. two ``diana`` steps of the slice (llama3.2-1b at full width cut to
       ``layers`` layers, ``batch`` x ``seq``, ``workers`` in turn) under
       ``remat="full"`` and then ``"dots"`` from the same initial state:
       losses, parameters, momentum and memories bitwise, each step's time
       and the peak printed side by side, launches exact per step.
    Returns ``{path: launches}``."""
    from collections import Counter

    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core import prng
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import build
    from repro_torch.launch.train import build_train_step, init_train_state, make_optimizer
    from repro_torch.models import transformer as T

    get_cfg = get_cfg or get_config
    t_phase = time.perf_counter()
    policy = T.dots_policy

    def audit(cfg, params, batch_):
        seen, saved = Counter(), []

        def counting(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                seen[str(op)] += 1
                if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
                    saved.append((args[-2].shape[0], args[-1].shape[1]))
            return decision
        T.dots_policy = counting
        try:
            T.train_loss(params, batch_, replace(cfg, remat="dots"))
        finally:
            T.dots_policy = policy
        prods = {k: v // cfg.n_blocks for k, v in seen.items() if "mm" in k}
        return prods, saved[:len(saved) // cfg.n_blocks]

    for arch, want in REMAT_SAVED.items():
        cfg = reduced(get_config(arch))
        params = T.init_model(cfg, dev, seed=1)
        seqlen = 128 if cfg.has_mamba() else 64
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             make_lm_batch(cfg, ShapeConfig("t", seqlen, 2, "train"), 0).items()}
        prods, saved = audit(cfg, params, b)
        print(f"remat: {arch} reduced, one block on {dev.type}: products seen {prods}; saved "
              f"{len(saved)} (rows, columns) {saved}")
        if len(saved) != want:
            fail(f"remat: {arch}: the dots policy saves {len(saved)} products per block, "
                 f"{want} on the CPU")
    paths = {}
    cfg = replace(get_cfg("llama3.2-1b"), n_layers=layers)
    shape = ShapeConfig("train_4k", seq, batch, "train")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(cfg, shape, s).items()}
               for s in range(2)]
    one = replace(cfg, n_layers=1)
    prods, saved = audit(one, T.init_model(one, dev, seed=0),
                         {k: v[:batch // workers] for k, v in batches[0].items()})
    print(f"remat: llama3.2-1b full width, one block of one worker's batch: products seen "
          f"{prods}; saved {len(saved)} {saved}")
    if len(saved) != REMAT_SAVED["llama3.2-1b"]:
        fail(f"remat: the full-width block saves {len(saved)} products")
    _reset_peak(dev)
    runs = {}
    alloc = (lambda: torch.cuda.memory_allocated()) if dev.type == "cuda" else (lambda: 0)
    for remat in ("full", "dots"):
        base = alloc()
        rcfg = replace(cfg, remat=remat)
        opt = make_optimizer(rcfg)
        params, state = init_train_state(rcfg, opt, workers, dev, seed=0)
        fn = build_train_step(rcfg, opt, workers, dev)
        _reset_peak(dev)
        held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        build.reset_launches()
        losses, times = [], []
        for s in range(2):
            gc.collect()
            _sync(dev)
            t0 = time.perf_counter()
            params, state, met = fn(params, state, batches[s], prng.fold_in(prng.PRNGKey(0), s))
            losses.append(float(met["loss"]))
            _sync(dev)
            times.append(time.perf_counter() - t0)
        counts, peak = dict(build.LAUNCHES), _peak(dev)
        want = {"quantize_pack_prng": 2 * workers, "unpack_reduce": 2 * workers,
                "unpack_reduce_apply": 2}
        print(f"remat: {remat}, llama3.2-1b {layers} layers, batch {batch} x seq {seq}, "
              f"{workers} workers, diana, 2 steps: losses {losses}; step times {times} s; "
              f"peak memory {peak} B (held before the steps {held} B, the steps' own "
              f"{peak - held} B); launches {counts}")
        if counts != want:
            fail(f"remat: {remat}: launches {counts}, expected {want}")
        if remat == "full":
            # kept on the host while the dots run holds the card
            runs[remat] = (losses, {k: v.to("cpu", copy=True) for k, v in _flat(
                {"params": params, "opt_state": state}).items() if isinstance(v, torch.Tensor)})
        else:
            runs[remat] = (losses, _flat({"params": params, "opt_state": state}))
        paths[f"remat {remat} (diana, {layers} layers)"] = counts
        del params, state, fn, met
        _reset_peak(dev)
        left = alloc() - base   # the full run keeps host copies only: nothing should stay
        if left and remat == "full":
            live = [o for o in gc.get_objects()
                    if isinstance(o, torch.Tensor) and o.device.type == "cuda"]
            live.sort(key=lambda o: o.numel() * o.element_size(), reverse=True)
            top = [(o.numel() * o.element_size(), tuple(o.shape), str(o.dtype))
                   for o in live[:4]]
            holders = [type(r).__name__ + (f" {sorted(map(str, r))[:4]}" if isinstance(r, dict)
                                           else "")
                       for r in gc.get_referrers(live[0]) if r is not live] if live else []
            del live
            print(f"remat: {remat}: {left} B still allocated after the run's tensors were "
                  f"dropped; the largest live tensors {top}, the largest held by {holders}")
    (f_loss, f_tree), (d_loss, d_tree) = runs["full"], runs["dots"]
    same = f_loss == d_loss and all(_same_bits(d_tree[k].to("cpu"), f_tree[k]) for k in f_tree)
    print(f"remat: dots bitwise full from the same state (losses, parameters, momentum, "
          f"h_worker, h_server: {len(f_tree)} tensors): {same}")
    if not same:
        fail("remat: the dots steps differ from the full steps")
    del runs, f_tree, d_tree, batches
    _reset_peak(dev)
    print(f"remat: the phase took {time.perf_counter() - t_phase:.1f} s")
    return paths


# ------------------------------------------------------------------ the model axis

MESH = "2x2"
MESH_LAYERS = 4    # mesh: llama3.2-1b's depth there (of 16)
# mesh: the MoE, frontend and Mamba-2 families at full width, cut in depth:
# (arch, layers, operator, global batch x 4096), as many steps as llama.
# phi3.5-moe's batch is cut to 4: at 8 its four ranks' attention chunks
# (2048 queries, f32 scores) ran the card out of memory (79.18 GiB in use).
# Layers None: the reduced config.  Jamba's shortest legal depth, one period
# of 8 layers, holds 4 MoE layers of 16 x 3 x 4096 x 14336 weights (22.6 GB
# in bf16): half of them and as much again in gradients on each of the four
# ranks is over 90 GB of the one card, so the hybrid runs reduced, and one
# full-width Jamba mixer is checked alone (_mamba_layer_check)
MESH_FAMILIES = (("granite-moe-3b-a800m", 4, "diana", 8),
                 ("phi3.5-moe-42b-a6.6b", 1, "natural", 4),
                 ("internvl2-2b", 2, "diana", 8), ("musicgen-large", 2, "none", 8),
                 ("mamba2-130m", 8, "diana", 8), ("jamba-v0.1-52b", None, "natural", 8))
MESH_TAGS = ("moe", "frontend", "mamba")   # the model code's tagged collectives (transport.STATS)
# the full-width Jamba mixer on a model group against the unsharded one:
# weights from MAMBA_LAYER_SEED, MAMBA_LAYER_ROWS sequences of the phase's
# length; the output and every gradient bitwise
MAMBA_LAYER_ARCH, MAMBA_LAYER_SEED, MAMBA_LAYER_ROWS = "jamba-v0.1-52b", 9, 2
# the full-width MoE layer on a model group against the unsharded one, at
# each of MOE_LAYER_SEEDS.  Bitwise (MOE_LAYER_BITWISE): every array of the
# expert partition (a rank runs whole experts; the all-gather and the
# replicated combine add what the unsharded layer adds, in its order), and
# the ffn partition's expert-weight gradients (a rank's columns of each
# expert's products).  Normwise within MOE_LAYER_TOL, the ffn partition's
# output and its input's and router's gradients: the halves' partial
# outputs round to bf16 before their all-reduce, and the dispatch
# gradient's halves add in another order, a few half-ulps of 2^-8 per
# element; 2^-6 leaves a margin of two over the largest reading (PERF.md)
MOE_LAYER_TOL, MOE_LAYER_SEEDS = 2.0 ** -6, (7, 8)
MOE_LAYER_BITWISE = {"expert": ("y", "x grad", "router grad", "w_in grad", "w_gate grad",
                                "w_out grad"),
                     "ffn": ("w_in grad", "w_gate grad", "w_out grad")}
# per leaf and rank, per step: the kernel launches of each operator's
# shard-local per-leaf round (the encode, the rank's own decode, the server's
# sum over the data group)
MESH_LAUNCHES = {"diana": {"quantize_pack_prng": 1, "unpack_reduce": 2},
                 "natural": {"nat_pack_prng": 1, "nat_decode_sum": 2},
                 "randk": {"threefry_bits": 1, "sparse_gather": 1, "sparse_decode_sum": 2},
                 "topk_ef": {"sparse_gather": 1, "sparse_decode_sum": 2}}


def _mesh_probe(dev) -> dict:
    """Whether the process group takes CUDA tensors for each collective of
    the mesh path: each is tried on small card tensors (bf16 and f32 sums,
    an f32 max, a uint8 gather) and its values checked, and every rank
    learns whether all ranks passed.  Returns ``{collective: passed on every
    rank}``; nothing falls back to the host."""
    if dev.type != "cuda":
        return {}
    rank, world = dist.get_rank(), dist.get_world_size()

    def reduce_ok():
        ok = True
        for dt, op, want in ((torch.bfloat16, dist.ReduceOp.SUM, world * (world + 1) / 2),
                             (torch.float32, dist.ReduceOp.SUM, world * (world + 1) / 2),
                             (torch.float32, dist.ReduceOp.MAX, world)):
            x = torch.full((8,), rank + 1.0, dtype=dt, device=dev)
            dist.all_reduce(x, op=op)
            ok &= bool((x.float() == want).all())
        return ok

    def gather_ok():
        x = torch.full((8,), rank, dtype=torch.uint8, device=dev)
        out = torch.empty((world * 8,), dtype=torch.uint8, device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool((out.view(world, 8).cpu() == torch.arange(world)[:, None]).all())

    took = {}
    for name, probe in (("all_reduce", reduce_ok), ("all_gather_into_tensor", gather_ok)):
        try:
            ok = probe()
        except Exception as e:  # noqa: BLE001 - the backend's refusal, reported
            ok = False
            print(f"mesh: rank {rank}: {name} on CUDA tensors: {type(e).__name__}: {e}")
        flag = torch.tensor([int(ok)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)     # the same verdict on every rank
        took[name] = bool(int(flag))
    return took


def _family_cfg(get_cfg, arch, layers):
    """A :data:`MESH_FAMILIES` entry's config: ``layers`` of the full one,
    or the reduced one when ``layers`` is None."""
    from repro_torch.configs import reduced

    return reduced(get_cfg(arch)) if layers is None else replace(get_cfg(arch), n_layers=layers)


def _mamba_gathers(cfg) -> dict:
    """The ``mamba`` collectives of one training step of ``cfg`` on a model
    group: each Mamba-2 layer gathers its whole ``in_proj``, ``conv_w`` and
    ``out_proj`` in the forward, and again in a checkpointed block's
    recompute; nothing in the backward."""
    from repro_torch.models.mamba2 import SPLIT, mamba_shapes

    layers = sum(spec.mixer == "mamba" for spec in cfg.pattern) * cfg.n_blocks
    if not layers:
        return {}
    forwards = 2 if cfg.remat == "full" else 1
    nbytes = sum(math.prod(mamba_shapes(cfg)[k][0]) for k in SPLIT) * \
        torch.empty((), dtype=cfg.param_dtype).element_size()
    return {"mamba calls": 3 * layers * forwards, "mamba bytes": nbytes * layers * forwards}


def _mamba_layer_check(dev, cfg, groups, rows, seq, seed) -> dict:
    """One full-width Mamba-2 mixer of ``cfg`` on this rank's model group
    against the unsharded mixer on the same card: the same weights drawn
    from ``seed`` (the rank's shards of ``in_proj``, ``conv_w`` and
    ``out_proj``), ``rows`` x ``seq`` input rows, ``sum(out * probe)``
    backward.  Returns, for the output, the input's gradient and every
    leaf's gradient (the split ones gathered), the normwise relative
    difference and whether the bits are equal, and the collectives tagged
    ``mamba``."""
    from repro_torch.core import transport
    from repro_torch.launch.sharding_rules import gather_leaf, param_specs, shard_leaf
    from repro_torch.models.mamba2 import dims, mamba_layer, mamba_shapes
    from repro_torch.models.sharding import model_parallel

    _, d_in, h, _, _, _ = dims(cfg)
    d = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = {"in_proj": d ** -0.5, "out_proj": d_in ** -0.5, "conv_w": 0.5, "conv_b": 0.1,
             "dt_bias": 0.5, "A_log": 0.5, "D": 1.0, "norm_scale": 0.1}
    full = {}
    for k, (shape, f32) in mamba_shapes(cfg).items():
        x = torch.randn(shape, generator=gen, device=dev) * scale[k]
        if k == "A_log":
            x = x + torch.log(torch.linspace(1.0, 16.0, h, device=dev))
        elif k == "norm_scale":
            x = x + 1.0
        full[k] = x.to(torch.float32 if f32 else cfg.param_dtype)
    x = torch.randn((rows, seq, d), generator=gen, device=dev).to(cfg.compute_dtype)
    probe = torch.randn((rows, seq, d), generator=gen, device=dev)
    specs = param_specs({f"mixer/{k}": v for k, v in full.items()}, cfg, groups.model.size)
    specs = {k: specs[f"mixer/{k}"] for k in full}

    def layer(params):
        xg = x.detach().requires_grad_()
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y = mamba_layer(leaves, xg, cfg)
        grads = torch.autograd.grad(torch.sum(y.float() * probe), [xg, *leaves.values()])
        return y.detach(), grads[0], dict(zip(leaves, grads[1:]))

    def rel(a, b):
        a, b = a.double(), b.double()
        return math.sqrt(float(torch.sum((a - b) ** 2)) / max(float(torch.sum(b ** 2)), 1e-300))

    out, same = {}, {}

    def compare(name, a, b):
        out[name], same[name] = rel(a, b), bool(torch.equal(a, b))

    local = {k: shard_leaf(v, specs[k], groups.model.size, groups.shard) for k, v in full.items()}
    before = dict(transport.STATS)
    with model_parallel(groups.model):
        y, gx, gp = layer(local)
    tagged = {f"{k[0]} {k[1]}": v - before.get(k, 0) for k, v in transport.STATS.items()
              if k[0] == "mamba" and v != before.get(k, 0)}
    whole = sum(full[k].numel() * full[k].element_size() for k, sp in specs.items()
                if sp is not None)
    del local
    y1, gx1, gp1 = layer(full)
    compare("y", y, y1)
    compare("x grad", gx, gx1)
    for k in full:
        compare(f"{k} grad", gather_leaf(gp.pop(k), specs[k], groups.model), gp1.pop(k))
    return {"rel": out, "same": same, "tagged": tagged, "whole_bytes": whole,
            "specs": specs, "rows": [rows, seq]}


def _moe_layer_check(dev, cfg, groups, tokens, seed) -> dict:
    """One full-width MoE layer of ``cfg`` on this rank's model group
    against the unsharded layer on the same card: the same weights drawn
    from ``seed`` (the rank's shards of them) and ``tokens`` input rows,
    ``sum(out * probe) + aux`` backward.  Returns, for the output, the
    input's and the router's gradients and the experts' gradients
    (gathered), the normwise relative difference and whether the bits are
    equal, and the collectives tagged ``moe``."""
    from repro_torch.core import transport
    from repro_torch.launch.sharding_rules import gather_leaf, param_specs, shard_leaf
    from repro_torch.models.moe import moe_layer
    from repro_torch.models.sharding import model_parallel

    mc, d = cfg.moe, cfg.d_model
    e, f = mc.n_experts, mc.d_ff
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"router": ((d, e), torch.float32, d ** -0.5),
              "w_in": ((e, d, f), cfg.param_dtype, d ** -0.5),
              "w_gate": ((e, d, f), cfg.param_dtype, d ** -0.5),
              "w_out": ((e, f, d), cfg.param_dtype, f ** -0.5)}
    full = {k: (torch.randn(s, generator=gen, device=dev) * sc).to(dt)
            for k, (s, dt, sc) in shapes.items()}
    x = torch.randn((1, tokens, d), generator=gen, device=dev).to(cfg.compute_dtype)
    probe = torch.randn((1, tokens, d), generator=gen, device=dev)
    specs = param_specs({f"mlp/{k}": v for k, v in full.items()}, cfg, groups.model.size)
    specs = {k: specs[f"mlp/{k}"] for k in full}

    def layer(params):
        xg = x.detach().requires_grad_()
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y, aux = moe_layer(leaves, xg, cfg)
        grads = torch.autograd.grad(torch.sum(y.float() * probe) + aux, [xg, *leaves.values()])
        return y.detach(), grads[0], dict(zip(leaves, grads[1:]))

    def rel(a, b):
        """||a - b|| / ||b|| in float64; an expert leaf one expert at a time
        (a full-width one in float64 is 3.4 GB)."""
        num = den = 0.0
        for ai, bi in (zip(a, b) if a.dim() == 3 else [(a, b)]):
            ai, bi = ai.double(), bi.double()
            num += float(torch.sum((ai - bi) ** 2))
            den += float(torch.sum(bi ** 2))
        return math.sqrt(num / max(den, 1e-300))

    out, same = {}, {}

    def compare(name, a, b):
        out[name], same[name] = rel(a, b), bool(torch.equal(a, b))

    local = {k: shard_leaf(v, specs[k], groups.model.size, groups.shard) for k, v in full.items()}
    before = dict(transport.STATS)
    with model_parallel(groups.model):
        y, gx, gp = layer(local)
    tagged = {f"{k[0]} {k[1]}": v - before.get(k, 0) for k, v in transport.STATS.items()
              if k[0] == "moe" and v != before.get(k, 0)}
    del local
    y1, gx1, gp1 = layer(full)
    compare("y", y, y1)
    compare("x grad", gx, gx1)
    for k in full:
        whole = gather_leaf(gp.pop(k), specs[k], groups.model)
        compare(f"{k} grad", whole, gp1.pop(k))
        del whole
    return {"rel": out, "same": same, "tagged": tagged, "specs": specs, "tokens": tokens}


def _mesh_rank(rank, tmp, world, dev_type, get_cfg, layers, batch, seq, steps, prepare):
    """One rank of the ``mesh:`` phase (see :func:`mesh_phase`); writes its
    readings to ``tmp/rank{rank}.json`` and its ``none`` shards to
    ``tmp/none{rank}.pt``."""
    import datetime
    import warnings

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core import prng, transport
    from repro_torch.core.diana import aggregate_distributed, init_state
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import mesh_groups, parse_mesh
    from repro_torch.launch.sharding_rules import param_specs
    from repro_torch.models.transformer import meta_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    if prepare is not None:
        prepare()
    get_cfg = get_cfg or get_config
    res = {"rank": rank, "probe": _mesh_probe(dev)}
    if not all(res["probe"].values()):
        raise RuntimeError(f"mesh: gloo does not take CUDA tensors for {res['probe']}")
    if dev.type == "cuda":
        build.library()            # built by the parent: loaded, never compiled here
    mesh = parse_mesh(MESH)
    groups = mesh_groups(mesh)
    res["coords"] = [groups.worker, groups.shard]
    cfg = replace(get_cfg("llama3.2-1b"), n_layers=layers)
    specs = param_specs(meta_params(cfg), cfg, mesh.model)
    shape = ShapeConfig("train_4k", seq, batch, "train")

    def batches_of(c, n, shp=shape):
        return [{k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(c, shp, s).items()}
                for s in range(n)]
    orig_round = train_mod.aggregate_distributed

    def allocated():
        return torch.cuda.memory_allocated() if dev.type == "cuda" else 0

    def run(mcfg, bs, record=None):
        """``len(bs)`` steps of ``mcfg`` at full width on the mesh: losses,
        step times, peak, launches, the card's allocation before the run
        and after its state is made, and per step the round's time and the
        collectives inside and outside it (the model's tagged ones apart)."""
        left = allocated()
        opt = train_mod.make_optimizer(mcfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            opt = train_mod.resolve_bucketed(opt, mesh)
        params, state = train_mod.init_train_state(mcfg, opt, 1, dev, seed=0, model=mesh.model,
                                                   shard=groups.shard)
        step_fn = train_mod.build_distributed_step(mcfg, opt, mesh=mesh)
        held = allocated()
        rounds = []

        def timed_round(grads, st, key, c, **kw):
            if record is not None and not rounds:
                record.update(grads={p: g.to("cpu", copy=True) for p, g in grads.items()},
                              key=key.to("cpu", copy=True))
            _sync(dev)
            before, t0 = dict(transport.STATS), time.perf_counter()
            out = orig_round(grads, st, key, c, **kw)
            _sync(dev)
            rounds.append({"ms": (time.perf_counter() - t0) * 1e3,
                           "stats": {f"{k[0]} {k[1]}": v - before.get(k, 0)
                                     for k, v in transport.STATS.items()
                                     if v != before.get(k, 0)}})
            if record is not None and len(rounds) == 1:
                record.update(ghat={p: g.to("cpu", copy=True) for p, g in out[0].items()},
                              hw={p: h.to("cpu", copy=True) for p, h in out[1].h_worker.items()},
                              hs={p: h.to("cpu", copy=True) for p, h in out[1].h_server.items()})
            return out
        train_mod.aggregate_distributed = timed_round
        _reset_peak(dev)
        build.reset_launches()
        losses, times, outside, tagged = [], [], [], []
        try:
            for s, b in enumerate(bs):
                gc.collect()
                _sync(dev)
                before, t0 = dict(transport.STATS), time.perf_counter()
                params, state, met = step_fn(params, state, b,
                                             prng.fold_in(prng.PRNGKey(0), s))
                losses.append(float(met["loss"]))
                _sync(dev)
                times.append(time.perf_counter() - t0)
                diff = {k: v - before.get(k, 0) for k, v in transport.STATS.items()}
                outside.append({f"{k[0]} {k[1]}": v - rounds[s]["stats"].get(
                    f"{k[0]} {k[1]}", 0) for k, v in diff.items() if k[0] not in MESH_TAGS})
                tagged.append({f"{k[0]} {k[1]}": v for k, v in diff.items()
                               if k[0] in MESH_TAGS and v})
        finally:
            train_mod.aggregate_distributed = orig_round
        out = {"losses": losses, "times": times, "peak": _peak(dev), "left": left,
               "held": held - left, "launches": dict(build.LAUNCHES), "rounds": rounds,
               "outside": outside, "tagged": tagged,
               "local_params": sum(p.numel() for p in params.values()),
               "leaves": len(params), "warnings": [str(w.message) for w in caught]}
        return out, params, state

    def replicated_same(tree, leaf_specs):
        """Each replicated leaf's bits equal on every rank of the model group."""
        ok = True
        for p, x in tree.items():
            if leaf_specs.get(p, 0) is None:
                parts = transport.all_gather_bytes(x.detach(), mesh.model, groups.model.group)
                ok &= all(torch.equal(parts[0], parts[i]) for i in range(1, mesh.model))
        return ok

    def state_replicated(params, state, leaf_specs):
        return bool(replicated_same(params, leaf_specs)
                    and replicated_same(state.inner, leaf_specs)
                    and replicated_same(state.diana.h_worker, leaf_specs)
                    and replicated_same(state.diana.h_server, leaf_specs))

    def replay_plain(rec, mcfg):
        """Step 0's round again on the same shards with every kernel swapped
        for its plain version, one data group at a time (its ranks gather
        together): bitwise the recorded round, and no launch."""
        dcfg = train_mod.make_optimizer(replace(mcfg, comp_bucketed=False))
        plain = None
        for s in range(mesh.model):
            dist.barrier()
            if groups.shard != s:
                continue
            grads = {p: g.to(dev) for p, g in rec["grads"].items()}
            st0 = init_state(grads, dcfg.policy, 1)
            on_card = ops._on_card
            ops._on_card = lambda t: False
            build.reset_launches()
            try:
                ghat, new = aggregate_distributed(grads, st0, rec["key"].to(dev), dcfg.policy,
                                                  group=groups.data)
            finally:
                ops._on_card = on_card
            plain = (all(_same_bits(ghat[p].cpu(), rec["ghat"][p]) for p in ghat)
                     and all(_same_bits(new.h_worker[p].cpu(), rec["hw"][p])
                             for p in new.h_worker)
                     and all(_same_bits(new.h_server[p].cpu(), rec["hs"][p])
                             for p in new.h_server)
                     and not build.LAUNCHES)
            del grads, st0, ghat, new
            _reset_peak(dev)    # free the cache before the other data group replays
        dist.barrier()
        return bool(plain)

    rec = {}
    res["diana"], params, state = run(replace(cfg, compression="diana"),
                                      batches_of(cfg, steps), record=rec)
    res["diana"]["replicated_bitwise"] = state_replicated(params, state, specs)
    del params, state
    _reset_peak(dev)
    res["diana"]["round_plain_bitwise"] = replay_plain(rec, replace(cfg, compression="diana"))
    del rec
    _reset_peak(dev)
    res["none"], params, state = run(replace(cfg, compression="none"), batches_of(cfg, steps))
    torch.save({"params": {p: v.detach().to("cpu", copy=True) for p, v in params.items()},
                "momentum": {p: v.to("cpu", copy=True) for p, v in state.inner.items()}},
               tmp / f"none{rank}.pt")
    del params, state
    _reset_peak(dev)

    # the MoE and frontend families at full width, cut in depth, each with
    # its operator
    res["families"] = {}
    for arch, flayers, method, fbatch in MESH_FAMILIES:
        t0 = time.perf_counter()
        free = torch.cuda.mem_get_info()[0] if dev.type == "cuda" else 0
        fcfg = replace(_family_cfg(get_cfg, arch, flayers), compression=method)
        fspecs = param_specs(meta_params(fcfg), fcfg, mesh.model)
        fshape = ShapeConfig("train_4k", seq, fbatch * batch // BATCH, "train")
        rec = {}
        r, params, state = run(fcfg, batches_of(fcfg, steps, fshape), record=rec)
        r["replicated_bitwise"] = state_replicated(params, state, fspecs)
        r["replicated"] = sorted(p for p, sp in fspecs.items() if sp is None)
        del params, state
        _reset_peak(dev)
        r["round_plain_bitwise"] = replay_plain(rec, fcfg)
        del rec
        _reset_peak(dev)
        r["seconds"] = time.perf_counter() - t0
        res["families"][arch] = r
        if rank == 0:      # progress, before the parent's lines: a later failure keeps it
            print(f"mesh: rank 0 ran {arch}: step times {r['times']} s, peak {r['peak']} B "
                  f"(the card had {free} B free before it), {r['seconds']:.1f} s", flush=True)

    # one full-width MoE layer of each partition against the unsharded layer
    res["moe_layer"] = {}
    for arch, flayers, _, fbatch in MESH_FAMILIES:
        fcfg = get_cfg(arch)
        for seed in MOE_LAYER_SEEDS if fcfg.moe is not None and flayers is not None else ():
            # the worker's tokens of the run above
            c = _moe_layer_check(dev, fcfg, groups,
                                 fbatch * batch // BATCH // mesh.n_workers * seq, seed)
            res["moe_layer"][f"{arch} seed {seed}"] = dict(c, partition=fcfg.moe.partition)
            _reset_peak(dev)

    # one full-width Jamba mixer against the unsharded mixer, one worker's
    # model group at a time (the other's ranks wait: two ranks' float64
    # segment sums and f32 SSD products at a time)
    for w in range(mesh.n_workers):
        dist.barrier()
        if groups.worker == w:
            res["mamba_layer"] = _mamba_layer_check(dev, get_cfg(MAMBA_LAYER_ARCH), groups,
                                                    MAMBA_LAYER_ROWS, seq, MAMBA_LAYER_SEED)
            _reset_peak(dev)
    dist.barrier()

    # every compressing operator on the reduced model over the mesh: 2 steps
    # through the kernels, then through the plain versions, bitwise
    rcfg = reduced(get_config("llama3.2-1b"))
    rshape = ShapeConfig("smoke", 64, 4, "train")
    rbatches = [{k: torch.from_numpy(v).to(dev) for k, v in
                 make_lm_batch(rcfg, rshape, s).items()} for s in range(2)]
    res["reduced"] = {}
    for method in MESH_LAUNCHES:
        mcfg = replace(rcfg, compression=method, comp_bucketed=False)

        def two_steps():
            opt = train_mod.make_optimizer(mcfg)
            p, st = train_mod.init_train_state(mcfg, opt, 1, dev, seed=3, model=mesh.model,
                                               shard=groups.shard)
            fn = train_mod.build_distributed_step(mcfg, opt, mesh=mesh)
            ls = []
            for s, b in enumerate(rbatches):
                p, st, met = fn(p, st, b, prng.fold_in(prng.PRNGKey(0), s))
                ls.append(float(met["loss"]))
            return ls, p, st
        build.reset_launches()
        k_loss, k_p, k_st = two_steps()
        counts = dict(build.LAUNCHES)
        on_card = ops._on_card
        ops._on_card = lambda t: False
        try:
            p_loss, p_p, p_st = two_steps()
        finally:
            ops._on_card = on_card
        same = (k_loss == p_loss and all(_same_bits(k_p[x], p_p[x]) for x in k_p)
                and _same_trees(k_st, p_st))
        res["reduced"][method] = {"losses": k_loss, "bitwise": bool(same), "launches": counts,
                                  "leaves": len(k_p)}
    res["leaves"] = len(specs)
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def mesh_phase(dev, card: str, get_cfg=None, layers=MESH_LAYERS, batch=BATCH, seq=SEQ,
               steps=MESH_STEPS, world=4, prepare=None, tol=1e-2, mtol=2.0 ** -5) -> dict:
    """The model axis on the card: ``--mesh 2x2`` (2 DIANA workers x 2
    model shards) as ``world`` = 4 processes sharing the one card, each one
    rank over gloo (NCCL runs one rank per GPU), llama3.2-1b at full width
    cut to ``layers`` layers, ``batch`` x ``seq`` global (``batch / 2`` rows
    per worker):

    1. the parent builds the kernels (no child runs nvcc), frees its card
       memory and prints what it still holds, then spawns the ranks;
    2. each rank checks that gloo takes CUDA tensors for the collectives of
       the path (:func:`_mesh_probe`; it does on the H100 machine, so no
       collective crosses the host);
    3. ``steps`` steps of ``diana`` (bucketed asked, downgraded per leaf by
       ``resolve_bucketed``: its warning printed) and of ``none``: per rank
       the step times, the peak, the round's time and collectives, the
       tensor-parallel collectives outside it, launches exact per rank (per
       leaf: :data:`MESH_LAUNCHES`; ``none`` none);
    4. the replicated leaves (parameters, momentum, memories) bitwise equal
       across each worker's model ranks; step 0's round, replayed on the
       same shards with every kernel swapped for its plain version, bitwise;
    5. the MoE, frontend and Mamba-2 families (:data:`MESH_FAMILIES`:
       granite-moe at 4 layers with ``diana``, the ``ffn`` partition;
       phi3.5-moe at 1 layer with ``natural``, the ``expert`` partition and
       bf16 memories; internvl2-2b at 2 layers with ``diana``;
       musicgen-large at 2 layers with ``none``; mamba2-130m at 8 layers
       with ``diana``; all at full width; the Jamba hybrid reduced, its 8
       layers with ``natural`` and bf16 memories), ``steps`` steps each, on
       ``batch`` x ``seq`` but phi3.5-moe on half the batch:
       per rank the step times, the peak, the card's allocation left before
       the run and held by its state (beside the reckoning: the rank's
       parameters times their bytes, 4 for the f32 momentum and the two
       memories, which ``none`` holds too),
       the round's time and collectives, the MoE's, the frontend's and the
       Mamba-2 mixers' tagged collectives (the last exact:
       :func:`_mamba_gathers`), launches exact; the replicated leaves (the
       router, the norm scales, ``frontend_proj/b``, the SSD scalars,
       ``conv_b``, and their momentum and memories)
       bitwise across each worker's model ranks; step 0's round replayed
       through the plain versions bitwise;
    6. one full-width MoE layer of each partition on each model group (the
       worker's tokens, weights from each of :data:`MOE_LAYER_SEEDS`)
       against the unsharded layer on the same card: the output and the
       input's, the router's and the experts' (gathered) gradients, bitwise
       where :data:`MOE_LAYER_BITWISE` says, the others within
       :data:`MOE_LAYER_TOL` (2^-6) normwise; and one full-width Jamba
       Mamba-2 mixer on each model group in turn (:func:`_mamba_layer_check`,
       :data:`MAMBA_LAYER_ROWS` x ``seq`` rows) against the unsharded mixer:
       the output and every gradient bitwise, three gathers of the whole
       split leaves;
    7. every compressing operator on the reduced model over the same mesh, 2
       steps through the kernels bitwise through the plain versions,
       launches exact;
    8. the ``none`` run against the in-turn trainer (``build_train_step``) at
       n = 2 on the card from the same weights and batches, after the ranks
       exit: the losses within ``tol`` (1e-2) relative, each leaf's
       parameters within ``tol / 10`` normwise, and each leaf's f32 momentum
       (the applied directions summed) within ``mtol`` normwise, 2^-5 = 8
       bf16 epsilons: the tensor-parallel sums round in another order in
       bf16, through the layers' backward (the embedding's momentum, the
       farthest, read ~2.2e-2 at 8 layers on an H100).

    Returns ``{path: launches}`` (rank 0's; every rank's are checked)."""
    import shutil
    import tempfile

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import prng
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import build
    from repro_torch.launch.sharding_rules import param_specs, shard_leaf
    from repro_torch.launch.train import build_train_step, init_train_state, make_optimizer

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        build.library()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"mesh: the parent holds {torch.cuda.memory_reserved()} B reserved "
              f"({torch.cuda.memory_allocated()} B allocated) at the spawn; the card has {free} "
              f"B free of {total}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    # four ranks share the card: each one's allocator grows its segments in
    # place rather than holding fragments the others need
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            _mesh_rank, args=(tmp, world, dev.type, get_cfg, layers, batch, seq, steps, prepare),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + 900
        try:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    fail("mesh: the ranks did not finish in 900 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        t_ranks = time.perf_counter() - t0
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        res = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(world)]
        r0 = res[0]
        print(f"mesh: --mesh {MESH} = 2 workers x 2 model shards, {world} processes on one "
              f"{dev.type} device over gloo; llama3.2-1b {layers} layers, batch {batch} x seq "
              f"{seq}; the ranks ran {t_ranks:.1f} s (spawn included)")
        print(f"mesh: gloo takes CUDA tensors for (probed with their values): {r0['probe']}; "
              f"no collective crosses the host")
        print(f"mesh: {r0['diana']['warnings'][0] if r0['diana']['warnings'] else 'no warning'}")
        for method in ("diana", "none"):
            for r in res:
                m = r[method]
                tp = {k: v for k, v in m["outside"][-1].items() if v}
                rd = m["rounds"][-1]
                print(f"mesh: {method} rank {r['rank']} (worker, shard) {tuple(r['coords'])}: "
                      f"losses {m['losses']}; step times {m['times']} s; peak {m['peak']} B "
                      f"(held before the steps {m['held']} B); the round {rd['ms']:.1f} ms, "
                      f"its collectives {rd['stats']}; outside it (tensor-parallel, loss, "
                      f"norm) per step {tp}; launches {m['launches']}")
        leaves = r0["leaves"]
        want = {k: v * leaves * steps for k, v in MESH_LAUNCHES["diana"].items()}
        for r in res:
            if r["diana"]["launches"] != want or r["none"]["launches"]:
                fail(f"mesh: rank {r['rank']} launches {r['diana']['launches']} (diana, "
                     f"expected {want}), {r['none']['launches']} (none, expected none)")
            if len(r["diana"]["warnings"]) != 1:
                fail(f"mesh: rank {r['rank']}: expected one downgrade warning, got "
                     f"{r['diana']['warnings']}")
        rep = [r["diana"]["replicated_bitwise"] for r in res]
        plain = [r["diana"]["round_plain_bitwise"] for r in res]
        print(f"mesh: replicated leaves (parameters, momentum, h_worker, h_server) bitwise "
              f"across each worker's model ranks: {rep}; step 0's round through the kernels "
              f"bitwise its plain version on the same shards, per rank: {plain}")
        if not all(rep) or not all(plain):
            fail("mesh: replicated leaves differ across model ranks, or a round through the "
                 "kernels differs from its plain version")
        get = get_cfg or get_config
        for arch, flayers, method, fbatch in MESH_FAMILIES:
            fcfg = _family_cfg(get, arch, flayers)
            depth = ("reduced" if flayers is None else
                     f"{flayers} of {get(arch).n_layers} layers, full width")
            # every operator's state holds h_worker and h_server (none's stay zero)
            mem = 2 * torch.empty((), dtype=fcfg.h_dtype).element_size()
            pbytes = torch.empty((), dtype=fcfg.param_dtype).element_size()
            for r in res:
                m = r["families"][arch]
                rd = m["rounds"][-1]
                tp = {k: v for k, v in m["outside"][-1].items() if v}
                reckon = m["local_params"] * (pbytes + 4 + mem)
                print(f"mesh: {arch} ({depth}, "
                      f"{method}, batch {fbatch * batch // BATCH} x seq {seq}) rank {r['rank']} "
                      f"(worker, shard) {tuple(r['coords'])}: losses "
                      f"{m['losses']}; step times {m['times']} s; peak {m['peak']} B; allocated "
                      f"before the run {m['left']} B, held by its state {m['held']} B (reckoned "
                      f"{reckon} B: {m['local_params']} parameters x ({pbytes} + 4 momentum + "
                      f"{mem} memories)); the round {rd['ms']:.1f} ms, its collectives "
                      f"{rd['stats']}; the model's tagged collectives per step {m['tagged']}; "
                      f"outside the round per step (tensor-parallel, loss, norm) {tp}; launches "
                      f"{m['launches']}; replicated leaves bitwise across the model ranks "
                      f"{m['replicated_bitwise']} ({len(m['replicated'])} leaves); step 0's round "
                      f"bitwise its plain replay {m['round_plain_bitwise']}; {m['seconds']:.1f} s")
                want = {k: v * m["leaves"] * steps
                        for k, v in MESH_LAUNCHES.get(method, {}).items()}
                if m["launches"] != want:
                    fail(f"mesh: {arch} rank {r['rank']} launches {m['launches']}, expected "
                         f"{want}")
                if not (m["replicated_bitwise"] and m["round_plain_bitwise"]):
                    fail(f"mesh: {arch} rank {r['rank']}: replicated leaves differ across model "
                         f"ranks, or step 0's round differs from its plain replay")
                if len(m["warnings"]) != 1 or not all(math.isfinite(x) for x in m["losses"]):
                    fail(f"mesh: {arch} rank {r['rank']}: warnings {m['warnings']}, losses "
                         f"{m['losses']}")
                if fcfg.moe is not None and not all(t.get("moe calls") for t in m["tagged"]):
                    fail(f"mesh: {arch} rank {r['rank']}: no MoE collective in a step")
                if fcfg.frontend != "none" and not all(t.get("frontend calls")
                                                       for t in m["tagged"]):
                    fail(f"mesh: {arch} rank {r['rank']}: no frontend collective in a step")
                gathers = _mamba_gathers(fcfg)
                if any({k: v for k, v in t.items() if k.startswith("mamba")} != gathers
                       for t in m["tagged"]):
                    fail(f"mesh: {arch} rank {r['rank']}: the Mamba-2 collectives per step "
                         f"{m['tagged']}, expected {gathers}")
        for case in res[0]["moe_layer"]:
            for r in res:
                c = r["moe_layer"][case]
                bitwise = MOE_LAYER_BITWISE[c["partition"]]
                print(f"mesh: one full-width {case} MoE layer ({c['partition']} partition, "
                      f"{c['tokens']} tokens, shards {c['specs']}) on rank {r['rank']}'s model "
                      f"group against the unsharded layer on the card: normwise relative "
                      f"differences {c['rel']}; bitwise {c['same']} (required of {bitwise}, "
                      f"the others within {MOE_LAYER_TOL}); its tagged collectives "
                      f"{c['tagged']}")
                if not (all(c["same"][k] for k in bitwise)
                        and all(v <= MOE_LAYER_TOL for v in c["rel"].values())):
                    fail(f"mesh: the {case} MoE layer on a model group differs from the "
                         f"unsharded layer: {c['rel']}, bitwise {c['same']}")
        for r in res:
            c = r["mamba_layer"]
            want = {"mamba calls": 3, "mamba bytes": c["whole_bytes"]}
            print(f"mesh: one full-width {MAMBA_LAYER_ARCH} Mamba-2 mixer ({c['rows'][0]} x "
                  f"{c['rows'][1]} rows, shards {c['specs']}) on rank {r['rank']}'s model group "
                  f"against the unsharded mixer on the card: normwise relative differences "
                  f"{c['rel']}; bitwise {c['same']}; its tagged collectives {c['tagged']} "
                  f"(expected {want})")
            if not all(c["same"].values()) or c["tagged"] != want:
                fail(f"mesh: the Jamba mixer on a model group differs from the unsharded mixer "
                     f"or from its gathers: {c['rel']}, bitwise {c['same']}, {c['tagged']}")
        for method, per in MESH_LAUNCHES.items():
            rows = [r["reduced"][method] for r in res]
            wl = {k: v * rows[0]["leaves"] * 2 for k, v in per.items()}
            print(f"mesh: reduced llama3.2-1b, {method}, 2 steps on the mesh: losses "
                  f"{rows[0]['losses']}; through the kernels bitwise the plain versions per "
                  f"rank {[x['bitwise'] for x in rows]}; launches per rank "
                  f"{[x['launches'] for x in rows]}")
            if not all(x["bitwise"] for x in rows) or any(x["launches"] != wl for x in rows):
                fail(f"mesh: reduced {method}: kernels differ from the plain versions, or "
                     f"launches differ from {wl}")
        # the none run against the in-turn trainer at n = 2 on this device
        cfg = replace(get("llama3.2-1b"), n_layers=layers, compression="none")
        shape = ShapeConfig("train_4k", seq, batch, "train")
        opt = make_optimizer(cfg)
        params, state = init_train_state(cfg, opt, 2, dev, seed=0)
        step_fn = build_train_step(cfg, opt, 2, dev)
        losses = []
        for s in range(steps):
            b = {k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(cfg, shape, s).items()}
            params, state, met = step_fn(params, state, b, prng.fold_in(prng.PRNGKey(0), s))
            losses.append(float(met["loss"]))
        specs = param_specs(params, cfg, 2)
        worst = {"params": {}, "momentum": {}}
        differ, total = 0, 0
        for r in range(world):
            m = res[r]["coords"][1]
            mine = torch.load(Path(tmp, f"none{r}.pt"))
            for name, ref_tree in (("params", params), ("momentum", state.inner)):
                for p, v in mine[name].items():     # compared on the device, in float64
                    ref_ = shard_leaf(ref_tree[p].detach(), specs[p], 2, m).double()
                    v = v.to(dev).double()
                    d = float((v - ref_).norm() / ref_.norm().clamp(min=1e-30))
                    worst[name][p] = max(worst[name].get(p, 0.0), d)
                    if name == "params":
                        differ += int((v != ref_).sum())
                        total += v.numel()
                    del v, ref_
        del params, state
        _reset_peak(dev)
        rel = max(abs(a - b) / abs(b) for a, b in zip(res[0]["none"]["losses"], losses))
        mom = {p: f"{d:.3e}" for p, d in worst["momentum"].items()}
        wm, wp = max(worst["momentum"].values()), max(worst["params"].values())
        print(f"mesh: none against build_train_step at n = 2 from the same weights and batches: "
              f"losses {res[0]['none']['losses']} vs {losses} (largest relative difference "
              f"{rel:.3e}, tolerance {tol}); the f32 momentum's normwise relative difference "
              f"per leaf {mom} (tolerance {mtol}); the parameters' largest {wp:.3e} "
              f"(tolerance {tol / 10}), {differ} of {total} coordinates differ")
        if rel > tol or wm > mtol or wp > tol / 10:
            fail("mesh: the none run on the mesh is outside its tolerance of the in-turn "
                 "trainer")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh: the phase took {time.perf_counter() - t_phase:.1f} s")
    paths = {f"mesh {MESH} diana ({layers} layers, per rank, {steps} steps)":
             res[0]["diana"]["launches"]}
    for arch, flayers, method, _ in MESH_FAMILIES:
        if res[0]["families"][arch]["launches"]:
            depth = "reduced" if flayers is None else f"{flayers} layers"
            paths[f"mesh {MESH} {arch} {method} ({depth}, per rank, {steps} "
                  f"steps)"] = res[0]["families"][arch]["launches"]
    for method in MESH_LAUNCHES:
        paths[f"mesh {MESH} reduced {method} (per rank, 2 steps)"] = \
            res[0]["reduced"][method]["launches"]
    return paths


# ------------------------------------------------------------ serving over the mesh

SERVE_MESH_TOKENS = 8     # serve-mesh: teacher-forced decode steps per path
# serve-mesh: each rank's logits against the single-device decode of the same
# weights, caches and tokens, in bf16 epsilons of the largest logit: the
# tensor-parallel halves (attention's wo, the MLP's w_out, granite's experts'
# d_ff) round to bf16 before their all-reduce, and the data ranks' softmax
# parts add in another order; twice the serve: phase's decode-against-forward
# bound for llama (SERVE_PARITY)
SERVE_MESH_BOUND = 16
# serve-mesh: granite-moe decodes in f32 (its config is bf16) and is held
# within this fraction of the largest single-device logit.  In bf16 the
# halves' rounding moves the router's inputs by a bf16 ulp, enough to flip a
# near tie of its top-k (the CPU rehearsal's reduced bf16 granite flipped one
# choice in 8 steps and landed 30 bf16 epsilons off), which would hide
# whether the mesh keeps the global batch's choices; f32 moves them ~1e-7
SERVE_MESH_F32_BOUND = 1e-4
SERVE_MESH_WRAP = 3       # long_500k starts this many positions before the ring wraps


def _serve_mesh_paths(get_cfg, sizes):
    """``[(name, config, shape, filled)]``: the serve-mesh paths in order,
    the llama ones sharing one config object (and so one set of weights);
    ``filled`` marks the decode that starts from a filled ring buffer."""
    from repro_torch.configs import ShapeConfig

    lcfg = get_cfg("llama3.2-1b")
    return [("llama3.2-1b decode_32k", lcfg, ShapeConfig("decode_32k", sizes["llama"][1],
                                                         sizes["llama"][0], "decode"), False),
            ("llama3.2-1b long_500k", lcfg, ShapeConfig("long_500k", sizes["long"], 1,
                                                        "decode"), True),
            ("llama3.2-1b prefill", lcfg, ShapeConfig("prefill", sizes["prefill"][1],
                                                      sizes["prefill"][0], "prefill"), False),
            ("mamba2-130m decode_32k", get_cfg("mamba2-130m"),
             ShapeConfig("decode_32k", sizes["mamba"][1], sizes["mamba"][0], "decode"), False),
            ("granite-moe-3b-a800m decode", replace(get_cfg("granite-moe-3b-a800m"),
                                                    param_dtype=torch.float32,
                                                    compute_dtype=torch.float32),
             ShapeConfig("decode", sizes["granite"][1], sizes["granite"][0], "decode"), False)]


def _ring_start(caches, dev, wrap):
    """Fill long_500k's global ring buffers as if ``rows - wrap`` tokens had
    been decoded: K normal, V uniform in [0.5, 1.5) from a generator on
    ``dev`` (the same bits in every process), the rows from that position on
    empty, ``pos`` at it."""
    gen = torch.Generator(device=dev).manual_seed(17)
    for c in caches:
        pos = c.k.shape[2] - wrap
        c.k.copy_(torch.randn(c.k.shape, generator=gen, device=dev))
        c.v.copy_(torch.rand(c.v.shape, generator=gen, device=dev) + 0.5)
        c.k[:, :, pos:], c.v[:, :, pos:] = 0, 0
        c.pos.fill_(pos)


class _KeptChoices:
    """Counts each ``moe.route`` call's kept choices while in use."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.kept = moe, moe.route, []

    def __enter__(self):
        def spy(*a, **kw):
            out = self.route(*a, **kw)
            self.kept.append(int(out[3].sum()))
            return out

        self.moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def _serve_mesh_run(dev, cfg, shape, params, tokens, filled, mesh=None, lay=None):
    """``tokens`` (B, steps) teacher-forced through ``build_serve_step``
    (a prefill: one ``build_prefill`` call with ``tokens`` as the prompt)
    on this process's part of ``mesh`` (None: one device), twice from the
    same state.  Returns the first run's logits on the host and
    ``{"ms": both runs' per-call CUDA-event ms, "same": the two runs' bits
    equal (logits, caches, kept choices), "peak", "cache_bytes", "built":
    the collectives of the build, "steps": each call's, "kept": the kept
    MoE choices per call, "finite"}``."""
    from repro_torch.core import transport
    from repro_torch.launch.serve import (build_prefill, build_serve_step, init_serve_caches,
                                          serve_cache_shardings)
    from repro_torch.launch.sharding_rules import held_cache_specs, shard_caches

    on_card = dev.type == "cuda"
    rows = (tokens if lay is None else lay.rows(tokens)).to(dev)
    _reset_peak(dev)
    transport.STATS.clear()
    build_fn = build_prefill if shape.kind == "prefill" else build_serve_step
    fn = build_fn(cfg, shape, mesh, params=params)
    built = {f"{k[0]} {k[1]}": v for k, v in transport.STATS.items()}
    caches, first = None, None
    if shape.kind == "decode":
        caches = init_serve_caches(cfg, shape, mesh, device=dev)
        if filled:
            first = init_serve_caches(cfg, shape, None, device=dev)
            _ring_start(first, dev, SERVE_MESH_WRAP)
            if mesh is not None:
                specs = held_cache_specs(serve_cache_shardings(cfg, mesh, shape)[0])
                first = shard_caches(first, specs, mesh, lay.worker, lay.shard)
    nmoe = sum(s.mlp == "moe" for s in cfg.pattern) * cfg.n_blocks
    runs = []
    for _ in range(2):
        for i, t in enumerate(x for c in (caches or ()) for x in c):
            if first is None:
                t.zero_()
            else:
                t.copy_([x for c in first for x in c][i])
        transport.STATS.clear()
        calls = [rows] if shape.kind == "prefill" else list(rows.split(1, dim=1))
        out, evs, steps = [], [], []
        with _KeptChoices() as kept:
            _sync(dev)
            for toks in calls:
                before = dict(transport.STATS)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if on_card else None
                if ev:
                    ev[0].record()
                if shape.kind == "prefill":
                    out.append(fn(params, {"tokens": toks}))
                else:
                    lg, caches = fn(params, caches, toks)
                    out.append(lg)
                if ev:
                    ev[1].record()
                evs.append(ev)
                steps.append({f"{k[0]} {k[1]}": v - before.get(k, 0)
                              for k, v in transport.STATS.items() if v != before.get(k, 0)})
            _sync(dev)
        # each leaf's bits summed as int64, block by block (exact)
        ints = {2: torch.int16, 4: torch.int32}
        sums = [sum(int(x.view(ints[t.element_size()]).long().sum()) for x in t)
                for c in (caches or ()) for t in c]
        runs.append((torch.cat(out, 1).to("cpu", copy=True),
                     [a.elapsed_time(b) for a, b in evs] if on_card else [], sums, steps,
                     [sum(kept.kept[i:i + nmoe]) for i in range(0, len(kept.kept), nmoe)]
                     if nmoe else []))
    (logits, ms, sums, steps, kept), (logits2, ms2, sums2, _, kept2) = runs
    res = {"ms": [ms, ms2], "same": bool(torch.equal(logits, logits2) and sums == sums2
                                          and kept == kept2),
           "peak": _peak(dev), "built": built, "steps": steps, "kept": kept,
           "cache_bytes": sum(t.numel() * t.element_size() for c in (caches or ()) for t in c),
           "finite": bool(torch.isfinite(logits).all())}
    del caches, first, fn
    return logits, res


def _serve_mesh_rank(rank, tmp, world, dev_type, get_cfg, sizes, prepare):
    """One rank of the ``serve-mesh:`` phase (see :func:`serve_mesh_phase`);
    writes its readings to ``tmp/rank{rank}.json``."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.serve import serve_layout
    from repro_torch.launch.sharding_rules import param_specs, shard_tree
    from repro_torch.models.transformer import init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    if prepare is not None:
        prepare()
    res = {"rank": rank, "probe": _mesh_probe(dev)}
    if not all(res["probe"].values()):
        raise RuntimeError(f"serve-mesh: gloo does not take CUDA tensors for {res['probe']}")
    mesh = parse_mesh(MESH)
    ref = torch.load(tmp / "ref.pt")
    build.reset_launches()
    pcfg, params = None, None
    for name, cfg, shape, filled in _serve_mesh_paths(get_cfg or get_config, sizes):
        if cfg is not pcfg:
            params = None
            _reset_peak(dev)
            for turn in range(world):   # one rank at a time holds a whole model
                dist.barrier()
                if turn == rank:
                    whole = init_model(cfg, dev, seed=0)
                    params = shard_tree({p: x.detach() for p, x in whole.items()},
                                        param_specs(whole, cfg, mesh.model), mesh.model,
                                        rank % mesh.model)
                    del whole
                    _reset_peak(dev)
            pcfg = cfg
        lay = serve_layout(cfg, shape, mesh)
        logits, r = _serve_mesh_run(dev, cfg, shape, params, ref[name]["tokens"], filled,
                                    mesh, lay)
        want = lay.rows(ref[name]["logits"])
        r["err"] = float((logits - want).abs().max())
        r["scale"] = float(want.abs().max())
        r["bitwise"] = bool(torch.equal(logits, want))
        r["split"] = lay.data.split if lay.data else None
        r["local_params"] = sum(x.numel() for x in params.values())
        r["coords"] = [lay.worker, lay.shard]
        res[name] = r
        del logits
    res["launches"] = dict(build.LAUNCHES)
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def serve_mesh_phase(dev, card: str, get_cfg=None, sizes=None, world=4, prepare=None,
                     steps=SERVE_MESH_TOKENS, bound=SERVE_MESH_BOUND) -> dict:
    """Serving over ``--mesh 2x2`` (2 data x 2 model ranks) as ``world`` = 4
    processes sharing the one card over gloo, as the ``mesh:`` phase runs
    them (:func:`_mesh_probe`), held to the single-device decode of the same
    weights (``init_model`` seed 0), caches and tokens, run first in this
    process with its logits kept on the host (both together would not fit):

    1. llama3.2-1b at full width and depth, decode_32k at batch 32 against
       32,768 positions (a rank: 16 rows and 4 of the 8 KV heads, 8.59 GB of
       the 34.36 GB cache), ``steps`` teacher-forced tokens; then long_500k
       (batch 1: the 8192-slot ring buffer split 4096 slots per data rank,
       started :data:`SERVE_MESH_WRAP` positions before it wraps, so that the
       slot's owner changes inside the run); then one prefill of 4 x 4096
       tokens (2 rows a data rank);
    2. mamba2-130m at full depth, decode_32k at batch 128: no ``mamba``
       gather in a step (three when the step is built), the held ``conv`` /
       ``ssm`` bytes beside their reckoning (64 rows a rank, whole over the
       model ranks);
    3. granite-moe-3b-a800m, all 32 layers, decode at batch 8 (the ``ffn``
       partition; capacity 2 per expert drops choices) in f32 against 8192
       positions (:data:`SERVE_MESH_F32_BOUND`): the kept choices per step,
       summed over the data ranks, equal to the single-device decode's.

    Per rank and path: ms per token (CUDA events), the peak, the tagged
    collectives' calls and bytes per step, the logits within ``bound`` bf16
    epsilons of the single-device logits' largest, the same bits twice from
    the same state, and no kernel launch.  ``get_cfg`` and ``sizes`` let a
    CPU rehearsal pass reduced configs and small sizes.  Returns ``{}`` (no
    kernel runs here)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models.mamba2 import dims
    from repro_torch.models.transformer import init_model

    t_phase = time.perf_counter()
    get = get_cfg or get_config
    sizes = sizes or {"llama": (32, 32768), "long": 524288, "prefill": (4, 4096),
                      "mamba": (128, 32768), "granite": (8, 8192)}
    paths = _serve_mesh_paths(get, sizes)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_")
    try:
        ref, pcfg, params = {}, None, None
        for name, cfg, shape, filled in paths:
            if cfg is not pcfg:
                params = None
                _reset_peak(dev)
                params, pcfg = init_model(cfg, dev, seed=0), cfg
            if shape.kind == "prefill":
                tokens = torch.from_numpy(make_lm_batch(cfg, shape, 0)["tokens"]).long()
            else:
                tokens = torch.from_numpy(np.random.default_rng(29).integers(
                    0, cfg.vocab, (shape.global_batch, steps)))
            logits, r = _serve_mesh_run(dev, cfg, shape, params, tokens, filled)
            ref[name] = {"tokens": tokens, "logits": logits, "run": r}
            med = statistics.median(r["ms"][1]) if r["ms"][1] else float("nan")
            print(f"serve-mesh: {name} on one device (the reference): {tuple(tokens.shape)} "
                  f"tokens, ms per call (second run) median {med}, all {r['ms'][1]}; peak "
                  f"{r['peak']} B; cache {r['cache_bytes']} B; twice the same bits "
                  f"{r['same']}; kept MoE choices per step {r['kept']}; {card}")
            if not (r["same"] and r["finite"]):
                fail(f"serve-mesh: {name}: the single-device reference is not deterministic "
                     f"or not finite")
        del params
        _reset_peak(dev)
        torch.save(ref, Path(tmp, "ref.pt"))
        if dev.type == "cuda":
            free, total = torch.cuda.mem_get_info()
            print(f"serve-mesh: the parent holds {torch.cuda.memory_allocated()} B allocated at "
                  f"the spawn; the card has {free} B free of {total}")
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            _serve_mesh_rank, args=(tmp, world, dev.type, get_cfg, sizes, prepare),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + 600
        try:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    fail("serve-mesh: the ranks did not finish in 600 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            if alloc_conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        res = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(world)]
        print(f"serve-mesh: --mesh {MESH} = 2 data x 2 model ranks, {world} processes on one "
              f"{dev.type} device over gloo (CUDA tensors for {res[0]['probe']}); the ranks "
              f"ran {time.perf_counter() - t0:.1f} s (spawn included)")
        for name, cfg, shape, _ in paths:
            scale = max(r[name]["scale"] for r in res)
            f32 = cfg.compute_dtype == torch.float32
            unit, bnd, what = ((scale, SERVE_MESH_F32_BOUND, "of the largest")
                               if f32 else (BF16_EPS * scale, bound, "bf16 epsilons of the largest"))
            for r in res:
                m = r[name]
                med = statistics.median(m["ms"][1]) if m["ms"][1] else float("nan")
                per = m["steps"][-1] if m["steps"] else {}
                print(f"serve-mesh: {name} rank {r['rank']} (data, model) {tuple(m['coords'])}"
                      f", split {m['split']}: ms per call (second run) median {med}, all "
                      f"{m['ms'][1]}, first run {m['ms'][0]}; peak {m['peak']} B; cache "
                      f"{m['cache_bytes']} B; {m['local_params']} parameters; collectives of "
                      f"the last call {per}, of the build {m['built']}; max |logits - one "
                      f"device| {m['err']} ({m['err'] / unit} {what}, bound {bnd}; bitwise "
                      f"{m['bitwise']}); twice the same bits "
                      f"{m['same']}; kept MoE choices per step {m['kept']}; {card}")
                if not (m["finite"] and m["same"] and m["err"] <= bnd * unit):
                    fail(f"serve-mesh: {name} rank {r['rank']}: non-finite, not deterministic "
                         f"or {m['err'] / unit} {what} off the single-device logits")
                if any("mamba calls" in s for s in m["steps"]):
                    fail(f"serve-mesh: {name} rank {r['rank']}: a Mamba-2 gather in a step")
            want = ref[name]["run"]["kept"]
            for s in range(2):
                got = [sum(k) for k in zip(*(r[name]["kept"] for r in res
                                             if r[name]["coords"][1] == s))]
                if cfg.moe is not None and got != want:
                    fail(f"serve-mesh: {name}: kept MoE choices {got} on model shard {s}, the "
                         f"single-device decode kept {want}")
        mcfg = next(c for n, c, _, _ in paths if n.startswith("mamba2"))
        sc, d_in, h, hp, n, g = dims(mcfg)
        rows = sizes["mamba"][0] // 2
        esize = torch.empty((), dtype=mcfg.compute_dtype).element_size()
        reckon = mcfg.n_layers * (rows * ((sc.conv_width - 1) * (d_in + 2 * g * n) * esize
                                          + h * hp * n * 4) + 4)
        mname = next(n for n, *_ in paths if n.startswith("mamba2"))
        layers = sum(s.mixer == "mamba" for s in mcfg.pattern)
        for r in res:
            m = r[mname]
            print(f"serve-mesh: {mname} rank {r['rank']}: held caches {m['cache_bytes']} B, "
                  f"reckoned {reckon} B ({rows} rows x {mcfg.n_layers} layers of the conv "
                  f"history and the f32 state, whole over the model ranks); Mamba-2 gathers "
                  f"at the build {m['built'].get('mamba calls', 0)} (expected {3 * layers}), "
                  f"in the steps none")
            if m["cache_bytes"] != reckon or m["built"].get("mamba calls", 0) != 3 * layers:
                fail(f"serve-mesh: {mname} rank {r['rank']}: held {m['cache_bytes']} B "
                     f"(reckoned {reckon}), build gathers {m['built']}")
        for r in res:
            if r["launches"]:
                fail(f"serve-mesh: rank {r['rank']} launched kernels {r['launches']}")
        print(f"serve-mesh: kernel launches per rank {[r['launches'] for r in res]} (none)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve-mesh: the phase took {time.perf_counter() - t_phase:.1f} s")
    return {}


def main() -> None:
    t_script = time.perf_counter()
    # ---------------------------------------------------------------- device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import ShapeConfig, get_config, list_archs, reduced
        from repro_torch.core import prng
        from repro_torch.core.bucket import BucketedCompressor, ChunkedSchedule, checksum_words
        from repro_torch.core.controller import BudgetController, init_controller_state
        from repro_torch.core.compression import CompressionConfig
        from repro_torch.core.compressors.identity import IdentityCompressor
        from repro_torch.core.compressors.natural import NaturalCompressor
        from repro_torch.core.compressors.randk import RandKCompressor, uniform_subset
        from repro_torch.core.compressors.ternary import TernaryCompressor
        from repro_torch.core.compressors.topk_ef import TopKEFCompressor
        from repro_torch.core.diana import (GROUP_FOLD, bucket_layout, reference_init,
                                            reference_step, worker_key)
        from repro_torch.core.participation import ChurnEvent, ParticipationSpec, parse_faults
        from repro_torch.core.policy import grouped_bucket_layout, policy_bits_per_dim
        from repro_torch.core.vr import resolve_vr_p
        from repro_torch.benchmarks.common import (fstar_logreg, run_logreg,
                                                   run_logreg_stochastic, stoch_problem)
        from repro_torch.configs.diana_paper import LogRegProblem
        from repro_torch.data.pipeline import make_lm_batch
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.sparse import COARSE
        from repro_torch.launch import train as train_mod
        from repro_torch.launch.train import (build_distributed_step, build_train_step,
                                              controller_tick, init_train_state, make_optimizer)
        from repro_torch.models.transformer import (count_active_params, count_params,
                                                    init_model, meta_params, param_shapes,
                                                    train_loss)
    except ImportError as e:
        fail(f"the repro_torch package is not next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    dev = torch.device("cuda", 0)
    print(f"device: {card}")
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    try:
        clock_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60).stdout.split()[0])
    except (OSError, IndexError, ValueError, subprocess.TimeoutExpired) as e:
        fail(f"cannot read the card's maximum SM clock from nvidia-smi ({e})")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {sms} SMs, maximum SM clock {clock_mhz:.0f} MHz (the cipher's integer "
          f"bound: {CIPHER_INSTRUCTIONS} instructions per word at {LANES_PER_SM_CLOCK} lanes "
          f"per SM per clock)")

    # ----------------------------------------------------------------- build
    lib = build.library()
    print(f"build: {lib.seconds:.2f} s for {len(build.SOURCES)} sources into "
          f"{build.BUILD_DIR.relative_to(ROOT)}")
    for line in lib.log.splitlines():
        if ("registers" in line or "stack frame" in line or "entry function" in line
                or line.startswith("==")):
            print(f"build: {line.strip()}")

    t_mark = [time.perf_counter()]

    def took(name):
        """Print the seconds since the last mark: one line per span of phases."""
        now = time.perf_counter()
        print(f"{name}: the phases took {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    # --------------------------------------------------------------- kernels
    cfg = replace(get_config("llama3.2-1b"), n_layers=LAYERS)
    meta = {k: torch.empty(s, dtype=cfg.param_dtype, device="meta")
            for k, s in param_shapes(cfg).items()}
    comp = TernaryCompressor(block_size=cfg.comp_block)
    layout = bucket_layout(make_optimizer(cfg).compression, meta)
    dp, bsz = layout.padded_size, cfg.comp_block
    m = dp // bsz
    seg = max(layout.padded_sizes) // bsz
    print(f"kernels: bucket {layout.n_leaves} leaves, {layout.size} params, Dp {dp}, "
          f"m {m} rows of B {bsz}; largest segment {seg} rows; n {WORKERS}")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, ops_count, note="",
               library_ms=None, words=None):
        """One kernel line; ``words`` threefry words make the bound
        bound_int's (the cipher), else bytes and f32-rate operations."""
        b_ms, b_by = (bound(nbytes, ops_count) if words is None
                      else bound_int(words, nbytes, clock_mhz * 1e6, sms))
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
        lib_note = "" if library_ms is None else f" library_ms {library_ms:.4f}"
        print(f"kernel {name}: max_abs_err {err} ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by}){lib_note} {note}")

    # threefry bits, at the largest segment the path draws (embed / lm_head)
    key = prng.split(prng.fold_in(prng.PRNGKey(0), 1), layout.n_leaves)[0]
    got = ops.bits_op(key, (seg, bsz), dev)
    want = prng.bits(key, (seg, bsz), device=dev)
    if not torch.equal(got, want):
        fail("threefry bits differ from the plain version")
    words = seg * bsz
    record("threefry_bits", "src/repro_torch/csrc/threefry.cu",
           "src/repro/core/compressors/ternary.py:167 (jax.random.bits, no Pallas kernel)", 0.0,
           time_ms(lambda: ops.bits_op(key, (seg, bsz), dev, out=got), 10),
           time_ms(lambda: prng.bits(key, (seg, bsz), device=dev), 3),
           4.0 * words, 0.0, f"bitwise, {words} words", words=words)
    del got, want

    # quantize_pack over the whole bucket, the bits of the 12 segments' keys
    # drawn by threefry_bits (segment i: bits(keys[i], (m_i, B)))
    seg_rows = [ps // bsz for ps in layout.padded_sizes]
    tkeys = prng.split(key, layout.n_leaves)
    delta = torch.randn((m, bsz), generator=gen, device=dev)
    delta *= torch.rand((m, 1), generator=gen, device=dev) * 1e-2
    delta[:7] = 0.0
    bits = ops.segment_bits_op(tkeys, layout.padded_sizes, dev).reshape(m, bsz)
    for p in (2.0, 1.0, math.inf):
        kp, ks = ops.quantize_pack_op(delta, bits, p=p)
        pp, ps_ = ref.ref_quantize_pack(delta, bits, p)
        if p == math.inf:
            if not (torch.equal(kp, pp) and torch.equal(ks, ps_)):
                fail("quantize_pack (p=inf) differs from the plain version")
            err = 0.0
        else:
            su = ulps(ks, ps_)
            agree = float((torch.stack([(kp >> s) & 3 for s in (0, 2, 4, 6)])
                           == torch.stack([(pp >> s) & 3 for s in (0, 2, 4, 6)])).float().mean())
            print(f"kernel quantize_pack p={p}: scales within {su} ulp, codes equal on "
                  f"{agree * 100:.6f}% of coordinates")
            if su > 4 or agree < 0.9999:
                fail(f"quantize_pack (p={p}) outside its tolerance")
        del kp, ks, pp, ps_
    n_coord = m * bsz
    record("quantize_pack", "src/repro_torch/csrc/quantize_pack.cu",
           "src/repro/kernels/quantize_pack.py:106 (pallas_call :126)", err,
           time_ms(lambda: ops.quantize_pack_op(delta, bits, p=math.inf), 10),
           time_ms(lambda: ref.ref_quantize_pack(delta, bits, math.inf), 3),
           n_coord * (4 + 4 + 0.25) + 4 * m, 8.0 * n_coord, "p=inf bitwise")
    # quantize_pack_prng: the same encode, the bits drawn in the kernel, on
    # the same input with -0.0, +-inf, subnormals and FLT_MAX spliced into 64
    # rows each (a row holding an infinity encodes to zeros: its scale is inf)
    dsp = delta.clone()
    tspecial = torch.tensor([-0.0, 0.0, float("inf"), float("-inf"), 1e-40, -1e-45,
                             3.4028235e38, -3.4028235e38], device=dev)
    for r in range(4):
        dsp[torch.randperm(m, generator=gen, device=dev)[:64], r * 97:r * 97 + 2] = \
            tspecial[2 * r:2 * r + 2]
    for p in (2.0, 1.0, math.inf):
        kp, ks = ops.quantize_pack_prng_op(dsp, tkeys, seg_rows, p=p)
        bp, bs = ops.quantize_pack_op(dsp, bits, p=p)
        if not (torch.equal(kp, bp) and torch.equal(ks, bs)):
            fail(f"quantize_pack_prng (p={p}) differs from quantize_pack fed threefry_bits")
        del bp, bs
    del bits
    pp, ps_ = ref.ref_quantize_pack_prng(dsp, tkeys, seg_rows, math.inf)
    if not (torch.equal(kp, pp) and torch.equal(ks, ps_)):
        fail("quantize_pack_prng (p=inf) differs from the plain version")
    del kp, ks, pp, ps_
    record("quantize_pack_prng", "src/repro_torch/csrc/quantize_pack.cu",
           "src/repro/kernels/quantize_pack.py:147 (pallas_call :177)", 0.0,
           time_ms(lambda: ops.quantize_pack_prng_op(dsp, tkeys, seg_rows, p=math.inf), 10),
           time_ms(lambda: ref.ref_quantize_pack_prng(dsp, tkeys, seg_rows, math.inf), 3),
           n_coord * (4 + 0.25) + 4 * m, 0.0,
           "p=inf bitwise the plain version; bitwise quantize_pack fed threefry_bits at "
           "p in {inf, 2, 1}; -0.0, +-inf, subnormals, FLT_MAX spliced", words=n_coord)
    del dsp

    # the decode and server kernels, on payloads the kernel just produced
    pays = []
    for w in range(WORKERS):
        k = prng.split(prng.fold_in(prng.PRNGKey(0), w), layout.n_leaves)
        pays.append(ops.quantize_pack_prng_op(delta * (w + 1), k, seg_rows, p=math.inf))
    del delta
    packed = torch.stack([p for p, _ in pays])
    scales = torch.stack([s for _, s in pays])
    del pays
    h = torch.randn(dp, generator=gen, device=dev) * 1e-3
    alpha = comp.memory_alpha()

    def check_equal(name, a, b):
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                fail(f"{name} differs from the plain version")

    one = (packed[:1], scales[:1])
    check_equal("unpack_reduce", ops.unpack_reduce_op(*one), ref.ref_unpack_reduce(*one))
    check_equal("unpack_reduce (n=4)", ops.unpack_reduce_op(packed, scales),
                ref.ref_unpack_reduce(packed, scales))
    record("unpack_reduce", "src/repro_torch/csrc/unpack_reduce.cu",
           "src/repro/kernels/unpack_reduce.py:81 (pallas_call :95)", 0.0,
           time_ms(lambda: ops.unpack_reduce_op(*one), 10),
           time_ms(lambda: ref.ref_unpack_reduce(*one), 3),
           n_coord * (0.25 + 4) + 4 * m, 2.0 * n_coord, "n=1 (a worker's own decode), bitwise")
    check_equal("unpack_reduce_mean", ops.unpack_reduce_mean_op(packed, scales),
                ref.ref_unpack_reduce_mean(packed, scales))
    record("unpack_reduce_mean", "src/repro_torch/csrc/unpack_reduce.cu",
           "src/repro/kernels/unpack_reduce.py:110 (pallas_call :123)", 0.0,
           time_ms(lambda: ops.unpack_reduce_mean_op(packed, scales), 10),
           time_ms(lambda: ref.ref_unpack_reduce_mean(packed, scales), 3),
           n_coord * (0.25 * WORKERS + 4) + 4 * m * WORKERS, (2.0 * WORKERS + 1) * n_coord,
           "n=4, bitwise")
    check_equal("unpack_reduce_apply",
                ops.unpack_reduce_apply_op(packed, scales, h, alpha=alpha),
                ref.ref_unpack_reduce_apply(packed, scales, h, alpha, WORKERS))
    record("unpack_reduce_apply", "src/repro_torch/csrc/unpack_reduce.cu",
           "src/repro/kernels/unpack_reduce.py:138 (pallas_call :164)", 0.0,
           time_ms(lambda: ops.unpack_reduce_apply_op(packed, scales, h, alpha=alpha), 10),
           time_ms(lambda: ref.ref_unpack_reduce_apply(packed, scales, h, alpha, WORKERS), 3),
           n_coord * (0.25 * WORKERS + 12) + 4 * m * WORKERS, (2.0 * WORKERS + 4) * n_coord,
           "n=4, bitwise")
    del packed, scales, h, one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ------------------------------------------------- natural kernels
    nlayout = bucket_layout(CompressionConfig(method="natural", bucketed=True), meta)
    nd = nlayout.padded_size
    print(f"kernels: natural bucket {nlayout.n_leaves} leaves, alignment 1, Dp {nd}; "
          f"n {WORKERS}")

    def same_bits(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    pows = torch.ldexp(torch.ones(254, device=dev), torch.arange(-126, 128, device=dev))
    special = torch.cat([pows, torch.nextafter(pows, torch.zeros_like(pows)),
                         torch.tensor([0.0, -0.0, 1e-45, 3e-39, 1.1754942e-38,
                                       3.4028235e38], device=dev)])
    special = torch.cat([special, -special]).repeat(64)
    x = torch.randn(nd, generator=gen, device=dev) * 1e-3
    x[torch.randperm(nd, generator=gen, device=dev)[:special.numel()]] = special
    nkeys = prng.split(prng.fold_in(prng.PRNGKey(0), 2), nlayout.n_leaves)
    nbits = ops.segment_bits_op(nkeys, nlayout.padded_sizes, dev)
    kc = ops.nat_pack_op(x, nbits)
    if not torch.equal(kc, ref.ref_nat_pack(x, nbits)):
        fail("nat_pack differs from the plain version")
    record("nat_pack", "src/repro_torch/csrc/nat_pack.cu",
           "src/repro/kernels/nat_pack.py:107 (pallas_call :119)", 0.0,
           time_ms(lambda: ops.nat_pack_op(x, nbits, out=kc), 10),
           time_ms(lambda: ref.ref_nat_pack(x, nbits), 3),
           nd * (4 + 4 + 2), 12.0 * nd, f"bitwise, {special.numel()} special values spliced")
    kcp = ops.nat_pack_prng_op(x, nkeys, nlayout.padded_sizes)
    if not torch.equal(kcp, kc):
        fail("nat_pack_prng differs from nat_pack fed threefry_bits")
    if not torch.equal(kcp, ref.ref_nat_pack_prng(x, nkeys, nlayout.padded_sizes)):
        fail("nat_pack_prng differs from the plain version")
    record("nat_pack_prng", "src/repro_torch/csrc/nat_pack.cu",
           "src/repro/kernels/nat_pack.py:134 (pallas_call :154)", 0.0,
           time_ms(lambda: ops.nat_pack_prng_op(x, nkeys, nlayout.padded_sizes, out=kcp), 10),
           time_ms(lambda: ref.ref_nat_pack_prng(x, nkeys, nlayout.padded_sizes), 3),
           nd * (4 + 2), 0.0,
           f"bitwise the plain version and nat_pack fed threefry_bits, "
           f"{special.numel()} special values spliced", words=nd)
    del kcp
    # n = 4 payloads in the trainer's gathered buffer (rows 16-byte aligned)
    ncomp = NaturalCompressor()
    gathered = ncomp.gathered_bucketed(nlayout, WORKERS, dev)
    for w in range(WORKERS):
        ops.nat_pack_prng_op(x * (w + 1), nkeys, nlayout.padded_sizes, out=gathered.packed[w])
    del x, nbits, kc
    codes = gathered.packed
    small = torch.randint(-10, 0, (WORKERS, 4096), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int16)       # every worker: -0.0
    cols = torch.randperm(nd, generator=gen, device=dev)[:4096 * 3]
    codes[:, cols[:4096]] = small
    codes[:, cols[4096:8192]] = torch.randint(1, 37, (WORKERS, 4096), generator=gen,
                                              device=dev, dtype=torch.int32).to(torch.int16)
    codes[2, cols[8192:]] = torch.tensor([288, -288, 0, 287], device=dev,
                                         dtype=torch.int16).repeat(1024)
    hn = torch.randn(nd, generator=gen, device=dev) * 1e-3
    nalpha = ncomp.memory_alpha()
    one = codes[:1]
    if not same_bits(ops.nat_decode_sum_op(one), ref.ref_nat_decode_sum(one)):
        fail("nat_decode_sum (n=1) differs from the plain version")
    if not same_bits(ops.nat_decode_sum_op(codes), ref.ref_nat_decode_sum(codes)):
        fail("nat_decode_sum (n=4) differs from the plain version")
    record("nat_decode_sum", "src/repro_torch/csrc/nat_decode.cu",
           "src/repro/kernels/nat_pack.py:218 (pallas_call :228)", 0.0,
           time_ms(lambda: ops.nat_decode_sum_op(one), 10),
           time_ms(lambda: ref.ref_nat_decode_sum(one), 3),
           nd * (2 + 4), 8.0 * nd, "n=1 (a worker's own decode), bitwise; n=4 bitwise")
    if not same_bits(ops.nat_decode_sum_mean_op(codes), ref.ref_nat_decode_sum_mean(codes)):
        fail("nat_decode_sum_mean differs from the plain version")
    record("nat_decode_sum_mean", "src/repro_torch/csrc/nat_decode.cu",
           "src/repro/kernels/nat_pack.py:240 (pallas_call :250)", 0.0,
           time_ms(lambda: ops.nat_decode_sum_mean_op(codes), 10),
           time_ms(lambda: ref.ref_nat_decode_sum_mean(codes), 3),
           nd * (2 * WORKERS + 4), (9.0 * WORKERS + 1) * nd, "n=4, bitwise")
    got = ops.nat_decode_sum_apply_op(codes, hn, alpha=nalpha)
    want = ref.ref_nat_decode_sum_apply(codes, hn, nalpha)
    if not all(same_bits(a, b) for a, b in zip(got, want)):
        fail("nat_decode_sum_apply differs from the plain version")
    del got, want
    record("nat_decode_sum_apply", "src/repro_torch/csrc/nat_decode.cu",
           "src/repro/kernels/nat_pack.py:262 (pallas_call :283)", 0.0,
           time_ms(lambda: ops.nat_decode_sum_apply_op(codes, hn, alpha=nalpha), 10),
           time_ms(lambda: ref.ref_nat_decode_sum_apply(codes, hn, nalpha), 3),
           nd * (2 * WORKERS + 12), (9.0 * WORKERS + 4) * nd, "n=4, bitwise")
    del gathered, codes, one, hn, small, cols
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -------------------------------------------------- sparse kernels
    def decode_phases(label, idx, vals, scale, d, op=None, calls=3):
        """The decode's phases (count, scan, bin, the sort's chunk counts,
        run scan and placement, tile) from one torch.profiler window over
        ``calls`` calls, read by kernel name: device time per launch over
        the launches the window saw (it may miss some), and the most
        entries any coarse bin holds."""
        op = op or ops.sparse_decode_sum_op
        nw = idx.shape[0]
        per_bin = torch.bincount((idx.to(torch.int64) // COARSE).flatten(),
                                 minlength=-(-d // COARSE))
        op(idx, vals, scale, d)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                op(idx, vals, scale, d)
            torch.cuda.synchronize()
        phases = ("Memset", "coarse_count_kernel", "bin_scan_kernel", "coarse_bin_kernel",
                  "chunk_count_kernel", "run_scan_kernel", "chunk_place_kernel", "tile_kernel")
        split = {ph: [0.0, 0] for ph in phases}
        for ev in prof.key_averages():
            for ph in phases:
                if ph in ev.key and getattr(ev, "device_time_total", 0.0) > 0:
                    split[ph][0] += ev.device_time_total / 1e3
                    split[ph][1] += ev.count
        del prof
        split = {ph: (t / c if c else 0.0, c) for ph, (t, c) in split.items()}
        whole = time_ms(lambda: op(idx, vals, scale, d), 10)
        bins = (f"coarse bins: {per_bin.numel()}, entries per bin mean "
                f"{nw * idx.shape[1] / per_bin.numel():.1f} max {int(per_bin.max())}")
        total = sum(t for t, _ in split.values())
        if total > 0:
            print(f"decode phases {label} n={nw} (torch.profiler device time per launch, ms; "
                  f"launches seen of {calls}): "
                  + " ".join(f"{ph} {t:.4f} ({c}/{calls})" for ph, (t, c) in split.items())
                  + f"; sum {total:.4f}; whole call (CUDA events) {whole:.4f}; " + bins)
        else:
            print(f"decode phases {label} n={nw}: torch.profiler's key_averages() shows no "
                  f"device time; whole call (CUDA events) {whole:.4f} ms; {bins}")

    # Payloads of a real rand-k bucketed compress (threefry tags, top-k per
    # segment, sparse_gather) of four workers into the trainer's gathered
    # buffer, with special values and both end indices spliced in.
    slayout = bucket_layout(CompressionConfig(method="randk", k=COMP_K, bucketed=True), meta)
    sd = slayout.padded_size
    rcomp = RandKCompressor(COMP_K)
    kk = rcomp.payload_length(slayout)
    print(f"kernels: sparse bucket {slayout.n_leaves} leaves, Dp {sd}, k {COMP_K} per leaf, "
          f"K {kk} per worker; n {WORKERS}")
    x = torch.randn(sd, generator=gen, device=dev) * 1e-3
    sgath = rcomp.gathered_bucketed(slayout, WORKERS, dev)
    for w in range(WORKERS):
        rcomp.compress_bucketed(slayout, x * (w + 1), worker_key(prng.PRNGKey(6), w),
                                out=sgath.select(w))
        if not same_bits(sgath.values[w], ref.ref_sparse_gather(x * (w + 1), sgath.indices[w])):
            fail("sparse_gather (inside the rand-k compress) differs from the plain version")
    sidx, svals = sgath.indices, sgath.values
    row0 = sidx[0].to(torch.int64)
    for pos, end in ((0, 0), (1, sd - 1)):          # both ends of the buffer in worker 0
        if not bool((row0 == end).any()):
            row0[pos] = end
    sidx[0].copy_(row0)
    del row0
    specials = torch.tensor([-0.0, 0.0, float("inf"), float("-inf"), 1e-40, -1e-40,
                             -1e-45, 3.4028235e38, -1e-20, -1e-20], device=dev)
    sscale = rcomp._bucket_scales(slayout, dev)
    n_sp = min(4096, kk // (2 * specials.numel()))
    for w in range(WORKERS):
        pos = torch.randperm(kk, generator=gen, device=dev)[:n_sp * specials.numel()]
        svals[w, pos] = specials.repeat_interleave(n_sp)   # the -1e-20 entries last
        if w == 0:
            sscale[pos[-2 * n_sp:]] = 1e-30         # -1e-20 * 1e-30 underflows to -0.0
    xi = sidx[0]
    kv = ops.sparse_gather_op(x, xi)
    if not same_bits(kv, ref.ref_sparse_gather(x, xi)):
        fail("sparse_gather differs from the plain version")
    xi64 = xi.to(torch.int64)
    lib_gather = torch.empty_like(kv)
    record("sparse_gather", "src/repro_torch/csrc/sparse.cu",
           "src/repro/kernels/sparse.py:60 (pallas_call :65)", 0.0,
           time_ms(lambda: ops.sparse_gather_op(x, xi, out=kv), 10),
           time_ms(lambda: ref.ref_sparse_gather(x, xi), 3),
           kk * (4 + 4 + 4), 0.0, f"bitwise, K {kk}",
           time_ms(lambda: torch.index_select(x, 0, xi64, out=lib_gather), 10))
    del xi64
    # What sets the gather's pace: K random reads confined to windows of x
    # (32 MB is L2-resident), kernel and index_select in turn on each.
    for label, win in (("32 MB", 8 << 20), ("256 MB", 64 << 20), ("1 GB", 256 << 20),
                       (f"{sd * 4 / 1e9:.2f} GB (the bucket)", sd)):
        wi64 = torch.randint(0, win, (kk,), generator=gen, device=dev, dtype=torch.int64)
        wi = wi64.to(torch.int32).view(torch.uint32)
        if not same_bits(ops.sparse_gather_op(x, wi, out=kv), x[wi64]):
            fail(f"sparse_gather differs from the plain version over a {label} window")
        g_ms = time_ms(lambda: ops.sparse_gather_op(x, wi, out=kv), 10)
        l_ms = time_ms(lambda: torch.index_select(x, 0, wi64, out=lib_gather), 10)
        g2_ms = time_ms(lambda: ops.sparse_gather_op(x, wi, out=kv), 10)
        print(f"gather window {label}: K {kk} uniform reads; sparse_gather {g_ms:.4f} / "
              f"{g2_ms:.4f} ms ({kk / min(g_ms, g2_ms) / 1e6:.2f} G reads/s), index_select "
              f"{l_ms:.4f} ms ({kk / l_ms / 1e6:.2f} G reads/s)")
        del wi, wi64
    del kv, lib_gather
    one = (sidx[:1], svals[:1])
    sgot = ops.sparse_decode_sum_op(*one, sscale, sd)
    if not same_bits(sgot, ref.ref_sparse_decode_sum(*one, sscale, sd)):
        fail("sparse_decode_sum (n=1) differs from the plain version")
    if bool(((sgot == 0) & torch.signbit(sgot)).any()):
        fail("sparse_decode_sum (n=1) holds a -0.0")
    del sgot
    sgot = ops.sparse_decode_sum_op(sidx, svals, sscale, sd)
    want = ref.ref_sparse_decode_sum(sidx, svals, sscale, sd)
    if not same_bits(sgot, want):
        fail("sparse_decode_sum (n=4) differs from the plain version")
    if not same_bits(ops.sparse_decode_sum_op(sidx, svals, sscale, sd), sgot):
        fail("sparse_decode_sum (n=4) differs between two launches")
    del sgot
    del want
    for nw in (1, WORKERS):
        decode_phases("rand-k", sidx[:nw], svals[:nw], sscale, sd)
    idx64 = sidx.to(torch.int64)
    lib_out = torch.empty(sd, device=dev)

    def index_add_sum(nw):
        lib_out.zero_()
        for i in range(nw):
            lib_out.index_add_(0, idx64[i], svals[i] * sscale)

    n4_ms = time_ms(lambda: ops.sparse_decode_sum_op(sidx, svals, sscale, sd), 10)
    n4_note = (f"n=4: ms {n4_ms:.4f} plain_ms "
               f"{time_ms(lambda: ref.ref_sparse_decode_sum(sidx, svals, sscale, sd), 3):.4f} "
               f"bound_ms {bound(4.0 * sd + 8.0 * WORKERS * kk + 4.0 * kk, 0.0)[0]:.4f} "
               f"zero_+index_add_ ms {time_ms(lambda: index_add_sum(WORKERS), 3):.4f}")
    record("sparse_decode_sum", "src/repro_torch/csrc/sparse.cu",
           "src/repro/kernels/sparse.py:120 (pallas_call :131)", 0.0,
           time_ms(lambda: ops.sparse_decode_sum_op(*one, sscale, sd), 10),
           time_ms(lambda: ref.ref_sparse_decode_sum(*one, sscale, sd), 3),
           4.0 * sd + 12.0 * kk, 2.0 * kk,
           f"n=1 (a worker's own decode), bitwise; zero_+index_add_ ms "
           f"{time_ms(lambda: index_add_sum(1), 3):.4f}; {n4_note}, bitwise")
    sgot = ops.sparse_decode_sum_mean_op(sidx, svals, sscale, sd)
    if not same_bits(sgot, ref.ref_sparse_decode_sum_mean(sidx, svals, sscale, sd)):
        fail("sparse_decode_sum_mean (n=4) differs from the plain version")
    del sgot
    record("sparse_decode_sum_mean", "src/repro_torch/csrc/sparse.cu",
           "src/repro/kernels/sparse.py:142 (pallas_call :157)", 0.0,
           time_ms(lambda: ops.sparse_decode_sum_mean_op(sidx, svals, sscale, sd), 10),
           time_ms(lambda: ref.ref_sparse_decode_sum_mean(sidx, svals, sscale, sd), 3),
           4.0 * sd + 8.0 * WORKERS * kk + 4.0 * kk, 2.0 * WORKERS * kk + sd,
           "n=4, bitwise")
    del x, sgath, sidx, svals, sscale, one, idx64, lib_out, xi, pos, specials
    # More workers than the decode's passes take at once (512): n = 513 at a
    # small d, the second group continuing the first one's sums.
    gn, gd, gk = 513, 70001, 4099
    gidx = torch.argsort(torch.rand((gn, gd), generator=gen, device=dev), dim=1)[:, :gk]
    gidx = gidx.to(torch.int32).view(torch.uint32)
    gvals = torch.randn((gn, gk), generator=gen, device=dev)
    gvals[:, 0] = -0.0
    gscale = torch.rand(gk, generator=gen, device=dev) + 0.5
    for name, op, plain_op in (
            ("sparse_decode_sum", ops.sparse_decode_sum_op, ref.ref_sparse_decode_sum),
            ("sparse_decode_sum_mean", ops.sparse_decode_sum_mean_op,
             ref.ref_sparse_decode_sum_mean)):
        if not same_bits(op(gidx, gvals, gscale, gd), plain_op(gidx, gvals, gscale, gd)):
            fail(f"{name} (n={gn}) differs from the plain version")
    print(f"kernels: sparse_decode_sum and _mean at n={gn} (two groups of workers), d {gd}, "
          f"k {gk}: bitwise the plain versions")
    del gidx, gvals, gscale
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # --------------------------------------------------- dense kernels
    # The identity operator's payloads: four workers' values copied into the
    # rows of the gathered (4, Dp) buffer, -0.0 at the same coordinates in
    # every worker (the sum keeps it), +-inf, subnormals and FLT_MAX spliced.
    ilayout = bucket_layout(CompressionConfig(method="none", bucketed=True), meta)
    idp = ilayout.padded_size
    icomp = BucketedCompressor(IdentityCompressor(), ilayout)
    print(f"kernels: dense bucket {ilayout.n_leaves} leaves, alignment 1, Dp {idp}; "
          f"n {WORKERS}")
    x = torch.randn(idp, generator=gen, device=dev) * 1e-3
    dspecial = torch.tensor([-0.0, float("inf"), float("-inf"), 1e-40, -1e-45, 3.4028235e38],
                            device=dev).repeat(4096)
    x[torch.randperm(idp, generator=gen, device=dev)[:dspecial.numel()]] = dspecial
    ig = icomp.gathered(WORKERS, dev)
    for w in range(WORKERS):
        xw = x * (w + 1)
        icomp.compress(xw, worker_key(prng.PRNGKey(9), w), out=ig.select(w))
        if not same_bits(ig.values[w], xw):
            fail("dense_copy (inside the identity compress) differs from its input")
        del xw
    row = ig.values[1]
    if not same_bits(ops.dense_copy_op(x, out=row), ref.ref_dense_copy(x)):
        fail("dense_copy differs from the plain version")
    record("dense_copy", "src/repro_torch/csrc/dense.cu",
           "src/repro/kernels/dense.py:38 (pallas_call :41)", 0.0,
           time_ms(lambda: ops.dense_copy_op(x, out=row), 10),
           time_ms(lambda: ref.ref_dense_copy(x), 3),
           8.0 * idp, 0.0, "bitwise, into a row of the gathered buffer",
           time_ms(lambda: row.copy_(x), 10))
    # dense_copy against Tensor.copy_ interleaved: one call of each in turn,
    # 20 times, so that both read the card in the same state.
    alt = {"dense_copy": [], "copy_": []}
    for _ in range(20):
        alt["dense_copy"].append(time_ms(lambda: ops.dense_copy_op(x, out=row), 1, 0))
        alt["copy_"].append(time_ms(lambda: row.copy_(x), 1, 0))
    print("kernel dense_copy vs Tensor.copy_, 20 interleaved calls each: "
          + "; ".join(f"{k} median {statistics.median(v):.4f} ms, min {min(v):.4f}, "
                      f"max {max(v):.4f}" for k, v in alt.items()))
    ig.values[1].copy_(x * 2)
    vals = ig.values
    one = vals[:1]
    if not same_bits(ops.dense_decode_sum_op(one), ref.ref_dense_decode_sum(one)):
        fail("dense_decode_sum (n=1) differs from the plain version")
    if not same_bits(ops.dense_decode_sum_op(vals), ref.ref_dense_decode_sum(vals)):
        fail("dense_decode_sum (n=4) differs from the plain version")
    n1_note = (f"n=1: ms {time_ms(lambda: ops.dense_decode_sum_op(one), 10):.4f} plain_ms "
               f"{time_ms(lambda: ref.ref_dense_decode_sum(one), 3):.4f} bound_ms "
               f"{bound(8.0 * idp, 0.0)[0]:.4f} library sum(0) ms "
               f"{time_ms(lambda: one.sum(0), 10):.4f}")
    record("dense_decode_sum", "src/repro_torch/csrc/dense.cu",
           "src/repro/kernels/dense.py:76 (pallas_call :79)", 0.0,
           time_ms(lambda: ops.dense_decode_sum_op(vals), 10),
           time_ms(lambda: ref.ref_dense_decode_sum(vals), 3),
           (4.0 * WORKERS + 4) * idp, (WORKERS - 1.0) * idp,
           f"n=4 (the dense-sum round), bitwise; n=1 bitwise; {n1_note}",
           time_ms(lambda: vals.sum(0), 10))
    if not same_bits(ops.dense_decode_sum_mean_op(vals), ref.ref_dense_decode_sum_mean(vals)):
        fail("dense_decode_sum_mean (n=4) differs from the plain version")
    record("dense_decode_sum_mean", "src/repro_torch/csrc/dense.cu",
           "src/repro/kernels/dense.py:90 (pallas_call :95)", 0.0,
           time_ms(lambda: ops.dense_decode_sum_mean_op(vals), 10),
           time_ms(lambda: ref.ref_dense_decode_sum_mean(vals), 3),
           (4.0 * WORKERS + 4) * idp, 1.0 * WORKERS * idp, "n=4, bitwise",
           time_ms(lambda: vals.mean(0), 10))
    del x, dspecial, ig, row, vals, one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ------------------------------- the kernels at the convex harness's shapes
    # The convex harness encodes one leaf x of d = 24 (stoch_problem) or 112
    # (LogRegProblem) per worker, in blocks of 8, 16 or 64: 1-14 rows per
    # launch, 2-16 float4 groups per row; the server decodes n = 1 (a
    # worker's own decode), 4 or 10 payloads.
    for hb in (8, 16, 64):
        lines = []
        for hd in (24, 112):
            hm = -(-hd // hb)
            xs = torch.zeros((10, hm * hb), device=dev)
            xs[:, :hd] = torch.randn((10, hd), generator=gen, device=dev)
            xs[0, :4] = torch.tensor([0.0, -0.0, 1e-40, 3.4028235e38], device=dev)
            xs[1] = 0.0
            hkeys = prng.split(prng.PRNGKey(100 + hb + hd), 10)
            hpays, agree = [], 1.0
            for w in range(10):
                blocks = xs[w].reshape(hm, hb)
                kp, ks = ops.quantize_pack_prng_op(blocks, hkeys[w:w + 1], (hm,), p=math.inf)
                pp, ps_ = ref.ref_quantize_pack_prng(blocks, hkeys[w:w + 1], (hm,), math.inf)
                if not (torch.equal(kp, pp) and torch.equal(ks, ps_)):
                    fail(f"quantize_pack_prng (p=inf, B={hb}, d={hd}) differs from the plain "
                         "version")
                hpays.append((kp, ks))
                hbits = ops.segment_bits_op(hkeys[w:w + 1], [hm * hb], dev).reshape(hm, hb)
                k2, s2 = ops.quantize_pack_prng_op(blocks, hkeys[w:w + 1], (hm,), p=2.0)
                b2, bs2 = ops.quantize_pack_op(blocks, hbits, p=2.0)
                p2, ps2 = ref.ref_quantize_pack_prng(blocks, hkeys[w:w + 1], (hm,), 2.0)
                if not (torch.equal(k2, b2) and torch.equal(s2, bs2)):
                    fail(f"quantize_pack_prng (p=2, B={hb}) differs from quantize_pack fed "
                         "threefry_bits")
                codes_eq = float((torch.stack([(k2 >> t) & 3 for t in (0, 2, 4, 6)])
                                  == torch.stack([(p2 >> t) & 3 for t in (0, 2, 4, 6)]))
                                 .float().mean())
                agree = min(agree, codes_eq)
                if ulps(s2, ps2) > 4 or codes_eq < 0.9999:
                    fail(f"quantize_pack_prng (p=2, B={hb}, d={hd}) outside its tolerance")
            packed = torch.stack([k for k, _ in hpays])
            scales = torch.stack([s_ for _, s_ in hpays])
            hh = torch.randn(hd, generator=gen, device=dev)
            for hn in (1, 4, 10):
                pk, sc = packed[:hn], scales[:hn]
                check_equal(f"unpack_reduce (B={hb}, d={hd}, n={hn})",
                            ops.unpack_reduce_op(pk, sc), ref.ref_unpack_reduce(pk, sc))
                check_equal(f"unpack_reduce_mean (B={hb}, d={hd}, n={hn})",
                            ops.unpack_reduce_mean_op(pk, sc), ref.ref_unpack_reduce_mean(pk, sc))
                check_equal(f"unpack_reduce_apply (B={hb}, d={hd}, n={hn})",
                            ops.unpack_reduce_apply_op(pk, sc, hh, alpha=alpha),
                            ref.ref_unpack_reduce_apply(pk, sc, hh, alpha, hn))
            blocks = xs[2].reshape(hm, hb)
            us = {"quantize_pack_prng": time_ms(lambda: ops.quantize_pack_prng_op(
                      blocks, hkeys[2:3], (hm,), p=math.inf), 20) * 1e3,
                  "unpack_reduce n=1": time_ms(lambda: ops.unpack_reduce_op(
                      packed[:1], scales[:1]), 20) * 1e3,
                  "unpack_reduce_apply n=10": time_ms(lambda: ops.unpack_reduce_apply_op(
                      packed, scales, hh, alpha=alpha), 20) * 1e3}
            lines.append(f"d {hd} ({hm} rows): p=2 codes equal on {agree * 100:.4f}%; "
                         + ", ".join(f"{k} {v:.1f} us" for k, v in us.items()))
        print(f"harness kernels B={hb}: quantize_pack_prng p=inf bitwise the plain version "
              f"(p=2 bitwise quantize_pack fed threefry_bits, scales within 4 ulp of the plain "
              f"version), unpack_reduce / _mean / _apply at n = 1, 4, 10 bitwise; "
              + "; ".join(lines))
    del xs, packed, scales, hh, hpays

    # ---------------------------------------------------------- the convex harness
    # The paper's laws on the card through the port's harness (per leaf,
    # one leaf x), with the JAX suite's thresholds
    # (tests/test_convergence_laws.py:83-105, tests/test_downlink.py).
    def convex(label, fn, per_step, steps):
        """One harness run with the launch counts reset just before and read
        just after: exactly ``per_step`` launches on each of ``steps`` steps."""
        torch.cuda.synchronize()
        build.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        want = {k: v * steps for k, v in per_step.items()}
        print(f"convex: {label}: final loss {r['final_loss']!r}, {r['us_per_step']:.1f} us per "
              f"step; launches {counts}")
        if counts != want:
            fail(f"convex {label}: launches {counts}, expected {want}")
        return r

    prob = stoch_problem()
    nw = prob.n_workers
    ternary = {"quantize_pack_prng": nw, "unpack_reduce": nw, "unpack_reduce_apply": 1}
    fstar = convex(f"f* (none, {prob.dim}-d, n {nw}, 400 steps)",
                   lambda: {"final_loss": fstar_logreg(prob, 400),
                            "us_per_step": float("nan")},
                   {"dense_copy": nw, "dense_decode_sum_mean": 1}, 400)["final_loss"]
    gaps = {}
    for label, fn, per_step, steps in (
            ("batch", lambda: run_logreg("diana", math.inf, steps=200, gamma=1.0, block=8,
                                         problem=prob), ternary, 200),
            ("bidir", lambda: run_logreg("diana", math.inf, steps=200, gamma=1.0, block=8,
                                         problem=prob, down_method="diana"),
             {"quantize_pack_prng": nw + 1, "unpack_reduce": nw + 1, "unpack_reduce_apply": 1},
             200),
            ("diana", lambda: run_logreg_stochastic("diana", math.inf, steps=300, gamma=0.5,
                                                    block=8, problem=prob), ternary, 301),
            ("vr", lambda: run_logreg_stochastic("diana", math.inf, steps=300, gamma=0.5,
                                                 block=8, problem=prob, vr=True), ternary, 301),
            ("qsgd", lambda: run_logreg_stochastic("qsgd", 2.0, steps=300, gamma=0.5, block=8,
                                                   problem=prob),
             {"quantize_pack_prng": nw, "unpack_reduce": nw, "unpack_reduce_mean": 1}, 301)):
        r = convex(label, fn, per_step, steps)
        gaps[label] = max(r["final_loss"] - fstar, 1e-7)
    print(f"convex: stoch_problem ({prob.dim}-d, n {nw}, B 8): f* {fstar!r}; gaps {gaps}")
    laws = {"(a) batch DIANA gap < 1e-5": gaps["batch"] < 1e-5,
            "(b) VR-DIANA >= 10x below DIANA's floor": gaps["diana"] > 1e-3
            and gaps["diana"] >= 10.0 * gaps["vr"] and gaps["vr"] < 1e-4,
            "(c) QSGD stalls": gaps["qsgd"] > 1e-3 and gaps["qsgd"] >= 0.5 * gaps["diana"]
            and gaps["qsgd"] >= 10.0 * gaps["vr"],
            "bidirectional DIANA gap < 1e-5": gaps["bidir"] < 1e-5}
    print(f"convex: laws {laws}")
    if not all(laws.values()):
        fail(f"convex: a law does not hold on the card: {laws}, gaps {gaps}")
    paper = LogRegProblem()
    r10 = convex(f"{paper.name} ({paper.n_samples} x {paper.dim}, n {paper.n_workers}, B 64, "
                 "200 steps)",
                 lambda: run_logreg("diana", math.inf, steps=200, gamma=1.0, block=64,
                                    problem=paper),
                 {"quantize_pack_prng": paper.n_workers, "unpack_reduce": paper.n_workers,
                  "unpack_reduce_apply": 1}, 200)
    first, last = r10["losses"][0][1], r10["final_loss"]
    print(f"convex: {paper.name}: loss {first!r} after step 0, {last!r} after 200 steps")
    if not (math.isfinite(last) and last < first):
        fail(f"convex: the n = 10 run did not descend ({first} -> {last})")
    build.reset_launches()

    # ------------------------------------------- reference on a small input
    rcfg = reduced(get_config("llama3.2-1b"))
    rshape = ShapeConfig("smoke", 64, 4, "train")
    init = init_model(rcfg, "cpu", seed=3)
    rbatches = [{k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(rcfg, rshape, s).items()}
                for s in range(2)]

    def train_small(method, bucketed, policy):
        params = {k: torch.nn.Parameter(v.detach().to(dev, copy=True)) for k, v in init.items()}
        opt = make_optimizer(replace(rcfg, compression=method, comp_k=4096,
                                     comp_bucketed=bucketed), policy=policy)
        st = opt.init(params, 2)
        fn = build_train_step(rcfg, opt, 2, dev)
        losses = []
        for s, batch in enumerate(rbatches):
            params, st, met = fn(params, st, batch, prng.fold_in(prng.PRNGKey(0), s))
            losses.append(float(met["loss"]))
        return losses, params, st.diana

    f64 = replace(rcfg, param_dtype=torch.float64, compute_dtype=torch.float64)
    with torch.no_grad():
        loss64 = float(train_loss({k: v.to(dev, torch.float64) for k, v in init.items()},
                                  rbatches[0], f64))
    methods = ("diana", "natural", "randk", "topk_ef", "none")
    for method, bucketed, policy in ([(m, True, None) for m in methods]
                                     + [(m, False, None) for m in methods]
                                     + [("diana", True, "default")]):
        label = method + ("" if bucketed else " --per-leaf-agg") + (
            "" if policy is None else f" --comp-policy {policy}")
        build.reset_launches()
        k_loss, k_params, k_diana = train_small(method, bucketed, policy)
        kcounts = dict(build.LAUNCHES)
        on_card = ops._on_card
        ops._on_card = lambda t: False      # the same steps, every kernel -> its plain version
        try:
            p_loss, p_params, p_diana = train_small(method, bucketed, policy)
        finally:
            ops._on_card = on_card
        k_leaves, p_leaves = state_leaves(k_diana), state_leaves(p_diana)
        same = (k_loss == p_loss
                and all(torch.equal(k_params[k], p_params[k]) for k in k_params)
                and len(k_leaves) == len(p_leaves)
                and all(torch.equal(a, b) for a, b in zip(k_leaves, p_leaves)))
        print(f"reference: reduced llama3.2-1b, {label}, 2 workers, 2 steps on the card: "
              f"losses {k_loss} with the kernels, {p_loss} with the plain versions (states "
              f"bitwise equal: {same}, {len(k_leaves)} state tensors); kernel launches "
              f"{kcounts}; step-0 loss in float64 {loss64}")
        if not same:
            fail(f"the {label} training steps through the kernels differ from the plain "
                 "versions")
        if not math.isclose(k_loss[0], loss64, rel_tol=1e-5):
            fail("the float32 training loss disagrees with its float64 evaluation")
    del k_params, p_params, k_diana, p_diana, k_leaves, p_leaves, rbatches
    build.reset_launches()

    took("kernels, convex harness and reference")

    # --------------------------------------------------------- the main path
    credit = {}   # kernel name -> (launches, the path or round that ran it)
    paths_run = {}   # kernel name -> {every other path that ran it: launches}

    def also(path, counts):
        """Credit every kernel of ``counts`` with its launches on ``path``."""
        for name, n in counts.items():
            paths_run.setdefault(name, {})[path] = n

    def expect(label, counts, want, path, names):
        """Exactly the launches ``want`` in ``counts``; credit the kernels
        ``names`` (the ones this path or round is there for) to ``path``."""
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
        for name in names:
            credit[name] = (want[name], path)

    def run_path(pcfg, steps, label, after=None):
        shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
        opt = make_optimizer(pcfg)
        params, opt_state = init_train_state(pcfg, opt, WORKERS, dev)
        step_fn = build_train_step(pcfg, opt, WORKERS, dev)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in make_lm_batch(pcfg, shape, s).items()} for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        build.reset_launches()
        times, losses = [], []
        # Python's collections inside each step, timed (gc.callbacks): a full
        # one over the objects the earlier phases leave took 0.26 s inside a
        # timed step (H100 host), so each step starts from a collection,
        # untimed.  And the caching allocator's device calls per step.
        in_gc = {"ms": 0.0, "full": 0}

        def gc_clock(phase, info, started=[0.0]):
            if phase == "start":
                started[0] = time.perf_counter()
            else:
                in_gc["ms"] += (time.perf_counter() - started[0]) * 1e3
                in_gc["full"] += info["generation"] == 2
        gc.callbacks.append(gc_clock)
        alloc_keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
        for s in range(steps):
            gc.collect()
            in_gc.update(ms=0.0, full=0)
            before = torch.cuda.memory_stats()
            t0 = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, batches[s],
                                             prng.fold_in(prng.PRNGKey(0), s))
            loss = float(met["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            after_stats = torch.cuda.memory_stats()
            print(f"{label}: step {s} loss {loss:.6f} ghat_norm {float(met['ghat_norm']):.6f} "
                  f"time {times[-1]:.3f} s; gc {in_gc['ms']:.1f} ms ({in_gc['full']} full); "
                  + ", ".join(f"{k} +{after_stats.get(k, 0) - before.get(k, 0)}"
                              for k in alloc_keys))
        gc.callbacks.remove(gc_clock)
        counts = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) and 0 < x < 20 for x in losses):
            fail(f"{label}: non-finite or implausible losses {losses}")
        # One worker's forward + backward alone (no DIANA round), to split the step.
        shard = {k: v[:BATCH // WORKERS] for k, v in batches[0].items()}
        leaves = list(params.values())
        fb = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = torch.autograd.grad(train_loss(params, shard, pcfg), leaves)
            torch.cuda.synchronize()
            fb.append(time.perf_counter() - t0)
            del grads
        print(f"{label}: {pcfg.n_layers} layers, batch {BATCH} x seq {SEQ}, {WORKERS} workers, "
              f"{pcfg.compression}: step times {times} s; one worker's forward+backward "
              f"{fb[-1]} s; peak memory {peak} B (held before the path: params, state, "
              f"batches {held} B); launches {counts}")
        if after is not None:
            after(params, opt_state, step_fn, batches[-1])
        del params, opt_state, step_fn, batches
        torch.cuda.empty_cache()
        return counts

    expect("main", run_path(cfg, STEPS, "main"),
           {"quantize_pack_prng": WORKERS * STEPS, "unpack_reduce": WORKERS * STEPS,
            "unpack_reduce_apply": STEPS}, "diana (8 layers, 3 steps)",
           ("quantize_pack_prng", "unpack_reduce", "unpack_reduce_apply"))
    expect("memoryless", run_path(replace(cfg, n_layers=2, compression="terngrad"), 1,
                                  "memoryless"),
           {"quantize_pack_prng": WORKERS, "unpack_reduce_mean": 1},
           "memoryless (terngrad, 2 layers, 1 step)", ("unpack_reduce_mean",))
    expect("natural", run_path(replace(cfg, compression="natural"), STEPS, "natural"),
           {"nat_pack_prng": WORKERS * STEPS, "nat_decode_sum": WORKERS * STEPS,
            "nat_decode_sum_apply": STEPS}, "natural (8 layers, 3 steps)",
           ("nat_pack_prng", "nat_decode_sum", "nat_decode_sum_apply"))

    # The memoryless natural round over the same bucket: 4 workers encode
    # into the gathered buffer, ONE nat_decode_sum_mean gives ghat.
    mcomp = BucketedCompressor(NaturalCompressor(memory=False), nlayout)
    delta = torch.randn(nd, generator=gen, device=dev) * 1e-3
    hs = torch.zeros(nd, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    mg = mcomp.gathered(WORKERS, dev)
    for w in range(WORKERS):
        mcomp.compress(delta * (w + 1), worker_key(prng.PRNGKey(5), w), out=mg.select(w))
    ghat, hs_out = mcomp.decode_sum_apply(mg, WORKERS, nd, hs)
    torch.cuda.synchronize()
    mncounts = dict(build.LAUNCHES)
    print(f"memoryless natural: launches {mncounts}")
    expect("memoryless natural", mncounts, {"nat_pack_prng": WORKERS, "nat_decode_sum_mean": 1},
           "memoryless natural round (8-layer bucket, 4 workers)", ("nat_decode_sum_mean",))
    if hs_out is not hs or not same_bits(ghat, ref.ref_nat_decode_sum_mean(mg.packed)):
        fail("memoryless natural: ghat is not the plain mean of the decodes")
    del mcomp, delta, hs, mg, ghat, hs_out
    torch.cuda.empty_cache()

    # The pre-drawn-bits round: each worker's bucketed encode of the 8-layer
    # bucket through threefry_bits + quantize_pack / nat_pack, against the
    # in-kernel-PRNG route the trainer takes (bitwise: the same draws).
    tcomp = BucketedCompressor(TernaryCompressor(block_size=bsz), layout)
    ncomp = BucketedCompressor(NaturalCompressor(), nlayout)
    torch.cuda.synchronize()
    build.reset_launches()
    for w in range(WORKERS):
        wkey = worker_key(prng.PRNGKey(8), w)
        g = torch.randn(dp, generator=gen, device=dev) * 1e-3
        tpay = tcomp.compress(g, wkey)
        tbits = ops.segment_bits_op(prng.split(wkey, layout.n_leaves), layout.padded_sizes, dev)
        bpk, bsc = ops.quantize_pack_op(g.reshape(m, bsz), tbits.reshape(m, bsz), p=math.inf)
        if not (torch.equal(tpay.packed, bpk) and torch.equal(tpay.scales, bsc[:, 0])):
            fail(f"pre-drawn bits: worker {w}'s ternary payload differs from the PRNG route's")
        del g, tpay, tbits, bpk, bsc
        g = torch.randn(nd, generator=gen, device=dev) * 1e-3
        npay = ncomp.compress(g, wkey)
        nbits_w = ops.segment_bits_op(prng.split(wkey, nlayout.n_leaves), nlayout.padded_sizes,
                                      dev)
        if not torch.equal(npay.packed, ops.nat_pack_op(g, nbits_w)):
            fail(f"pre-drawn bits: worker {w}'s natural payload differs from the PRNG route's")
        del g, npay, nbits_w
    torch.cuda.synchronize()
    pcounts = dict(build.LAUNCHES)
    print(f"pre-drawn bits: 4 workers' bucketed ternary and natural payloads bitwise the "
          f"in-kernel-PRNG route's; launches {pcounts}")
    expect("pre-drawn bits", pcounts,
           {"quantize_pack": WORKERS, "nat_pack": WORKERS, "quantize_pack_prng": WORKERS,
            "nat_pack_prng": WORKERS,
            "threefry_bits": WORKERS * (layout.n_leaves + nlayout.n_leaves)},
           "pre-drawn-bits round (8-layer bucket, 4 workers)", ("quantize_pack", "nat_pack"))
    del tcomp, ncomp
    torch.cuda.empty_cache()

    # The sparse main paths: rand-k and top-k EF at k = 2^20 per leaf.
    scfg = replace(cfg, comp_k=COMP_K)
    sel_ms = {}

    def time_selection(comp):
        """One worker's selection over the 12 segments (threefry tags or
        |x| bits, composite keys, torch.topk), without the gather: its time
        and its transient memory above what was allocated before."""
        g = torch.randn(sd, generator=gen, device=dev) * 1e-3
        keys = prng.split(worker_key(prng.PRNGKey(7), 0), slayout.n_leaves)

        def select():
            for key, off, d in zip(keys, slayout.offsets, slayout.sizes):
                comp._select(g[off:off + d], comp._k(d), key)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        select()
        torch.cuda.synchronize()
        return time_ms(select, 3), torch.cuda.max_memory_allocated() - base

    expect("randk", run_path(replace(scfg, compression="randk"), STEPS, "randk"),
           {"threefry_bits": WORKERS * STEPS * slayout.n_leaves, "sparse_gather": WORKERS * STEPS,
            "sparse_decode_sum": (WORKERS + 1) * STEPS}, "randk (8 layers, 3 steps)",
           ("threefry_bits", "sparse_gather", "sparse_decode_sum"))
    sel_ms["randk"] = time_selection(RandKCompressor(COMP_K))
    topk = {}

    def keep_topk_payload(params, opt_state, step_fn, batch):
        """One more step (after the path's counts and peak are read) whose
        server decode's inputs are kept: a real top-k EF bucketed payload."""
        mean_op = ops.sparse_decode_sum_mean_op

        def keep(idx, values, scale, d):
            topk.update(idx=idx, values=values, scale=scale, d=d)
            return mean_op(idx, values, scale, d)
        ops.sparse_decode_sum_mean_op = keep
        try:
            step_fn(params, opt_state, batch, prng.fold_in(prng.PRNGKey(0), STEPS))
        finally:
            ops.sparse_decode_sum_mean_op = mean_op

    expect("topk_ef", run_path(replace(scfg, compression="topk_ef"), STEPS, "topk_ef",
                               keep_topk_payload),
           {"sparse_gather": WORKERS * STEPS, "sparse_decode_sum": WORKERS * STEPS,
            "sparse_decode_sum_mean": STEPS}, "topk_ef (8 layers, 3 steps)",
           ("sparse_decode_sum_mean",))
    sel_ms["topk_ef"] = time_selection(TopKEFCompressor(COMP_K))
    # The sparse kernels' rows above read a rand-k payload (uniform indices);
    # a top-k EF payload follows the gradient, so its coarse bins may be
    # uneven.  The decodes of its step on that payload:
    tidx, tvals, tscale, td = topk["idx"], topk["values"], topk["scale"], topk["d"]
    tone = (tidx[:1], tvals[:1])
    if not same_bits(ops.sparse_decode_sum_op(*tone, tscale, td),
                     ref.ref_sparse_decode_sum(*tone, tscale, td)):
        fail("sparse_decode_sum (n=1) differs from the plain version on the top-k EF payload")
    if not same_bits(ops.sparse_decode_sum_mean_op(tidx, tvals, tscale, td),
                     ref.ref_sparse_decode_sum_mean(tidx, tvals, tscale, td)):
        fail("sparse_decode_sum_mean (n=4) differs from the plain version on the top-k EF "
             "payload")
    t64 = tidx.to(torch.int64)
    t_out = torch.empty(td, device=dev)

    def index_add_topk(nw):
        t_out.zero_()
        for i in range(nw):
            t_out.index_add_(0, t64[i], tvals[i] * tscale)
    print(f"topk_ef payload (K {tidx.shape[1]} per worker): sparse_decode_sum n=1 ms "
          f"{time_ms(lambda: ops.sparse_decode_sum_op(*tone, tscale, td), 10):.4f} "
          f"(zero_+index_add_ {time_ms(lambda: index_add_topk(1), 3):.4f}); "
          f"sparse_decode_sum_mean n=4 ms "
          f"{time_ms(lambda: ops.sparse_decode_sum_mean_op(tidx, tvals, tscale, td), 10):.4f} "
          f"(zero_+index_add_, no divide {time_ms(lambda: index_add_topk(WORKERS), 3):.4f}); "
          f"bitwise")
    decode_phases("topk_ef", *tone, tscale, td)
    decode_phases("topk_ef", tidx, tvals, tscale, td, ops.sparse_decode_sum_mean_op)
    del tidx, tvals, tscale, tone, t64, t_out
    topk.clear()
    torch.cuda.empty_cache()
    print(f"selection: one worker's 12 segments, k {COMP_K} per leaf: randk "
          f"{sel_ms['randk'][0]:.3f} ms (threefry tags + top-k), {sel_ms['randk'][1]} B "
          f"transient; topk_ef {sel_ms['topk_ef'][0]:.3f} ms (|x| bits + top-k), "
          f"{sel_ms['topk_ef'][1]} B transient")

    # The uncompressed baseline: none (identity) at 32 bits per coordinate.
    expect("none", run_path(replace(cfg, compression="none"), STEPS, "none"),
           {"dense_copy": WORKERS * STEPS, "dense_decode_sum_mean": STEPS},
           "none (8 layers, 3 steps)", ("dense_copy", "dense_decode_sum_mean"))

    # The dense-sum round: the identity operator's decode_sum over a gathered
    # payload of 4 workers (no one-card trainer path sums without the mean).
    x = torch.randn(idp, generator=gen, device=dev) * 1e-3
    torch.cuda.synchronize()
    build.reset_launches()
    ig = icomp.gathered(WORKERS, dev)
    for w in range(WORKERS):
        icomp.compress(x * (w + 1), worker_key(prng.PRNGKey(10), w), out=ig.select(w))
    isum = icomp.decode_sum(ig, WORKERS)
    torch.cuda.synchronize()
    dcounts = dict(build.LAUNCHES)
    print(f"dense sum: launches {dcounts}")
    expect("dense sum", dcounts, {"dense_copy": WORKERS, "dense_decode_sum": 1},
           "dense-sum round (8-layer bucket, 4 workers)", ("dense_decode_sum",))
    if not same_bits(isum, ref.ref_dense_decode_sum(ig.values)):
        fail("dense sum: the identity decode_sum is not the plain sum of the rows")
    del x, ig, isum

    took("main")

    # The trainer runs of per-leaf, policy, elastic and schedule take
    # llama3.2-1b at PHASE_LAYERS (4 of 16), so that the script keeps its
    # time as the model axis grows; the main path above, distributed and the
    # controller keep LAYERS, and so do schedule's chunk-view kernel checks.
    def at_depth(n):
        """llama3.2-1b at ``n`` layers: its config, meta tree, and diana and
        rand-k bucket layouts."""
        c = replace(cfg, n_layers=n)
        mt = {k: torch.empty(s, dtype=c.param_dtype, device="meta")
              for k, s in param_shapes(c).items()}
        return (c, mt, bucket_layout(make_optimizer(c).compression, mt),
                bucket_layout(CompressionConfig(method="randk", k=COMP_K, bucketed=True), mt))
    full, cut = (cfg, meta, layout, slayout), at_depth(PHASE_LAYERS)
    cfg, meta, layout, slayout = cut

    # ------------------------------------------------------ the per-leaf layout
    # The in-turn trainer with --per-leaf-agg against the bucketed trainer,
    # 2 steps each from the same state, batches and keys.  The bucketed
    # run's parameters and memories stay on the card (22.5 GB at n = 4 and 8
    # layers)
    # while the per-leaf run takes its steps.
    def inturn_run(pcfg, steps, label, policy=None, participation=None, faults=None,
                   keep=None, schedule=None):
        """``steps`` in-turn steps at n = 4 on batch 8 x 4096 from the
        path's initial state; returns losses, params, optimizer state,
        launches.  ``keep(s, params, opt_state, metrics)`` runs after each
        step, outside its time; ``schedule`` (``chunk_bytes`` / ``topology``
        / ``node_size``) goes onto the policy."""
        shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
        opt = make_optimizer(pcfg, policy=policy, participation=participation)
        if schedule:
            opt.policy = opt.policy.replace(**schedule)
        params, opt_state = init_train_state(pcfg, opt, WORKERS, dev)
        step_fn = build_train_step(pcfg, opt, WORKERS, dev, faults)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in make_lm_batch(pcfg, shape, s).items()} for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        build.reset_launches()
        times, losses = [], []
        for s in range(steps):
            gc.collect()
            t0 = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, batches[s],
                                             prng.fold_in(prng.PRNGKey(0), s))
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if keep is not None:
                keep(s, params, opt_state, met)
        counts = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) and 0 < x < 20 for x in losses):
            fail(f"{label}: non-finite or implausible losses {losses}")
        print(f"{label}: {pcfg.n_layers} layers, batch {BATCH} x seq {SEQ}, {WORKERS} "
              f"workers: losses {losses}; step times {times} s; peak memory {peak} B (held "
              f"before the steps: params, state, batches and what the phase keeps {held} B); "
              f"launches {counts}")
        del batches, step_fn
        return losses, params, opt_state, counts

    n_leaves = layout.n_leaves
    perleaf_step = {
        "diana": {"quantize_pack_prng": WORKERS * n_leaves, "unpack_reduce": WORKERS * n_leaves,
                  "unpack_reduce_apply": n_leaves},
        "natural": {"nat_pack_prng": WORKERS * n_leaves, "nat_decode_sum": WORKERS * n_leaves,
                    "nat_decode_sum_apply": n_leaves},
        "randk": {"threefry_bits": WORKERS * n_leaves, "sparse_gather": WORKERS * n_leaves,
                  "sparse_decode_sum": (WORKERS + 1) * n_leaves},
        "topk_ef": {"sparse_gather": WORKERS * n_leaves, "sparse_decode_sum": WORKERS * n_leaves,
                    "sparse_decode_sum_mean": n_leaves},
        "none": {"dense_copy": WORKERS * n_leaves, "dense_decode_sum_mean": n_leaves},
    }
    for method in ("diana", "natural", "randk", "topk_ef", "none"):
        pcfg = replace(cfg, compression=method, comp_k=COMP_K)
        b_loss, b_params, b_state, _ = inturn_run(pcfg, 2, f"per-leaf: bucketed {method}")
        b_diana, pcomp = b_state.diana, make_optimizer(pcfg).compression
        stateful = pcomp.make().carries_state
        if not stateful and (b_diana.h_worker.any() or b_diana.h_server.any()):
            fail(f"per-leaf: the memoryless bucketed {method} run wrote its memories")
        kept = ({k: v.detach() for k, v in b_params.items()},
                b_diana.h_worker if stateful else None, b_diana.h_server if stateful else None)
        blayout = bucket_layout(pcomp, kept[0])
        del b_params, b_state, b_diana
        torch.cuda.empty_cache()
        l_loss, l_params, l_state, counts = inturn_run(
            replace(pcfg, comp_bucketed=False), 2, f"per-leaf: {method} --per-leaf-agg")
        want = {k: 2 * v for k, v in perleaf_step[method].items()}
        if counts != want:
            fail(f"per-leaf {method}: launches {counts}, expected {want}")
        also(f"per-leaf {method} ({PHASE_LAYERS} layers, 4 workers, 2 steps)", counts)
        b_params, b_hw, b_hs = kept
        l_hw, l_hs = l_state.diana.h_worker, l_state.diana.h_server
        same = (l_loss == b_loss and all(torch.equal(l_params[k], b_params[k]) for k in b_params))
        for p, off, size in zip(blayout.paths, blayout.offsets, blayout.sizes):
            if stateful:
                same = (same and torch.equal(l_hw[p], b_hw[:, off:off + size])
                        and torch.equal(l_hs[p], b_hs[off:off + size]))
            else:
                same = same and not (l_hw[p].any() or l_hs[p].any())
        print(f"per-leaf: {method}: losses, parameters and each leaf's h_worker rows and "
              f"h_server ({'against the bucket' if stateful else 'zero, memoryless'}) bitwise "
              f"the bucketed trainer's: {same}")
        if not same:
            fail(f"per-leaf {method}: the per-leaf trainer differs from the bucketed trainer")
        del kept, b_params, b_hw, b_hs, l_params, l_state, l_hw, l_hs
        torch.cuda.empty_cache()

    took("per-leaf")

    # ------------------------------------------------------------- the policy
    # llama3.2-1b's curated --comp-policy default: three groups in one step.
    pol_opt = make_optimizer(cfg, policy="default")
    glayout = grouped_bucket_layout(pol_opt.policy, meta)
    print(f"policy: --comp-policy default = {cfg.comp_policy!r}: groups "
          + ", ".join(f"{g} {l.n_leaves} leaves {l.size} coordinates (Dp {l.padded_size})"
                      for g, l in zip(glayout.names, glayout.layouts))
          + f"; uplink wire {policy_bits_per_dim(pol_opt.policy, glayout)!r} bits per "
          f"coordinate (policy_bits_per_dim)")
    ti = glayout.names.index("g01_topk_ef")
    tcomp, tlay = TopKEFCompressor(256), glayout.layouts[ti]
    g = torch.randn(tlay.padded_size, generator=gen, device=dev) * 1e-3
    tkeys = prng.split(prng.fold_in(worker_key(prng.PRNGKey(7), 0), GROUP_FOLD + ti),
                       tlay.n_leaves)

    def select_topk():
        for key, off, d in zip(tkeys, tlay.offsets, tlay.sizes):
            tcomp._select(g[off:off + d], tcomp._k(d), key)
    print(f"policy: one worker's top-k selection over the top-k group ({tlay.size} keys, "
          f"k 256 per leaf): {time_ms(select_topk, 3):.3f} ms")
    del g, tkeys, pol_opt
    torch.cuda.empty_cache()
    policy_step = {"dense_copy": WORKERS, "dense_decode_sum_mean": 1,
                   "sparse_gather": WORKERS, "sparse_decode_sum": WORKERS,
                   "sparse_decode_sum_mean": 1, "quantize_pack_prng": WORKERS,
                   "unpack_reduce": WORKERS, "unpack_reduce_apply": 1}
    _, p_params, p_state, counts = inturn_run(cfg, 2, "policy: in turn --comp-policy default",
                                              policy="default")
    want = {k: 2 * v for k, v in policy_step.items()}
    if counts != want:
        fail(f"policy: launches {counts}, expected {want}")
    also(f"policy default ({PHASE_LAYERS} layers, 4 workers, 2 steps)", counts)
    if sorted(p_state.diana.h_worker) != list(glayout.names):
        fail(f"policy: state groups {sorted(p_state.diana.h_worker)}")
    del p_params, p_state
    torch.cuda.empty_cache()

    took("policy (in turn)")

    # ------------------------------------------------------ the distributed path
    cfg, meta, layout, slayout = full
    glayout = grouped_bucket_layout(make_optimizer(cfg, policy="default").policy, meta)
    # A world of one over NCCL in this process: the round's all-gather (or
    # all-reduce) runs on the card; NCCL puts no two ranks on one GPU.
    try:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=dev)
    except (RuntimeError, ValueError) as e:
        fail(f"NCCL did not start a world of one on the card ({e})")
    gathers, wire_order = [], []
    nccl_gather = dist.all_gather_into_tensor

    class TimedWork:
        """An issued asynchronous gather's handle: waiting on it (the
        round's ``_Pending.wait``, which orders the compute stream after
        NCCL's) records the end event on the compute stream."""

        def __init__(self, work, end):
            self.work, self.end = work, end

        def wait(self):
            done = self.work.wait()
            self.end.record()
            return done

    def timed_gather(out, inp, group=None, async_op=False):
        """The round's all-gather, issued as the round asks, between CUDA
        events, with its bytes.  A synchronous one is bracketed in stream
        order; an asynchronous one (the chunked wire) spans from its issue
        to the compute stream's wait on it, so chunk c+1's span also holds
        chunk c's decode, issued between the two."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        work = nccl_gather(out, inp, group=group, async_op=async_op)
        gathers.append((a, b, inp.numel() * inp.element_size()))
        wire_order.append("gather")
        if async_op:
            return TimedWork(work, b)
        b.record()
        return work
    dist.all_gather_into_tensor = timed_gather
    dcredit = {}   # kernel name -> (launches, the distributed path that ran them)
    dshape = ShapeConfig("train_4k", SEQ, BATCH // WORKERS, "train")   # 2 x 4096: one worker
    per_step = {
        "diana": {"quantize_pack_prng": 1, "unpack_reduce": 1, "unpack_reduce_apply": 1},
        "natural": {"nat_pack_prng": 1, "nat_decode_sum": 1, "nat_decode_sum_apply": 1},
        "randk": {"threefry_bits": slayout.n_leaves, "sparse_gather": 1, "sparse_decode_sum": 2},
        "topk_ef": {"sparse_gather": 1, "sparse_decode_sum": 1, "sparse_decode_sum_mean": 1},
        "none": {},
    }

    def dist_run(pcfg, steps, label, step_builder, policy=None, participation=None,
                 schedule=None):
        """``steps`` steps of one worker from the path's initial state;
        returns losses, params, DIANA state, step times, peak, launches."""
        opt = make_optimizer(pcfg, policy=policy, participation=participation)
        if schedule:
            opt.policy = opt.policy.replace(**schedule)
        params, opt_state = init_train_state(pcfg, opt, 1, dev)
        step_fn = step_builder(pcfg, opt)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in make_lm_batch(pcfg, dshape, s).items()} for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        build.reset_launches()
        gathers.clear()
        times, losses = [], []
        for s in range(steps):
            gc.collect()
            t0 = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, batches[s],
                                             prng.fold_in(prng.PRNGKey(0), s))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        counts = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        wire = [(a.elapsed_time(b), nbytes) for a, b, nbytes in gathers]
        if not all(math.isfinite(x) and 0 < x < 20 for x in losses):
            fail(f"{label}: non-finite or implausible losses {losses}")
        print(f"{label}: {pcfg.n_layers} layers, batch {dshape.global_batch} x seq {SEQ}, one "
              f"worker, {pcfg.compression}: losses {losses}; step times {times} s; peak memory "
              f"{peak} B (held before the path: params, state, batches {held} B); launches "
              f"{counts}")
        del batches, step_fn
        return losses, params, opt_state.diana, counts, wire

    for method in ("diana", "natural", "randk", "topk_ef", "none"):
        pcfg = replace(cfg, compression=method, comp_k=COMP_K)
        d_loss, d_params, d_diana, counts, wire = dist_run(
            pcfg, 2, f"distributed {method}", build_distributed_step)
        want = {k: v * 2 for k, v in per_step[method].items()}
        if counts != want:
            fail(f"distributed {method}: launches {counts}, expected {want}")
        for name, n in want.items():
            dcredit.setdefault(name, (n, f"distributed {method} (world 1, 8 layers, 2 steps)"))
        # To the host, so that the in-turn run's memory lines hold only its own.
        d_params = {k: v.detach().cpu() for k, v in d_params.items()}
        d_diana = [t.cpu() for t in state_leaves(d_diana)]
        torch.cuda.empty_cache()
        if method == "none":
            if wire:
                fail("distributed none: its round all-gathered; it all-reduces")
        else:
            if len(wire) != 2:
                fail(f"distributed {method}: {len(wire)} all-gathers in 2 steps, expected 2")
            print(f"distributed {method}: all_gather_into_tensor {wire[-1][1]} B per step "
                  f"(at world 1 a device copy of the payload, not a wire), "
                  f"{[round(ms, 4) for ms, _ in wire]} ms (CUDA events around the call)")
        t_loss, t_params, t_diana, _, _ = dist_run(
            pcfg, 2, f"in turn {method} (n = 1)",
            lambda c, o: build_train_step(c, o, 1, dev))
        same = (d_loss == t_loss
                and all(torch.equal(d_params[k], t_params[k].cpu()) for k in t_params)
                and all(torch.equal(d, t.cpu()) for d, t in zip(d_diana, state_leaves(t_diana))))
        print(f"distributed {method}: losses, parameters, h_worker and h_server bitwise the "
              f"in-turn trainer's at n = 1: {same}")
        if not same:
            fail(f"distributed {method}: the world-of-one trainer differs from the in-turn "
                 "trainer at n = 1")
        del d_params, d_diana, t_params, t_diana
        torch.cuda.empty_cache()
    # VR-DIANA and the compressed downlink: the world of one over NCCL
    # against the in-turn trainer at n = 1, at full width.  VR adds a second
    # forward and backward at the worker's snapshot, no launch; a diana
    # downlink one encode and one decode of the (Dp,) bucket per step, a
    # top-k EF downlink one sparse_gather and one sparse_decode_sum.
    vr_p = resolve_vr_p(None, dshape.global_batch)
    extra_cases = (
        ("vr", "diana --vr", dict(vr=True, vr_p=vr_p), {}),
        ("downlink", "diana --down-method diana", dict(comp_down_method="diana"),
         {"quantize_pack_prng": 1, "unpack_reduce": 1}),
        ("downlink", f"diana --vr --down-method topk_ef --down-k {COMP_K}",
         dict(vr=True, vr_p=vr_p, comp_down_method="topk_ef", comp_down_k=COMP_K),
         {"sparse_gather": 1, "sparse_decode_sum": 1}))

    for tag, flags, fields, down in extra_cases:
        pcfg = replace(cfg, compression="diana", **fields)
        d_loss, d_params, d_diana, counts, wire = dist_run(
            pcfg, 2, f"{tag}: distributed {flags}", build_distributed_step)
        want = {k: 2 * (per_step["diana"].get(k, 0) + down.get(k, 0))
                for k in set(per_step["diana"]) | set(down)}
        if counts != want:
            fail(f"{tag}: distributed {flags}: launches {counts}, expected {want}")
        d_params = {k: v.detach().cpu() for k, v in d_params.items()}
        d_leaves = [t.cpu() for t in state_leaves(d_diana)]
        del d_diana
        torch.cuda.empty_cache()
        t_loss, t_params, t_diana, t_counts, _ = dist_run(
            pcfg, 2, f"{tag}: in turn {flags} (n = 1)",
            lambda c, o: build_train_step(c, o, 1, dev))
        t_leaves = state_leaves(t_diana)
        same = (d_loss == t_loss and t_counts == counts
                and all(torch.equal(d_params[k], t_params[k].cpu()) for k in t_params)
                and len(d_leaves) == len(t_leaves)
                and all(torch.equal(d, t.cpu()) for d, t in zip(d_leaves, t_leaves)))
        print(f"{tag}: {flags}: losses, parameters, h_worker, h_server"
              f"{', vr (snapshot, mu)' if pcfg.vr else ''}"
              f"{', h_down' if pcfg.comp_down_method else ''} ({len(t_leaves)} state tensors) "
              f"bitwise the in-turn trainer's at n = 1: {same}")
        if not same:
            fail(f"{tag}: {flags}: the world-of-one trainer differs from the in-turn trainer")
        del d_params, d_leaves, t_params, t_diana, t_leaves
        torch.cuda.empty_cache()
    # The curated policy in the world of one: the identity group's
    # all-reduce, one all-gather per other group, against the in-turn
    # trainer at n = 1 (its identity group dense_copy + the mean of one).
    reduces = []
    nccl_reduce = dist.all_reduce

    def counted_reduce(*args, **kw):
        reduces.append(args[0].numel())
        return nccl_reduce(*args, **kw)
    dist.all_reduce = counted_reduce
    d_loss, d_params, d_diana, counts, wire = dist_run(
        cfg, 2, "policy: distributed --comp-policy default", build_distributed_step,
        policy="default")
    dist.all_reduce = nccl_reduce
    pol_dist = {"sparse_gather": 1, "sparse_decode_sum": 1, "sparse_decode_sum_mean": 1,
                "quantize_pack_prng": 1, "unpack_reduce": 1, "unpack_reduce_apply": 1}
    want = {k: 2 * v for k, v in pol_dist.items()}
    if counts != want:
        fail(f"policy: distributed launches {counts}, expected {want}")
    also("policy default, distributed (world 1, 8 layers, 2 steps)", counts)
    # two all-gathers (top-k and ternary groups) and, besides the loss's,
    # one all-reduce of the identity group's buffer per step
    ident = glayout.layouts[glayout.names.index("g00_identity")].padded_size
    if len(wire) != 4 or reduces.count(ident) != 2:
        fail(f"policy: distributed: {len(wire)} all-gathers and all-reduces of "
             f"{reduces} elements in 2 steps, expected 4 and two of {ident}")
    print(f"policy: distributed: all_gather_into_tensor {[b for _, b in wire[:2]]} B per "
          f"step, {[round(ms, 4) for ms, _ in wire]} ms; all_reduce of {ident} f32 per step "
          f"(the identity group)")
    d_params = {k: v.detach().cpu() for k, v in d_params.items()}
    d_leaves = [t.cpu() for t in state_leaves(d_diana)]
    del d_diana
    torch.cuda.empty_cache()
    t_loss, t_params, t_diana, t_counts, _ = dist_run(
        cfg, 2, "policy: in turn --comp-policy default (n = 1)",
        lambda c, o: build_train_step(c, o, 1, dev), policy="default")
    t_leaves = state_leaves(t_diana)
    same = (d_loss == t_loss
            and all(torch.equal(d_params[k], t_params[k].cpu()) for k in t_params)
            and len(d_leaves) == len(t_leaves)
            and all(torch.equal(d, t.cpu()) for d, t in zip(d_leaves, t_leaves)))
    print(f"policy: distributed --comp-policy default: losses, parameters and every group's "
          f"h_worker and h_server ({len(t_leaves)} state tensors) bitwise the in-turn "
          f"trainer's at n = 1: {same}")
    if not same:
        fail("policy: the world-of-one grouped trainer differs from the in-turn trainer")
    del d_params, d_leaves, t_params, t_diana, t_leaves
    torch.cuda.empty_cache()
    took("distributed")

    # ------------------------------------------------------------ elastic
    cfg, meta, layout, slayout = cut
    # Elastic participation and the checksummed wire.  The knobs give the
    # step keys fold_in(PRNGKey(0), s) at n = 4 the masks 1011, 1111, 0101
    # (min_workers 3: the third step is degraded), and the fault plan
    # corrupts worker 0's wire at step 1: a non-participant, a checksum
    # exclusion and a degraded step in three steps.
    espec = ParticipationSpec(q=0.6, dropout=0.1, min_workers=3)
    eflags = "--participation-q 0.6 --participation-dropout 0.1 --min-workers 3"
    efaults = parse_faults("corrupt:step=1,worker=0")

    def elastic_launches(mets, per_worker, server):
        """The launches an elastic in-turn run makes: ``per_worker`` for
        every worker each step, the own decode (``server``'s kernel) for each
        worker whose row advances, one server sum per step."""
        want = {}
        for m in mets:
            adv = sum(bool(m["mask"][w]) and m["ok"] and (not m["valid"] or m["valid"][w])
                      for w in range(WORKERS))
            for k, v in per_worker.items():
                want[k] = want.get(k, 0) + v * WORKERS
            if server[0] is not None:
                want[server[0]] = want.get(server[0], 0) + adv
            want[server[1]] = want.get(server[1], 0) + 1
        return want

    # (1) diana at full width, 3 steps, the checksummed wire
    ekept, emets = {}, []

    def keep_diana(s, params, opt_state, met):
        d = opt_state.diana
        emets.append(met)
        print(f"elastic: diana step {s}: mask {met['mask']} ok {met['ok']} wire verdicts "
              f"{met['valid']} ghat_norm {float(met['ghat_norm'])!r}")
        if s == 0:
            if d.h_worker[1].any():
                fail("elastic: the non-participant's h_worker row moved at step 0")
            ekept["row0"] = d.h_worker[0].clone()       # one 4.09 GB row
        elif s == 1:
            if not torch.equal(d.h_worker[0], ekept.pop("row0")):
                fail("elastic: the corrupted worker's h_worker row moved at step 1")
            # step 1's state, on the host, for corrupt == churn leave
            ekept["state1"] = [t.detach().to("cpu", copy=True) for t in
                               [params[k] for k in sorted(params)]
                               + [opt_state.inner[k] for k in sorted(opt_state.inner)]
                               + state_leaves(d)]
            ekept["hs"] = d.h_server.clone()
        elif s == 2:
            if float(met["ghat_norm"]) != 0.0 or not torch.equal(d.h_server, ekept.pop("hs")):
                fail("elastic: the degraded step moved h_server or gave a non-zero ghat")
    _, e_params, e_state, counts = inturn_run(
        cfg, STEPS, f"elastic: in turn diana {eflags} --faults corrupt:step=1,worker=0",
        participation=espec, faults=efaults, keep=keep_diana)
    want = elastic_launches(emets, {"quantize_pack_prng": 1},
                            ("unpack_reduce", "unpack_reduce"))
    if [(m["mask"], m["ok"], m["valid"]) for m in emets] != [
            ([True, False, True, True], True, [True] * 4),
            ([True] * 4, True, [False, True, True, True]),
            ([False, True, False, True], False, [True] * 4)]:
        fail("elastic: the masks or verdicts are not the ones reckoned")
    if counts != want:
        fail(f"elastic diana: launches {counts}, expected {want}")
    also(f"elastic diana ({PHASE_LAYERS} layers, 4 workers, {STEPS} steps, masked)", counts)
    print("elastic: diana: the non-participant's row zero after step 0, the corrupted "
          "worker's row unchanged at step 1, h_server unchanged and ghat zero on the degraded "
          "step 2: bitwise")
    # The checksum's time on one worker's wire (the fused ternary payload).
    wire_bytes = e_state.diana.h_worker.shape[1] // 4 + 4 * (e_state.diana.h_worker.shape[1]
                                                              // cfg.comp_block)
    del e_params, e_state
    torch.cuda.empty_cache()
    wire = torch.randint(0, 256, (wire_bytes,), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    print(f"elastic: checksum of one worker's wire ({wire_bytes} B): "
          f"{time_ms(lambda: checksum_words(wire), 5):.4f} ms (host sync included), byte "
          f"bound {bound(float(wire_bytes), 0.0)[0]:.4f} ms")
    del wire

    # (2) the corrupted wire is its worker's leave: steps 0-1 again with a
    # churn leave of worker 0 at step 1 instead of the fault
    lspec = replace(espec, churn=(ChurnEvent(1, 0, "leave"),))
    _, l_params, l_state, _ = inturn_run(cfg, 2, f"elastic: in turn diana {eflags} "
                                         "(churn: worker 0 leaves at step 1)",
                                         participation=lspec)
    got = ([l_params[k] for k in sorted(l_params)]
           + [l_state.inner[k] for k in sorted(l_state.inner)] + state_leaves(l_state.diana))
    state1 = ekept.pop("state1")

    def host_equal(a, b):
        """A host tensor against a card tensor, a 4.09 GB row at a time."""
        if a.shape != b.shape:
            return False
        if a.numel() * a.element_size() <= 1 << 32:
            return torch.equal(a, b.cpu())
        return all(torch.equal(a[i], b[i].cpu()) for i in range(a.shape[0]))
    same = len(got) == len(state1) and all(host_equal(a, b) for a, b in zip(state1, got))
    print(f"elastic: corrupt == churn leave at full width: parameters, momentum and every "
          f"memory after step 1 bitwise ({len(got)} tensors): {same}")
    if not same:
        fail("elastic: the corrupted wire's step differs from its worker's churn leave")
    del l_params, l_state, got, state1
    torch.cuda.empty_cache()

    # (3) none under participation: the identity operator's masked server
    # sum, dense_decode_sum, on a trainer path
    nmets = []
    _, n_params, n_state, counts = inturn_run(
        replace(cfg, compression="none"), 2, f"elastic: in turn none {eflags}",
        participation=espec, keep=lambda s, p, o, m: nmets.append(m))
    want = elastic_launches(nmets, {"dense_copy": 1}, (None, "dense_decode_sum"))
    expect("elastic none", counts, want,
           f"elastic none ({PHASE_LAYERS} layers, 4 workers, 2 steps, masked)",
           ("dense_decode_sum",))
    also(f"elastic none ({PHASE_LAYERS} layers, 4 workers, 2 steps, masked)", counts)
    print(f"elastic: none: masks {[m['mask'] for m in nmets]}; launches {counts}")
    del n_params, n_state
    torch.cuda.empty_cache()

    # (4) the world of one over NCCL: the checksummed wire crosses
    # all_gather_into_tensor; bitwise the in-turn trainer at n = 1
    ospec = replace(espec, min_workers=1)
    d_loss, d_params, d_diana, counts, wire_t = dist_run(
        cfg, 2, f"elastic: distributed diana --participation-q 0.6 --participation-dropout 0.1 "
        "--faults corrupt:step=1,worker=0", lambda c, o: build_distributed_step(c, o, efaults),
        participation=ospec)
    if counts != {"quantize_pack_prng": 2, "unpack_reduce": 4} or len(wire_t) != 2:
        fail(f"elastic: distributed launches {counts}, {len(wire_t)} all-gathers")
    also(f"elastic distributed diana (world 1, {PHASE_LAYERS} layers, 2 steps)", counts)
    print(f"elastic: distributed: all_gather_into_tensor of the checksummed wire "
          f"{wire_t[-1][1]} B per step, {[round(ms, 4) for ms, _ in wire_t]} ms")
    d_params = {k: v.detach().cpu() for k, v in d_params.items()}
    d_leaves = [t.cpu() for t in state_leaves(d_diana)]
    del d_diana
    torch.cuda.empty_cache()
    t_loss, t_params, t_diana, _, _ = dist_run(
        cfg, 2, "elastic: in turn diana (n = 1), the same flags",
        lambda c, o: build_train_step(c, o, 1, dev, efaults), participation=ospec)
    t_leaves = state_leaves(t_diana)
    same = (d_loss == t_loss
            and all(torch.equal(d_params[k], t_params[k].cpu()) for k in t_params)
            and len(d_leaves) == len(t_leaves)
            and all(torch.equal(a, b.cpu()) for a, b in zip(d_leaves, t_leaves)))
    print(f"elastic: distributed diana with participation and a corrupted wire: losses, "
          f"parameters, h_worker and h_server bitwise the in-turn trainer's at n = 1: {same}")
    if not same:
        fail("elastic: the world-of-one elastic trainer differs from the in-turn trainer")
    del d_params, d_leaves, t_params, t_diana, t_leaves
    torch.cuda.empty_cache()

    # (5) all five operators on the reduced model at n = 4, bucketed (with
    # the fault plan) and per leaf, through the kernels against the same
    # steps through the plain versions
    ebatches = [{k: torch.from_numpy(v).to(dev) for k, v in
                 make_lm_batch(rcfg, ShapeConfig("smoke", 64, WORKERS, "train"), s).items()}
                for s in range(3)]

    def train_elastic(method, bucketed):
        params = {k: torch.nn.Parameter(v.detach().to(dev, copy=True)) for k, v in init.items()}
        opt = make_optimizer(replace(rcfg, compression=method, comp_k=4096,
                                     comp_bucketed=bucketed), participation=espec)
        st = opt.init(params, WORKERS)
        fn = build_train_step(rcfg, opt, WORKERS, dev, efaults if bucketed else None)
        losses = []
        for s, batch in enumerate(ebatches):
            params, st, met = fn(params, st, batch, prng.fold_in(prng.PRNGKey(0), s))
            losses.append(float(met["loss"]))
        return losses, params, st.diana

    for method in ("diana", "natural", "randk", "topk_ef", "none"):
        for bucketed in (True, False):
            label = method + ("" if bucketed else " --per-leaf-agg")
            build.reset_launches()
            k_loss, k_params, k_diana = train_elastic(method, bucketed)
            kcounts = dict(build.LAUNCHES)
            on_card = ops._on_card
            ops._on_card = lambda t: False
            try:
                p_loss, p_params, p_diana = train_elastic(method, bucketed)
            finally:
                ops._on_card = on_card
            k_leaves, p_leaves = state_leaves(k_diana), state_leaves(p_diana)
            same = (k_loss == p_loss
                    and all(torch.equal(k_params[k], p_params[k]) for k in k_params)
                    and len(k_leaves) == len(p_leaves)
                    and all(torch.equal(a, b) for a, b in zip(k_leaves, p_leaves)))
            print(f"elastic: reduced llama3.2-1b, {label} {eflags}"
                  f"{' --faults corrupt:step=1,worker=0' if bucketed else ''}, 4 workers, 3 "
                  f"steps on the card: losses {k_loss} with the kernels, {p_loss} with the "
                  f"plain versions (states bitwise equal: {same}); kernel launches {kcounts}")
            if not same:
                fail(f"elastic: the {label} steps through the kernels differ from the plain "
                     "versions")
            also(f"elastic reduced {label} (4 workers, 3 steps)", kcounts)
    del k_params, p_params, k_diana, p_diana, k_leaves, p_leaves, ebatches
    build.reset_launches()
    torch.cuda.empty_cache()

    took("elastic")

    # ------------------------------------------------------------ schedule
    # The chunked and hierarchical wire schedule.  (a) diana and randk with
    # --chunk-bytes 2^29 at n = 4, 2 steps each, bitwise the monolithic
    # steps from the same state, whose parameters, momentum and memories stay
    # on the card meanwhile.
    CHUNK_BYTES = 1 << 29
    chunk_paths = {}
    for method in ("diana", "randk"):
        pcfg = replace(cfg, compression=method, comp_k=COMP_K)
        clay = bucket_layout(make_optimizer(pcfg).compression, meta)
        csched = ChunkedSchedule.for_layout(clay, CHUNK_BYTES)
        nc = csched.n_chunks
        print(f"schedule: {method} --chunk-bytes {CHUNK_BYTES}: {nc} chunks of "
              f"{list(csched.chunk_sizes)} f32 elements at offsets "
              f"{list(csched.chunk_offsets)} (leaf bounds {list(csched.bounds)})")
        m_loss, m_params, m_state, _ = inturn_run(pcfg, 2, f"schedule: in turn {method} "
                                                  "(one chunk)")
        kept = ([m_params[k].detach() for k in sorted(m_params)]
                + [m_state.inner[k] for k in sorted(m_state.inner)]
                + state_leaves(m_state.diana))
        del m_params, m_state
        torch.cuda.empty_cache()
        c_loss, c_params, c_state, counts = inturn_run(
            pcfg, 2, f"schedule: in turn {method} --chunk-bytes {CHUNK_BYTES}",
            schedule=dict(chunk_bytes=CHUNK_BYTES))
        got = ([c_params[k] for k in sorted(c_params)]
               + [c_state.inner[k] for k in sorted(c_state.inner)]
               + state_leaves(c_state.diana))
        same = (c_loss == m_loss and len(got) == len(kept)
                and all(torch.equal(a, b) for a, b in zip(got, kept)))
        want = ({"quantize_pack_prng": 2 * WORKERS * nc, "unpack_reduce": 2 * WORKERS * nc,
                 "unpack_reduce_apply": 2 * nc} if method == "diana" else
                {"threefry_bits": 2 * WORKERS * slayout.n_leaves,
                 "sparse_gather": 2 * WORKERS * nc, "sparse_decode_sum": 2 * (WORKERS + 1) * nc})
        print(f"schedule: {method} chunked: losses, parameters, momentum, h_worker and "
              f"h_server bitwise the monolithic steps: {same}; launches per step "
              f"{ {k: v // 2 for k, v in counts.items()} }")
        if not same:
            fail(f"schedule: the chunked {method} steps differ from the monolithic steps")
        if counts != want:
            fail(f"schedule {method}: launches {counts}, expected {want}")
        chunk_paths[method] = nc
        also(f"chunked {method} ({nc} chunks, {PHASE_LAYERS} layers, 4 workers, 2 steps)", counts)
        del kept, got, c_params, c_state
        torch.cuda.empty_cache()

    # The kernels on chunk views of the 8-layer buckets: the second chunk of the
    # diana bucket (encode from a view of the f32 buffer, the server decode
    # into a view of h_server), and the natural and dense kernels on a view
    # one element into the buffer (4-byte, not 16-byte, aligned), each
    # against the whole-buffer call and its plain version.
    chunk_ms = {}
    _, _, layout, slayout = full
    dsched = ChunkedSchedule.for_layout(layout, CHUNK_BYTES)
    c1, o1 = dsched.chunk_layouts[1], dsched.chunk_offsets[1]
    flat = torch.randn(dp, generator=gen, device=dev) * 1e-3
    view = dsched.split(flat)[1]
    ckeys = dsched.chunk_keys(prng.split(prng.PRNGKey(11), layout.n_leaves), 1)
    rows1 = [r // bsz for r in c1.padded_sizes]
    packed, scales = ops.quantize_pack_prng_op(view.view(-1, bsz), ckeys, rows1, p=math.inf)
    pp, ps = ref.ref_quantize_pack_prng(view.view(-1, bsz), ckeys, rows1, math.inf)
    if not (torch.equal(packed, pp) and torch.equal(scales, ps)):
        fail("schedule: quantize_pack_prng on a chunk view differs from its plain version")
    chunk_ms["quantize_pack_prng"] = (time_ms(lambda: ops.quantize_pack_prng_op(
        view.view(-1, bsz), ckeys, rows1, p=math.inf), 5), f"chunk 1 of the diana bucket, "
        f"{c1.padded_size} elements at offset {o1}")
    gp = torch.stack([packed] * WORKERS)
    gs = torch.stack([scales] * WORKERS)      # (n, m, 1)
    hsv = dsched.split(torch.randn(dp, generator=gen, device=dev))[1]
    for name, fn, plain in (
            ("unpack_reduce", lambda: ops.unpack_reduce_op(gp[:1], gs[:1]),
             lambda: ref.ref_unpack_reduce(gp[:1], gs[:1])),
            ("unpack_reduce_apply", lambda: ops.unpack_reduce_apply_op(gp, gs, hsv, alpha=0.02),
             lambda: ref.ref_unpack_reduce_apply(gp, gs, hsv, 0.02, WORKERS))):
        a, b = fn(), plain()
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"schedule: {name} on a chunk view differs from its plain version")
        chunk_ms[name] = (time_ms(fn, 5), f"chunk 1, n = {1 if name == 'unpack_reduce' else 4}"
                          + (", h_server a view" if name.endswith("apply") else ""))
    del packed, scales, pp, ps, gp, gs, hsv, flat, view, a, b
    odd = nd - 1
    xv = (torch.randn(nd, generator=gen, device=dev) * 1e-3)[1:]
    nk = prng.split(prng.PRNGKey(12), 2)
    codes = ops.nat_pack_prng_op(xv, nk, [odd // 2, odd - odd // 2])
    if not torch.equal(codes, ref.ref_nat_pack_prng(xv, nk, [odd // 2, odd - odd // 2])):
        fail("schedule: nat_pack_prng on an unaligned view differs from its plain version")
    chunk_ms["nat_pack_prng"] = (time_ms(lambda: ops.nat_pack_prng_op(
        xv, nk, [odd // 2, odd - odd // 2]), 5), f"{odd} coordinates from a 4-byte-aligned "
        "view")
    ncodes = torch.stack([codes] * WORKERS)
    hn = torch.randn(nd, generator=gen, device=dev)[1:]
    for name, fn, plain in (
            ("nat_decode_sum", lambda: ops.nat_decode_sum_op(ncodes[:1]),
             lambda: ref.ref_nat_decode_sum(ncodes[:1])),
            ("nat_decode_sum_apply", lambda: ops.nat_decode_sum_apply_op(ncodes, hn, alpha=0.9),
             lambda: ref.ref_nat_decode_sum_apply(ncodes, hn, 0.9))):
        a, b = fn(), plain()
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"schedule: {name} on an unaligned view differs from its plain version")
        chunk_ms[name] = (time_ms(fn, 5), f"{odd} coordinates, h a 4-byte-aligned view"
                          if name.endswith("apply") else f"{odd} coordinates, n = 1")
    del xv, codes, ncodes, hn, a, b
    torch.cuda.empty_cache()
    dv = (torch.randn(WORKERS * nd + 1, generator=gen, device=dev))[1:].view(WORKERS, nd)
    dout = torch.empty(nd, device=dev)
    for name, fn, plain in (
            ("dense_copy", lambda: ops.dense_copy_op(dv[0], out=dout), lambda: dv[0].clone()),
            ("dense_decode_sum", lambda: ops.dense_decode_sum_op(dv),
             lambda: ref.ref_dense_decode_sum(dv)),
            ("dense_decode_sum_mean", lambda: ops.dense_decode_sum_mean_op(dv),
             lambda: ref.ref_dense_decode_sum_mean(dv))):
        if not torch.equal(fn(), plain()):
            fail(f"schedule: {name} on an unaligned view differs from its plain version")
        chunk_ms[name] = (time_ms(fn, 5), f"rows of a (4, {nd}) view 4 bytes into its buffer")
    del dv, dout
    torch.cuda.empty_cache()
    # The sparse kernels on chunk 1 of the rand-k and top-k EF buckets: each
    # worker's chunk compressed from a view of the f32 buffer into its row
    # of the chunk's stacked payload (threefry tags, selection,
    # sparse_gather; indices chunk-local), then sparse_gather on the view,
    # sparse_decode_sum at n = 1 and n = 4 (rand-k) and
    # sparse_decode_sum_mean at n = 4 (top-k EF) against the plain versions.
    ssched = ChunkedSchedule.for_layout(slayout, CHUNK_BYTES)
    s1, so1 = ssched.chunk_layouts[1], ssched.chunk_offsets[1]
    sflat = torch.randn(slayout.padded_size, generator=gen, device=dev) * 1e-3
    sview = ssched.split(sflat)[1]
    for sname, scomp in (("randk", RandKCompressor(COMP_K)), ("topk_ef", TopKEFCompressor(COMP_K))):
        cg = scomp.gathered_bucketed(s1, WORKERS, dev)
        for w in range(WORKERS):
            xw = sview * (w + 1) if sname == "randk" else sview + 1e-3 * torch.randn(
                sview.shape, generator=gen, device=dev)
            keys = ssched.chunk_keys(prng.split(worker_key(prng.PRNGKey(13), w),
                                                slayout.n_leaves), 1)
            scomp.compress_bucketed_keys(s1, xw, keys, out=cg.select(w))
            if not same_bits(cg.values[w], ref.ref_sparse_gather(xw, cg.indices[w])):
                fail(f"schedule: sparse_gather inside the {sname} chunk compress differs from "
                     "its plain version")
            del xw
        ci, cv, d1 = cg.indices, cg.values, s1.padded_size
        csc = scomp._bucket_scales(s1, dev)
        where = (f"chunk 1 of the {sname} bucket, {d1} elements at offset {so1}, K "
                 f"{cv.shape[-1]} chunk-local indices")
        if sname == "randk":
            kv = ops.sparse_gather_op(sview, ci[0])
            if not same_bits(kv, ref.ref_sparse_gather(sview, ci[0])):
                fail("schedule: sparse_gather on a chunk view differs from its plain version")
            chunk_ms["sparse_gather"] = (time_ms(lambda: ops.sparse_gather_op(
                sview, ci[0], out=kv), 5), f"{where}, from the view")
            del kv
            for nw in (1, WORKERS):
                if not same_bits(ops.sparse_decode_sum_op(ci[:nw], cv[:nw], csc, d1),
                                 ref.ref_sparse_decode_sum(ci[:nw], cv[:nw], csc, d1)):
                    fail(f"schedule: sparse_decode_sum (n={nw}) on a chunk differs from its "
                         "plain version")
            n4 = time_ms(lambda: ops.sparse_decode_sum_op(ci, cv, csc, d1), 5)
            chunk_ms["sparse_decode_sum"] = (time_ms(lambda: ops.sparse_decode_sum_op(
                ci[:1], cv[:1], csc, d1), 5), f"{where}, n = 1; n = 4 {n4:.4f} ms")
        else:
            if not same_bits(ops.sparse_decode_sum_mean_op(ci, cv, csc, d1),
                             ref.ref_sparse_decode_sum_mean(ci, cv, csc, d1)):
                fail("schedule: sparse_decode_sum_mean on a chunk differs from its plain "
                     "version")
            chunk_ms["sparse_decode_sum_mean"] = (time_ms(lambda: ops.sparse_decode_sum_mean_op(
                ci, cv, csc, d1), 5), f"{where}, n = 4")
        del cg, ci, cv, csc
    del sflat, sview
    torch.cuda.empty_cache()
    for name, (ms, note) in chunk_ms.items():
        print(f"schedule: kernel {name} on a chunk view: {ms:.4f} ms ({note})")

    # (b) the other three operators chunked, and diana hierarchical, on the
    # reduced model at n = 4: the in-turn trainer through the kernels
    # against the port's reference_step (also through the kernels) on the
    # same per-worker gradients; and reference_step on a tree whose leaf
    # sizes (384, 260, 160, 279, 70, 1) put the unaligned operators' chunks
    # at offsets that are not 16-byte aligned, the kernels against the plain
    # versions.
    def trainer_vs_reference(method, schedule, label):
        params = {k: torch.nn.Parameter(v.detach().to(dev, copy=True)) for k, v in init.items()}
        opt = make_optimizer(replace(rcfg, compression=method, comp_k=4096))
        opt.policy = opt.policy.replace(**schedule)
        st = opt.init(params, WORKERS)
        fn = build_train_step(rcfg, opt, WORKERS, dev)
        refst = reference_init({k: v.detach() for k, v in params.items()}, opt.compression,
                               WORKERS)
        paths = sorted(params)
        build.reset_launches()
        same = True
        for s in range(2):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     make_lm_batch(rcfg, ShapeConfig("smoke", 64, WORKERS, "train"), s).items()}
            grads = [torch.autograd.grad(
                train_loss(params, {k: v[w:w + 1] for k, v in batch.items()}, rcfg),
                [params[p] for p in paths]) for w in range(WORKERS)]
            stacked = {p: torch.stack([g[i] for g in grads]) for i, p in enumerate(paths)}
            key = prng.fold_in(prng.PRNGKey(0), s)
            _, refst = reference_step(stacked, refst, key, opt.compression)
            params, st, _ = fn(params, st, batch, key)
            same = (same and torch.equal(st.diana.h_worker, refst.h_worker)
                    and torch.equal(st.diana.h_server, refst.h_server))
        print(f"schedule: reduced llama3.2-1b, {label}, 4 workers, 2 steps: h_worker and "
              f"h_server bitwise reference_step on the same gradients: {same}; launches "
              f"{dict(build.LAUNCHES)}")
        if not same:
            fail(f"schedule: the {label} trainer differs from reference_step")
        also(f"reduced {label} (4 workers, 2 steps, trainer and reference_step)",
             dict(build.LAUNCHES))
    rchunk = 1 << 18
    for method in ("natural", "topk_ef", "none"):
        trainer_vs_reference(method, dict(chunk_bytes=rchunk), f"{method} --chunk-bytes {rchunk}")
    for cb in (0, rchunk):
        trainer_vs_reference("diana", dict(chunk_bytes=cb, topology="hierarchical", node_size=2),
                             f"diana --topology hierarchical --node-size 2 --chunk-bytes {cb}")
    odd_shapes = {"emb": (24, 16), "w1": (20, 13), "b1": (160,), "w2": (9, 31), "b2": (70,),
                  "s": ()}
    og = torch.Generator().manual_seed(6)
    oparams = {p: torch.randn(sh, generator=og).to(dev) for p, sh in odd_shapes.items()}
    ograds = [{p: torch.randn((WORKERS, *sh), generator=og).to(dev)
               for p, sh in odd_shapes.items()} for _ in range(2)]
    for method, kw in (("diana", dict(block_size=16)), ("natural", {}), ("randk", dict(k=9)),
                       ("topk_ef", dict(k=9)), ("none", {})):
        base = CompressionConfig(method=method, bucketed=True, chunk_bytes=300, **kw)
        for ocfg in (base, replace(base, topology="hierarchical", node_size=2)):
            osched = ChunkedSchedule.for_layout(bucket_layout(ocfg, oparams), 300)

            def ref_steps():
                st = reference_init(oparams, ocfg, WORKERS)
                for s in range(2):
                    v, st = reference_step(ograds[s], st, prng.fold_in(prng.PRNGKey(3), s), ocfg)
                return [v[p] for p in sorted(v)] + [st.h_worker, st.h_server]
            build.reset_launches()
            k_out = ref_steps()
            kcounts = dict(build.LAUNCHES)
            on_card = ops._on_card
            ops._on_card = lambda t: False
            try:
                p_out = ref_steps()
            finally:
                ops._on_card = on_card
            same = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
            label = f"{method} chunk_bytes 300" + (
                " hierarchical node_size 2" if ocfg.topology == "hierarchical" else "")
            print(f"schedule: odd tree, {label}: {osched.n_chunks} chunks at byte offsets "
                  f"{[4 * o for o in osched.chunk_offsets]}; 2 steps of reference_step at n = 4 "
                  f"through the kernels bitwise the plain versions: {same}; launches {kcounts}")
            if not same or not kcounts:
                fail(f"schedule: the odd tree's {label} round differs from its plain versions")
            also(f"odd tree {label} (reference_step, 4 workers, 2 steps)", kcounts)
    del oparams, ograds
    build.reset_launches()

    # (c) hierarchical at full width: diana --topology hierarchical
    # --node-size 2 at n = 4, 2 steps: two nodes, one encode each per step.
    hier = dict(topology="hierarchical", node_size=2)
    hchecks = []

    def keep_hier(s, params, opt_state, met):
        hw, hs = opt_state.diana.h_worker, opt_state.diana.h_server
        dup = torch.equal(hw[0], hw[1]) and torch.equal(hw[2], hw[3])
        mean = (hw[0] + hw[2]) / 2
        err = float((hs - mean).abs().max())
        scale = float(hs.abs().max())
        hchecks.append((dup, err, scale))
        print(f"schedule: hierarchical step {s}: node rows bitwise duplicates: {dup}; "
              f"max |h_server - mean of the node rows| {err!r} (max |h_server| {scale!r})")
    _, h_params, h_state, counts = inturn_run(
        cfg, 2, "schedule: in turn diana --topology hierarchical --node-size 2", keep=keep_hier,
        schedule=hier)
    want = {"quantize_pack_prng": 2 * 2, "unpack_reduce": 2 * 2, "unpack_reduce_apply": 2}
    if counts != want:
        fail(f"schedule hierarchical: launches {counts}, expected {want}")
    also(f"hierarchical diana (node_size 2, {PHASE_LAYERS} layers, 4 workers, 2 steps)", counts)
    # the invariant h_server = mean of the node rows, held to 8 f32 roundings
    # of its magnitude per step (each side's fma per step, the mean's add)
    if not all(d and e <= 8 * 2.0 ** -24 * max(sc, 1e-30) * (i + 1)
               for i, (d, e, sc) in enumerate(hchecks)):
        fail(f"schedule: hierarchical node rows or h_server out of bounds: {hchecks}")
    del h_params, h_state
    torch.cuda.empty_cache()

    # (d) the chunked world of one over NCCL: build_distributed_step with
    # --chunk-bytes 2^29, bitwise build_train_step at n = 1; each chunk's
    # all-gather timed, and the order of the gathers and the decodes.
    orig_apply = BucketedCompressor.decode_sum_apply

    def logged_apply(self, *a, **kw):
        wire_order.append("decode")
        return orig_apply(self, *a, **kw)
    BucketedCompressor.decode_sum_apply = logged_apply
    wire_order.clear()
    try:
        d_loss, d_params, d_diana, counts, wire_c = dist_run(
            cfg, 2, f"schedule: distributed diana --chunk-bytes {CHUNK_BYTES}",
            build_distributed_step, schedule=dict(chunk_bytes=CHUNK_BYTES))
    finally:
        BucketedCompressor.decode_sum_apply = orig_apply
    order0 = list(wire_order[:len(wire_order) // 2])
    nc = chunk_paths["diana"]
    want_order = ["gather", "gather"]
    for i in range(nc - 1):
        want_order += ["decode"] + (["gather"] if i + 2 < nc else [])
    want_order += ["decode"]
    print(f"schedule: distributed chunked: per step {nc} all_gather_into_tensor(async_op=True) "
          f"of {[nb for _, nb in wire_c[:nc]]} B, {[round(ms, 4) for ms, _ in wire_c]} ms "
          f"(CUDA events from each issue to the compute stream's wait on it: chunk c+1's span "
          f"holds chunk c's decode; at world 1 each gather is a device copy, and one card "
          f"cannot show a gather overlapping a decode across a wire); issue order in step 0: "
          f"{order0}")
    if order0 != want_order:
        fail(f"schedule: the chunked round's issue order {order0}, expected {want_order}")
    if counts != {"quantize_pack_prng": 2 * nc, "unpack_reduce": 2 * nc,
                  "unpack_reduce_apply": 2 * nc}:
        fail(f"schedule: distributed chunked launches {counts}")
    also(f"chunked distributed diana (world 1, {nc} chunks, {PHASE_LAYERS} layers, 2 steps)",
         counts)
    d_params = {k: v.detach().cpu() for k, v in d_params.items()}
    d_leaves = [t.cpu() for t in state_leaves(d_diana)]
    del d_diana
    torch.cuda.empty_cache()
    t_loss, t_params, t_diana, _, _ = dist_run(
        cfg, 2, f"schedule: in turn diana (n = 1) --chunk-bytes {CHUNK_BYTES}",
        lambda c, o: build_train_step(c, o, 1, dev), schedule=dict(chunk_bytes=CHUNK_BYTES))
    same = (d_loss == t_loss
            and all(torch.equal(d_params[k], t_params[k].cpu()) for k in t_params)
            and all(torch.equal(a, b.cpu()) for a, b in zip(d_leaves, state_leaves(t_diana))))
    print(f"schedule: distributed chunked: losses, parameters, h_worker and h_server bitwise "
          f"the chunked in-turn trainer's at n = 1: {same}")
    if not same:
        fail("schedule: the chunked world of one differs from the in-turn trainer")
    del d_params, d_leaves, t_params, t_diana
    torch.cuda.empty_cache()

    took("schedule")

    # ---------------------------------------------------------- controller
    cfg, meta, layout, slayout = full
    # --comp-policy default --budget-bits-per-dim 1.0 --controller-interval 1
    # --warmup-dense-steps 1 at n = 4, 3 steps: step 0 dense (identity on
    # the policy's skeleton), then the allocation; the telemetry against a
    # float64 recomputation of measure on the same f32 served direction.
    copt = make_optimizer(cfg, policy="default")
    ctl = BudgetController(base=copt.policy, budget_bits_per_dim=1.0, interval=1,
                           warmup_dense_steps=1)
    copt = train_mod._with_policy(copt, ctl.warmup_policy())
    shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
    cparams, cstate_opt = init_train_state(cfg, copt, WORKERS, dev)
    cbuild = lambda o: build_train_step(cfg, o, WORKERS, dev, telemetry=True)  # noqa: E731
    cstep = cbuild(copt)
    cstate = init_controller_state(ctl, cparams)
    exact = []
    orig_moments = train_mod.group_moments

    def moments_f64(leaves):
        """Records the float64 (m2, var) of the same leaves beside the
        telemetry's f32 ones."""
        s1 = sum(float(l.double().sum()) for l in leaves)
        s2 = sum(float(l.double().pow(2).sum()) for l in leaves)
        d = sum(l.numel() for l in leaves)
        exact.append((s2 / d, max(s2 / d - (s1 / d) ** 2, 0.0)))
        return orig_moments(leaves)
    train_mod.group_moments = moments_f64
    cbatches = [{k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(cfg, shape, s).items()}
                for s in range(STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ctimes, worst = [], 0.0
    try:
        for s in range(STEPS):
            gc.collect()
            exact.clear()
            build.reset_launches()
            t0 = time.perf_counter()
            cparams, cstate_opt, met = cstep(cparams, cstate_opt, cbatches[s],
                                             prng.fold_in(prng.PRNGKey(0), s))
            torch.cuda.synchronize()
            ctimes.append(time.perf_counter() - t0)
            counts = dict(build.LAUNCHES)
            m2, var = met["telemetry_m2"].tolist(), met["telemetry_var"].tolist()
            for (e2, ev), a2, av in zip(exact, m2, var):
                worst = max(worst, abs(a2 - e2) / e2, abs(av - ev) / e2)
            before = copt.policy
            t1 = time.perf_counter()
            copt, cstate_opt, cstep, cstate = controller_tick(
                ctl, cstate, copt, cstate_opt, cstep, met, cparams, WORKERS, cbuild)
            tick = time.perf_counter() - t1
            switched = copt.policy != before
            print(f"controller: step {s} loss {float(met['loss']):.6f} time {ctimes[-1]:.3f} s; "
                  f"telemetry m2 {m2} var {var} ok {met['telemetry_ok']}; float64 m2/var "
                  f"{exact}; launches {counts}; controller tick {tick:.3f} s"
                  + (f"; switched to {[r.spec for r in copt.policy.rules]} at "
                     f"{policy_bits_per_dim(copt.policy, cparams)!r} bits per coordinate"
                     if switched else ""))
            also(f"controller step {s} (8 layers, 4 workers)", counts)
            if s == 0 and not switched:
                fail("controller: no allocation after the dense warmup step")
            if switched and policy_bits_per_dim(copt.policy, cparams) > 1.0:
                fail("controller: the allocated policy is over its budget")
    finally:
        train_mod.group_moments = orig_moments
    peak = torch.cuda.max_memory_allocated()
    print(f"controller: {STEPS} steps {ctimes} s; peak memory {peak} B (held before the "
          f"steps {held} B); telemetry within {worst!r} (relative to m2) of float64")
    if worst > 1e-4:
        fail(f"controller: telemetry {worst} off its float64 recomputation")
    del cparams, cstate_opt, cstep, cbatches, copt
    torch.cuda.empty_cache()

    # The model's full depth: 16 layers, the distributed diana path.
    fcfg = get_config("llama3.2-1b")
    f_loss, f_params, f_diana, counts, wire = dist_run(
        fcfg, FULL_DEPTH_STEPS, "distributed full depth", build_distributed_step)
    want = {k: v * FULL_DEPTH_STEPS for k, v in per_step["diana"].items()}
    if counts != want:
        fail(f"distributed full depth: launches {counts}, expected {want}")
    print(f"distributed full depth: {f_diana.h_worker.shape[1]} coordinates; "
          f"all_gather_into_tensor {wire[-1][1]} B per step, "
          f"{[round(ms, 4) for ms, _ in wire]} ms (a device copy at world 1)")
    del f_params, f_diana
    dist.all_gather_into_tensor = nccl_gather
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    took("controller and the full depth")

    # ------------------------------------------------------------ the model families
    # (a) granite-moe-3b-a800m at full width (4 of 32 layers) with its curated
    # policy and adamw; (b) mamba2-130m cut to MAMBA_LAYERS, flat diana and its
    # policy; (c) every other registered arch, reduced, through the kernels
    # bitwise the same steps through the plain versions.
    models_t0 = time.perf_counter()

    def models_run(pcfg, steps, label, policy=None, inner="momentum"):
        """``steps`` in-turn steps at n = 4 on batch 8 x 4096; prints the
        step times, peak, held bytes and launches; returns the launches."""
        shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
        opt = make_optimizer(pcfg, policy=policy, inner=inner)
        params, opt_state = init_train_state(pcfg, opt, WORKERS, dev)
        step_fn = build_train_step(pcfg, opt, WORKERS, dev)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in make_lm_batch(pcfg, shape, s).items()} for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state_bytes = sum(x.numel() * x.element_size()
                          for x in [*params.values(), *state_leaves(opt_state.diana),
                                    *state_leaves(opt_state.inner)])
        build.reset_launches()
        times, losses = [], []
        for s in range(steps):
            gc.collect()
            t0 = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, batches[s],
                                             prng.fold_in(prng.PRNGKey(0), s))
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        n = count_params(params)
        # one worker's forward + backward alone (no DIANA round), to split the step
        shard = {k: v[:BATCH // WORKERS] for k, v in batches[0].items()}
        leaves = list(params.values())
        fb = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = torch.autograd.grad(train_loss(params, shard, pcfg), leaves)
            torch.cuda.synchronize()
            fb.append(time.perf_counter() - t0)
            del grads
        print(f"models: {label}: {pcfg.n_layers} layers, {n} parameters in {len(params)} leaves "
              f"({count_active_params(pcfg, params)} active per token), batch {BATCH} x seq "
              f"{SEQ}, {WORKERS} workers in turn, inner {inner}: losses {losses}; step times "
              f"{times} s; one worker's forward+backward {fb[-1]} s; peak memory {peak} B; held "
              f"before the steps {held} B (parameters, optimizer and DIANA state {state_bytes} "
              f"B); launches {counts}")
        if not all(math.isfinite(x) and 0 < x < 20 for x in losses):
            fail(f"models: {label}: non-finite or implausible losses {losses}")
        dts = {str(v.dtype) for k, v in params.items()
               if k.endswith(("router", "A_log", "dt_bias", "/D"))}
        if dts - {"torch.float32"}:
            fail(f"models: {label}: the router / SSD scalars are {dts}, not float32")
        del params, opt_state, step_fn, batches
        torch.cuda.empty_cache()
        return n, counts

    def per_step_want(groups, steps, nw=WORKERS):
        """The launches of ``steps`` in-turn steps of ``nw`` workers: per
        step each group's encode and own decode per worker, its server
        decode once."""
        kernels = {"identity": ({"dense_copy": nw}, {"dense_decode_sum_mean": 1}),
                   "topk_ef": ({"sparse_gather": nw, "sparse_decode_sum": nw},
                               {"sparse_decode_sum_mean": 1}),
                   "natural": ({"nat_pack_prng": nw, "nat_decode_sum": nw},
                               {"nat_decode_sum_apply": 1}),
                   "ternary": ({"quantize_pack_prng": nw, "unpack_reduce": nw},
                               {"unpack_reduce_apply": 1})}
        want = {}
        for g in groups:
            for part in kernels[g]:
                for k, v in part.items():
                    want[k] = want.get(k, 0) + v * steps
        return want

    gcfg = replace(get_config("granite-moe-3b-a800m"), n_layers=GRANITE_LAYERS)
    gmeta = meta_params(gcfg)
    glay = grouped_bucket_layout(make_optimizer(gcfg, policy="default").policy, gmeta)
    print(f"models: granite-moe-3b-a800m ({gcfg.citation}) --comp-policy default = "
          f"{gcfg.comp_policy!r}: groups "
          + ", ".join(f"{g} {l.n_leaves} leaves {l.size} coordinates"
                      for g, l in zip(glay.names, glay.layouts)))
    n, counts = models_run(gcfg, STEPS, "granite-moe-3b-a800m --comp-policy default --inner "
                           "adamw", policy="default", inner="adamw")
    want = per_step_want(("identity", "topk_ef", "natural", "ternary"), STEPS)
    if n != 566_490_624 or counts != want:
        fail(f"models: granite-moe: {n} parameters, launches {counts}, expected 566490624 "
             f"and {want}")
    also(f"granite-moe {GRANITE_LAYERS} layers --comp-policy default --inner adamw "
         f"(4 workers, {STEPS} steps)", counts)

    mcfg = replace(get_config("mamba2-130m"), n_layers=MAMBA_LAYERS)
    n, counts = models_run(mcfg, STEPS, f"mamba2-130m ({mcfg.citation}) diana block "
                           f"{mcfg.comp_block}")
    if n != 111_912_256 or counts != per_step_want(("ternary",), STEPS):
        fail(f"models: mamba2: {n} parameters, launches {counts}")
    also(f"mamba2-130m {mcfg.n_layers} layers diana (4 workers, {STEPS} steps)", counts)
    _, counts = models_run(mcfg, STEPS, f"mamba2-130m --comp-policy default = "
                           f"{mcfg.comp_policy!r}", policy="default")
    if counts != per_step_want(("identity", "topk_ef", "ternary"), STEPS):
        fail(f"models: mamba2 --comp-policy default: launches {counts}")
    also(f"mamba2-130m {mcfg.n_layers} layers --comp-policy default (4 workers, {STEPS} "
         "steps)", counts)

    mshape = ShapeConfig("smoke", 64, 4, "train")
    for arch in list_archs():
        if arch in ("granite-moe-3b-a800m", "mamba2-130m"):
            continue
        acfg = reduced(get_config(arch))
        ainit = init_model(acfg, "cpu", seed=3)
        abatches = [{k: torch.from_numpy(v).to(dev)
                     for k, v in make_lm_batch(acfg, mshape, s).items()} for s in range(2)]

        def train_arch():
            params = {k: torch.nn.Parameter(v.detach().to(dev, copy=True))
                      for k, v in ainit.items()}
            opt = make_optimizer(acfg)
            st = opt.init(params, 2)
            fn = build_train_step(acfg, opt, 2, dev)
            losses = []
            for s, batch in enumerate(abatches):
                params, st, met = fn(params, st, batch, prng.fold_in(prng.PRNGKey(0), s))
                losses.append(float(met["loss"]))
            return losses, params, st.diana

        build.reset_launches()
        k_loss, k_params, k_diana = train_arch()
        kcounts = dict(build.LAUNCHES)
        on_card = ops._on_card
        ops._on_card = lambda t: False      # the same steps, every kernel -> its plain version
        try:
            p_loss, p_params, p_diana = train_arch()
        finally:
            ops._on_card = on_card
        k_leaves, p_leaves = state_leaves(k_diana), state_leaves(p_diana)
        same = (k_loss == p_loss
                and all(torch.equal(k_params[k], p_params[k]) for k in k_params)
                and len(k_leaves) == len(p_leaves)
                and all(torch.equal(a, b) for a, b in zip(k_leaves, p_leaves)))
        print(f"models: reduced {arch} ({acfg.arch_type}, act {acfg.act}, pattern "
              f"{len(acfg.pattern)} x {acfg.n_blocks}, frontend {acfg.frontend}, h_dtype "
              f"{acfg.h_dtype}), {acfg.compression}, 2 workers, 2 steps on the card: losses "
              f"{k_loss} with the kernels, {p_loss} with the plain versions (states bitwise "
              f"equal: {same}, {len(k_leaves)} state tensors, memories "
              f"{sorted({str(x.dtype) for x in k_leaves})}); kernel launches {kcounts}")
        if not same or kcounts != per_step_want(("ternary",), 2, 2) or not all(
                math.isfinite(x) for x in k_loss):
            fail(f"models: reduced {arch}: the steps through the kernels differ from the plain "
                 f"versions, or launches {kcounts}")
        also(f"reduced {arch} (2 workers, 2 steps)", kcounts)
        del k_params, p_params, k_diana, p_diana, k_leaves, p_leaves, abatches, ainit
    torch.cuda.empty_cache()
    print(f"models: the phase took {time.perf_counter() - models_t0:.1f} s")

    # ------------------------------- the checkpoint, the tree helpers and remat="dots"
    gc.collect()
    torch.cuda.empty_cache()
    for phase in (checkpoint_phase, helpers_phase, remat_phase):
        for path, counts in phase(dev, card).items():
            also(path, counts)

    # ------------------------------------------------------------------ the model axis
    for path, counts in mesh_phase(dev, card).items():
        also(path, counts)

    # ------------------------------------------------------------------ serving
    gc.collect()
    torch.cuda.empty_cache()
    serve_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    serve_mesh_phase(dev, card)

    for r in rows:
        r["launches"], r["path"] = credit.get(r["name"], (0, None))
        if r["name"] in dcredit:
            r["distributed_launches"], r["distributed_path"] = dcredit[r["name"]]
        r["paths"] = paths_run.get(r["name"], {})
        if r["name"] in chunk_ms:
            r["chunk_view_ms"], r["chunk_view"] = chunk_ms[r["name"]]
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        fail(f"kernels never launched on their path: {missing}")

    print(f"chip_smoke: the script took {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
