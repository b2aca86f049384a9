"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit and the torch / CUDA versions;
2. build: compiles every kernel source of ``src/repro_torch/csrc`` (one nvcc
   each, in parallel) into ``build/torch_kernels/``;
3. kernels: each kernel's wrapper on the card at the trainer's shapes (the
   8-layer full-width llama3.2-1b bucket, B = 2048, n = 4 workers), held
   against its plain PyTorch version on the same inputs: threefry bits,
   ``unpack_reduce``, ``_mean`` and ``_apply`` bitwise, ``quantize_pack``
   bitwise for p = inf and, for p in {1, 2}, scales within 4 ulp and codes
   equal on >= 99.99% of coordinates.  Median time (CUDA events) of kernel
   and plain version, and the bound (bytes over HBM bandwidth, or operations
   over the peak rate);
4. reference: two training steps of ``reduced(llama3.2-1b)`` (f32) on the
   card through the kernels, against the same steps with every kernel
   swapped for its plain version (bitwise: losses, parameters, memories),
   and the step-0 loss against its float64 evaluation (rel 1e-5);
5. the main path: the trainer's ``build_train_step`` on llama3.2-1b at full width
   (d_model 2048, 32/8 heads, d_ff 8192, vocab 128256, bf16, remat full),
   cut to 8 of 16 layers and a global batch of 8 at seq 4096, 4 workers,
   ``diana``, 3 steps; launch counters reset just before and read just
   after: 4 quantize_pack, 4 unpack_reduce (each worker's own decode) and 1
   unpack_reduce_apply per step;
6. the memoryless path (``terngrad``, 2 layers, 1 step): ``unpack_reduce_mean``.

Then one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak memory rate
F32_OPS_PER_S = 67e12          # H100 SXM non-tensor f32 peak; taken for 32-bit int ops too
LAYERS, BATCH, SEQ, WORKERS, STEPS = 8, 8, 4096, 4, 3


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


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def main() -> None:
    # ---------------------------------------------------------------- device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import ShapeConfig, get_config, reduced
        from repro_torch.core import prng
        from repro_torch.core.compressors.ternary import TernaryCompressor
        from repro_torch.core.diana import bucket_layout
        from repro_torch.data.pipeline import make_lm_batch
        from repro_torch.kernels import build, ops, ref
        from repro_torch.launch.train import build_train_step, init_train_state, make_optimizer
        from repro_torch.models.transformer import init_model, param_shapes, train_loss
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

    # ----------------------------------------------------------------- build
    lib = build.library()
    print(f"build: {lib.seconds:.2f} s for {len(build.SOURCES)} sources into "
          f"{build.BUILD_DIR.relative_to(ROOT)}")
    for line in lib.log.splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"build: {line.strip()}")

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

    def record(name, source, replaces, err, ms, plain_ms, nbytes, ops_count, note=""):
        b_ms, b_by = bound(nbytes, ops_count)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        print(f"kernel {name}: max_abs_err {err} ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by}) {note}")

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
           4.0 * words, 78.0 * words, f"bitwise, {words} words")
    del got, want

    # quantize_pack over the whole bucket
    delta = torch.randn((m, bsz), generator=gen, device=dev)
    delta *= torch.rand((m, 1), generator=gen, device=dev) * 1e-2
    delta[:7] = 0.0
    bits = comp._batched_bits(prng.split(key, layout.n_leaves),
                              [ps // bsz for ps in layout.padded_sizes], dev)
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
    del bits

    # the decode and server kernels, on payloads the kernel just produced
    pays = []
    for w in range(WORKERS):
        k = prng.split(prng.fold_in(prng.PRNGKey(0), w), layout.n_leaves)
        b = comp._batched_bits(k, [ps // bsz for ps in layout.padded_sizes], dev)
        pk, sc = ops.quantize_pack_op(delta * (w + 1), b, p=math.inf)
        pays.append((pk, sc))
        del b
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

    # ------------------------------------------- reference on a small input
    rcfg = reduced(get_config("llama3.2-1b"))
    rshape = ShapeConfig("smoke", 64, 4, "train")
    init = init_model(rcfg, "cpu", seed=3)
    rbatches = [{k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(rcfg, rshape, s).items()}
                for s in range(2)]

    def train_small():
        params = {k: torch.nn.Parameter(v.detach().to(dev, copy=True)) for k, v in init.items()}
        opt = make_optimizer(rcfg)
        st = opt.init(params, 2)
        fn = build_train_step(rcfg, opt, 2, dev)
        losses = []
        for s, batch in enumerate(rbatches):
            params, st, met = fn(params, st, batch, prng.fold_in(prng.PRNGKey(0), s))
            losses.append(float(met["loss"]))
        return losses, params, st.diana

    k_loss, k_params, k_diana = train_small()
    on_card = ops._on_card
    ops._on_card = lambda t: False      # the same steps, every kernel -> its plain version
    try:
        p_loss, p_params, p_diana = train_small()
    finally:
        ops._on_card = on_card
    same = (k_loss == p_loss and all(torch.equal(k_params[k], p_params[k]) for k in k_params)
            and torch.equal(k_diana.h_worker, p_diana.h_worker)
            and torch.equal(k_diana.h_server, p_diana.h_server))
    f64 = replace(rcfg, param_dtype=torch.float64, compute_dtype=torch.float64)
    with torch.no_grad():
        loss64 = float(train_loss({k: v.to(dev, torch.float64) for k, v in init.items()},
                                  rbatches[0], f64))
    print(f"reference: reduced llama3.2-1b, 2 workers, 2 steps on the card: losses {k_loss} "
          f"with the kernels, {p_loss} with the plain versions (states bitwise equal: {same}); "
          f"step-0 loss in float64 {loss64}")
    if not same:
        fail("the training steps through the kernels differ from the plain versions")
    if not math.isclose(k_loss[0], loss64, rel_tol=1e-5):
        fail("the float32 training loss disagrees with its float64 evaluation")
    del k_params, p_params, k_diana, p_diana, rbatches
    build.reset_launches()

    # --------------------------------------------------------- the main path
    def run_path(pcfg, steps, label):
        shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
        opt = make_optimizer(pcfg)
        params, opt_state = init_train_state(pcfg, opt, WORKERS, dev)
        step_fn = build_train_step(pcfg, opt, WORKERS, dev)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in make_lm_batch(pcfg, shape, s).items()} for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        times, losses = [], []
        for s in range(steps):
            t0 = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, batches[s],
                                             prng.fold_in(prng.PRNGKey(0), s))
            loss = float(met["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            print(f"{label}: step {s} loss {loss:.6f} ghat_norm {float(met['ghat_norm']):.6f} "
                  f"time {times[-1]:.3f} s")
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
              f"{fb[-1]} s; peak memory {peak} B; launches {counts}")
        del params, opt_state, step_fn, batches
        torch.cuda.empty_cache()
        return counts

    counts = run_path(cfg, STEPS, "main")
    want = {"quantize_pack": WORKERS * STEPS, "unpack_reduce": WORKERS * STEPS,
            "unpack_reduce_apply": STEPS, "threefry_bits": WORKERS * STEPS * layout.n_leaves}
    for name, n in want.items():
        if counts.get(name, 0) != n:
            fail(f"main: {name} launched {counts.get(name, 0)} times, expected {n}")
    for r in rows:
        r["launches"] = counts.get(r["name"], 0)

    mcounts = run_path(replace(cfg, n_layers=2, compression="terngrad"), 1,
                                "memoryless")
    if mcounts.get("unpack_reduce_mean", 0) != 1 or mcounts.get("quantize_pack", 0) != WORKERS:
        fail(f"memoryless: launches {mcounts}, expected 1 unpack_reduce_mean")
    for r in rows:
        if r["name"] == "unpack_reduce_mean":
            r["launches"] = mcounts["unpack_reduce_mean"]
            r["path"] = "memoryless (terngrad, 2 layers, 1 step)"
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        fail(f"kernels never launched on their path: {missing}")

    print(json.dumps({"kernels": rows}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
