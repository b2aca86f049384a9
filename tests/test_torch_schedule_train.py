"""The wire schedule in the port's trainers (``repro_torch.launch.train``),
on a narrowed ``reduced(llama3.2-1b)`` on the CPU.

* The in-turn trainer with ``chunk_bytes`` (four or more whole-leaf chunks)
  is bitwise the monolithic one after two steps, all five operators:
  parameters, ``h_worker`` and ``h_server``; and under participation with a
  fault plan (a corrupt in a later chunk).  (Chunks at odd offsets, which
  llama's leaf sizes never give, are in ``tests/test_torch_schedule.py``.)
* The hierarchical in-turn trainer (``node_size`` 2 at n = 4, chunked and
  not) leaves the memories of the port's ``reference_step`` on the same
  per-worker gradients bit for bit (``reference_step`` is held to the jitted
  JAX round in ``tests/test_torch_schedule.py``), with one encode per node.
* A chunked world of one (``build_distributed_step`` on a one-rank gloo
  group) is bitwise the chunked in-turn trainer at n = 1.
* The CLI: ``--chunk-bytes``, ``--topology hierarchical --node-size``, and
  the refusals (no ``--node-size``, a grouped policy, VR).
"""

import contextlib
import io
from dataclasses import replace

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import prng
from repro_torch.core.bucket import ChunkedSchedule
from repro_torch.core.diana import bucket_layout, reference_init, reference_step
from repro_torch.core.participation import ParticipationSpec, parse_faults
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models.transformer import init_model, train_loss

N = 4
SHAPE = ShapeConfig("t", 16, 4, "train")
CHUNK = 64 * 1024
METHODS = ("diana", "natural", "randk", "topk_ef", "none")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(method):
    return replace(reduced(get_config("llama3.2-1b")), d_model=64, n_heads=2, n_kv_heads=1,
                   head_dim=32, d_ff=128, compression=method, comp_k=512)


def _run(cfg, opt, step_fn, rows, params0, steps=2, shape=SHAPE):
    params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in params0.items()}
    state, metrics = opt.init(params, rows), []
    for s in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, shape, s).items()}
        params, state, met = step_fn(params, state, batch, prng.fold_in(prng.PRNGKey(0), s))
        metrics.append(met)
    return params, state.diana, metrics


def _same(a, b):
    assert all(torch.equal(a[0][p], b[0][p]) for p in a[0]), "params"
    assert torch.equal(a[1].h_worker, b[1].h_worker), "h_worker"
    assert torch.equal(a[1].h_server, b[1].h_server), "h_server"


def _with_schedule(opt, **kw):
    opt.policy = opt.policy.replace(**kw)
    return opt


@pytest.mark.parametrize("method", METHODS)
def test_chunked_in_turn_trainer_bitwise_monolithic(method):
    cfg = _config(method)
    params0 = init_model(cfg, "cpu", seed=1)
    mono = train.make_optimizer(cfg, lr=3e-4)
    chunked = _with_schedule(train.make_optimizer(cfg, lr=3e-4), chunk_bytes=CHUNK)
    lay = bucket_layout(chunked.compression, params0)
    sched = ChunkedSchedule.for_layout(lay, CHUNK)
    assert sched.n_chunks >= 4
    a = _run(cfg, mono, train.build_train_step(cfg, mono, N, "cpu"), N, params0)
    b = _run(cfg, chunked, train.build_train_step(cfg, chunked, N, "cpu"), N, params0)
    _same(a, b)


def test_chunked_elastic_trainer_bitwise_monolithic():
    """diana under participation (q 0.6, dropout 0.1, min 3) with a corrupt
    at a byte of a later chunk of worker 0 at step 1: the chunked wire
    excludes the worker whole, as the monolithic wire does."""
    cfg = _config("diana")
    params0 = init_model(cfg, "cpu", seed=1)
    spec = ParticipationSpec(q=0.6, dropout=0.1, min_workers=3)
    faults = parse_faults("corrupt:step=1,worker=0,byte=150000")
    outs = []
    for cb in (0, CHUNK):
        opt = _with_schedule(train.make_optimizer(cfg, lr=3e-4, participation=spec),
                             chunk_bytes=cb)
        outs.append(_run(cfg, opt, train.build_train_step(cfg, opt, N, "cpu", faults), N,
                         params0, steps=3))
    _same(*outs)
    assert outs[1][2][1]["valid"] == outs[0][2][1]["valid"] and not all(outs[1][2][1]["valid"])


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["mono", "chunked"])
@pytest.mark.parametrize("method", ["diana", "randk"])
def test_hierarchical_in_turn_trainer_bitwise_reference_step(method, chunk, monkeypatch):
    """node_size 2: the trainer's memories equal ``reference_step`` on the
    same per-worker gradients, node rows duplicated, and the encode runs
    once per node (two per step)."""
    cfg = _config(method)
    params = {k: torch.nn.Parameter(v) for k, v in init_model(cfg, "cpu", seed=1).items()}
    opt = _with_schedule(train.make_optimizer(cfg, lr=3e-4), chunk_bytes=chunk,
                         topology="hierarchical", node_size=2)
    state = opt.init(params, N)
    step_fn = train.build_train_step(cfg, opt, N, "cpu")
    ref = reference_init({p: v.detach() for p, v in params.items()}, opt.compression, N)
    encodes = []
    name = "quantize_pack_prng_op" if method == "diana" else "sparse_gather_op"
    orig = getattr(ops, name)
    monkeypatch.setattr(ops, name, lambda *a, **k: (encodes.append(1), orig(*a, **k))[1])
    paths = sorted(params)
    for s in range(2):
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, SHAPE, s).items()}
        per_worker = [torch.autograd.grad(train_loss(params, train._worker_batch(batch, w, N),
                                                     cfg), [params[p] for p in paths])
                      for w in range(N)]
        grads = {p: torch.stack([g[i] for g in per_worker]) for i, p in enumerate(paths)}
        key = prng.fold_in(prng.PRNGKey(0), s)
        encodes.clear()
        params, state, _ = step_fn(params, state, batch, key)
        n_chunks = ChunkedSchedule.for_layout(bucket_layout(opt.compression, params),
                                              chunk).n_chunks
        assert len(encodes) == 2 * n_chunks
        _, ref = reference_step(grads, ref, key, opt.compression)
        assert torch.equal(state.diana.h_worker, ref.h_worker)
        assert torch.equal(state.diana.h_server, ref.h_server)
        hw = state.diana.h_worker
        assert torch.equal(hw[0], hw[1]) and torch.equal(hw[2], hw[3]) and hw.any()


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("method", ["diana", "natural", "topk_ef"])
def test_chunked_world_of_one_bitwise_in_turn(world_of_one, method):
    cfg = _config(method)
    params0 = init_model(cfg, "cpu", seed=2)
    opt = _with_schedule(train.make_optimizer(cfg, lr=3e-4), chunk_bytes=CHUNK)
    shape = ShapeConfig("t", 16, 2, "train")
    a = _run(cfg, opt, train.build_train_step(cfg, opt, 1, "cpu"), 1, params0, shape=shape)
    b = _run(cfg, opt, train.build_distributed_step(cfg, opt), 1, params0, shape=shape)
    _same(a, b)
    assert all(torch.equal(x["loss"], y["loss"]) for x, y in zip(a[2], b[2]))


def _cli(*extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "4x1",
                    "--steps", "1", "--batch", "4", "--seq", "16", *extra])
    return buf.getvalue()


def test_cli_schedule_flags_and_refusals():
    assert "step    0 loss" in _cli("--chunk-bytes", str(CHUNK))
    assert "step    0 loss" in _cli("--topology", "hierarchical", "--node-size", "2",
                                    "--chunk-bytes", str(CHUNK))
    with pytest.raises(SystemExit, match="--node-size"):
        _cli("--topology", "hierarchical")
    with pytest.raises(NotImplementedError):
        _cli("--topology", "hierarchical", "--node-size", "2", "--comp-policy", "default")
    with pytest.raises(ValueError, match="VR"):
        _cli("--topology", "hierarchical", "--node-size", "2", "--vr")
    with pytest.raises(ValueError, match="divide"):
        _cli("--topology", "hierarchical", "--node-size", "3")
