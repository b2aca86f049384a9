"""The elastic ``torch.distributed`` round and trainer on 4 gloo ranks of
CPU processes.

* ``aggregate_distributed`` against the JAX package's ``aggregate_shardmap``
  in a ``(4, 1)`` host mesh (a JAX subprocess, as in
  ``tests/test_torch_distributed.py``), driven as
  ``tests/test_participation.py::test_elastic_distributed_bitwise_all_operators``
  drives it (``part_key = fold_in(key, PART_FOLD)``, the step, the worker
  index), on the inputs and spec of ``tests/test_torch_participation.py``
  (the 1/64 grid; q = 0.7, dropout 0.2, worker 3 leaving at step 1 and
  rejoining at step 3, ``min_workers`` 2), three rounds from ``PRNGKey(8)``
  (masks 1111, a degraded 0010, 0110):
  - with VR and each operator as its own downlink, all five operators, per
    leaf and bucketed: ghat, every rank's ``h_worker`` row, ``h_server``,
    ``h_down`` and the rank's (snapshot, mu) row bit for bit.  ``none`` is
    bitwise too: under participation it is gathered and summed, not
    all-reduced;
  - with a fault plan on the flat bucketed layout (a corrupt on worker 1 at
    step 0, a drop of worker 2 at step 2), all five operators: the
    checksummed wire crosses the all-gather, and ghat and the memories are
    bit for bit;
  - under a grouped policy (identity on ``b``, a top-k EF group with a
    top-k EF down rule on ``w``, bucketed or per leaf), four rounds from
    ``PRNGKey(5)`` (masks 1111, a degraded step, 1110, 1011): the group's
    round defers the direction's scale 4/3 into its downlink's input, one
    rounding, as the jitted round does; ghat and every group's memories bit
    for bit.
* The distributed trainer (4 ranks x 1 worker, ``build_distributed_step``)
  against the in-turn trainer at n = 4, 3 steps with
  ``--participation-q 0.6 --participation-dropout 0.1 --min-workers 3
  --faults corrupt:step=1,worker=0`` (masks 1011, 1111 with worker 0's wire
  corrupted, a degraded 0101), ``diana`` and ``none``: parameters and both
  memories bit for bit.
"""

import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.diana import DOWN_FOLD, PART_FOLD, aggregate_distributed, init_state, \
    worker_key
from repro_torch.core.participation import (ChurnEvent, FaultEvent, FaultPlan,
                                            ParticipationSpec, parse_faults, step_ctx)
from repro_torch.core.policy import CompressionPolicy, parse_rules
from repro_torch.core.vr import VRState
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import train
from repro_torch.models.transformer import init_model

ROOT = Path(__file__).resolve().parents[1]
N = 4
ROUNDS = 3
SEED = 8
CASES = {"diana": dict(block_size=16), "natural": {}, "randk": dict(k=8),
         "topk_ef": dict(k=8), "none": {}}
SHAPES = {"b": (9,), "w": (12, 5)}
SPEC = dict(q=0.7, dropout=0.2, churn=((1, 3, "leave"), (3, 3, "join")), min_workers=2)
FAULTS = (dict(step=0, worker=1, kind="corrupt"), dict(step=2, worker=2, kind="drop"))
GROUPED = "^b$=identity,*=topk_ef:k=8:layout=%s/topk_ef:k=8"
GROUPED_SEED, GROUPED_ROUNDS = 5, 4
TRAIN_METHODS = ("diana", "none")
TRAIN_SPEC = ParticipationSpec(q=0.6, dropout=0.1, min_workers=3)
TRAIN_FAULTS = "corrupt:step=1,worker=0"
TRAIN_SHAPE = ShapeConfig("t", 16, 4, "train")
TRAIN_STEPS = 3

JAX_SCRIPT = """
import sys, math
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import (ChurnEvent, CompressionConfig, CompressionPolicy, DianaState,
                        FaultEvent, FaultPlan, ParticipationSpec, VRState, aggregate_shardmap,
                        init_state, parse_rules)
from repro.core.diana import DOWN_FOLD, PART_FOLD
from repro.launch.mesh import make_mesh

CASES, SPEC, FAULTS, GROUPED = %(cases)r, %(spec)r, %(faults)r, %(grouped)r
data = np.load(sys.argv[1])
mesh = make_mesh((4, 1), ("data", "model"))
n, tmap = 4, jax.tree_util.tree_map
key = jax.random.PRNGKey(%(seed)d)
shapes = %(shapes)r
params = {p: jnp.asarray(data["params/" + p]) for p in shapes}
spec = ParticipationSpec(**{**SPEC, "churn": tuple(ChurnEvent(*c) for c in SPEC["churn"])})
plan = FaultPlan(tuple(FaultEvent(**e) for e in FAULTS))
sh = lambda t: tmap(lambda _: P("data"), t)
rep = lambda t: tmap(lambda _: P(), t)
out = {}

def save(prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            save(f"{prefix}/{k}", v)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            save(f"{prefix}/{i}", v)
    else:
        out[prefix] = np.asarray(t)

def vr_fn(cfg, st):
    def body(g_st, snap_st, mu_st, gsnap_st, mucand_st, h_w, h_s, h_d, k, step):
        own = lambda t: tmap(lambda x: x[0], t)
        widx = jax.lax.axis_index("data")
        stl = DianaState(h_w, h_s, VRState(snapshot=snap_st, mu=mu_st), h_d)
        ghat, ns = aggregate_shardmap(
            own(g_st), stl, jax.random.fold_in(k, widx), cfg, axis_names=("data",),
            n_workers=n, vr_aux=(own(gsnap_st), own(mucand_st)), params_local=params,
            down_key=jax.random.fold_in(k, DOWN_FOLD),
            part_key=jax.random.fold_in(k, PART_FOLD), step=step, worker_index=widx)
        return ghat, ns.h_worker, ns.h_server, ns.h_down, ns.vr.snapshot, ns.vr.mu
    hd = rep(st.h_down)
    return shard_map(body, mesh=mesh,
        in_specs=(sh(params), sh(params), sh(params), sh(params), sh(params),
                  sh(st.h_worker), rep(st.h_server), hd, P(), P()),
        out_specs=(rep(params), sh(st.h_worker), rep(st.h_server), hd, sh(params), sh(params)),
        axis_names={"data"}, check_vma=False)

def fault_fn(cfg, st):
    def body(g_st, h_w, h_s, k, step):
        widx = jax.lax.axis_index("data")
        ghat, ns = aggregate_shardmap(
            tmap(lambda x: x[0], g_st), DianaState(h_w, h_s), jax.random.fold_in(k, widx), cfg,
            axis_names=("data",), n_workers=n, part_key=jax.random.fold_in(k, PART_FOLD),
            step=step, worker_index=widx, faults=plan)
        return ghat, ns.h_worker, ns.h_server
    return shard_map(body, mesh=mesh,
        in_specs=(sh(params), sh(st.h_worker), rep(st.h_server), P(), P()),
        out_specs=(rep(params), sh(st.h_worker), rep(st.h_server)),
        axis_names={"data"}, check_vma=False)

def grouped_fn(pol, st):
    def body(g_st, h_w, h_s, h_d, k, step):
        widx = jax.lax.axis_index("data")
        ghat, ns = aggregate_shardmap(
            tmap(lambda x: x[0], g_st), DianaState(h_w, h_s, None, h_d),
            jax.random.fold_in(k, widx), pol, axis_names=("data",), n_workers=n,
            down_key=jax.random.fold_in(k, DOWN_FOLD), part_key=jax.random.fold_in(k, PART_FOLD),
            step=step, worker_index=widx)
        return ghat, ns.h_worker, ns.h_server, ns.h_down
    hd = rep(st.h_down)
    return shard_map(body, mesh=mesh,
        in_specs=(sh(params), sh(st.h_worker), rep(st.h_server), hd, P(), P()),
        out_specs=(rep(params), sh(st.h_worker), rep(st.h_server), hd),
        axis_names={"data"}, check_vma=False)

tree = lambda name, r: {p: jnp.asarray(data[f"{name}/{p}{r}"]) for p in shapes}
for layout in ("bucketed", "perleaf"):
    pol = CompressionPolicy(rules=parse_rules(GROUPED %% layout), bucketed=True,
                            participation=spec)
    st = init_state(params, pol, n)
    hw, hs, hd = st.h_worker, st.h_server, st.h_down
    f = jax.jit(grouped_fn(pol, st))
    for r in range(%(grouped_rounds)d):
        ghat, hw, hs, hd = f(tree("gg", r), hw, hs, hd,
                             jax.random.fold_in(jax.random.PRNGKey(%(grouped_seed)d), r),
                             jnp.int32(r))
        for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs), ("hd", hd)):
            save(f"grouped/{layout}/{r}/{name}", t)
for method, kw in CASES.items():
    for layout in ("bucketed", "perleaf"):
        cfg = CompressionConfig(method=method, p=math.inf, bucketed=layout == "bucketed",
                                use_kernel=False, participation=spec, vr=True, vr_p=0.5,
                                down_method=method, down_k=kw.get("k"), **kw)
        st = init_state(params, cfg, n)
        hw, hs, hd = st.h_worker, st.h_server, st.h_down
        snap = {p: jnp.asarray(data[f"snap/{p}"]) for p in shapes}
        mu = {p: jnp.asarray(data[f"mu/{p}"]) for p in shapes}
        f = jax.jit(vr_fn(cfg, st))
        for r in range(%(rounds)d):
            ghat, hw, hs, hd, snap, mu = f(tree("g", r), snap, mu, tree("gsnap", r),
                                           tree("mucand", r), hw, hs, hd,
                                           jax.random.fold_in(key, r), jnp.int32(r))
            for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs), ("hd", hd),
                            ("snap", snap), ("mu", mu)):
                save(f"vrdown/{method}/{layout}/{r}/{name}", t)
    cfg = CompressionConfig(method=method, p=math.inf, bucketed=True, use_kernel=False,
                            participation=spec, **kw)
    st = init_state(params, cfg, n)
    hw, hs = st.h_worker, st.h_server
    f = jax.jit(fault_fn(cfg, st))
    for r in range(%(rounds)d):
        ghat, hw, hs = f(tree("g", r), hw, hs, jax.random.fold_in(key, r), jnp.int32(r))
        for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs)):
            save(f"faults/{method}/{r}/{name}", t)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """Parameters, snapshots and mu, and each round's gradients, gradients
    at the snapshots and mu candidates, on the 1/64 grid."""
    rng = np.random.default_rng(13)

    def grid(shape):
        return (np.round(rng.standard_normal(shape) * 64) / 64).astype(np.float32)
    data = {}
    for p, s in SHAPES.items():
        data[f"params/{p}"] = grid(s)
        data[f"snap/{p}"], data[f"mu/{p}"] = grid((N, *s)), grid((N, *s))
        for r in range(ROUNDS):
            for name in ("g", "gsnap", "mucand"):
                data[f"{name}/{p}{r}"] = grid((N, *s))
    rng = np.random.default_rng(14)    # the grouped rounds' own gradients
    for p, s in SHAPES.items():
        for r in range(GROUPED_ROUNDS):
            data[f"gg/{p}{r}"] = grid((N, *s))
    return data


def _spec():
    return ParticipationSpec(**{**SPEC, "churn": tuple(ChurnEvent(*c) for c in SPEC["churn"])})


def _train_config(method):
    return replace(reduced(get_config("llama3.2-1b")), d_model=64, n_heads=2, n_kv_heads=1,
                   head_dim=32, d_ff=128, compression=method, comp_k=512)


def _save(out, prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            _save(out, f"{prefix}/{k}", v)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            _save(out, f"{prefix}/{i}", v)
    else:
        out[prefix] = t.detach().numpy()


def _rank_main(rank, tmp, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, N), rank=rank, world_size=N)
    tmp = Path(tmp)
    data = np.load(tmp / "inputs.npz")
    own = lambda name, r: {p: torch.from_numpy(data[f"{name}/{p}{r}"][rank].copy())  # noqa: E731
                           for p in SHAPES}
    params = {p: torch.from_numpy(data[f"params/{p}"]) for p in SHAPES}
    plan = FaultPlan(tuple(FaultEvent(**e) for e in FAULTS))
    out, calls = {}, {}
    for method, kw in CASES.items():
        for layout in ("bucketed", "perleaf"):
            cfg = CompressionConfig(method=method, bucketed=layout == "bucketed",
                                    participation=_spec(), vr=True, vr_p=0.5,
                                    down_method=method, down_k=kw.get("k"), **kw)
            st = init_state(params, cfg, 1)
            st = st._replace(vr=VRState(
                snapshot={p: torch.from_numpy(data[f"snap/{p}"][rank:rank + 1].copy())
                          for p in SHAPES},
                mu={p: torch.from_numpy(data[f"mu/{p}"][rank:rank + 1].copy()) for p in SHAPES}))
            for r in range(ROUNDS):
                k = prng.fold_in(prng.PRNGKey(SEED), r)
                ghat, st = aggregate_distributed(
                    own("g", r), st, worker_key(k, rank), cfg,
                    vr_aux=(own("gsnap", r), own("mucand", r)), params_local=params,
                    down_key=prng.fold_in(k, DOWN_FOLD), part_key=prng.fold_in(k, PART_FOLD),
                    step=r)
                for name, t in (("ghat", ghat), ("hw", st.h_worker), ("hs", st.h_server),
                                ("hd", st.h_down), ("snap", st.vr.snapshot), ("mu", st.vr.mu)):
                    _save(out, f"vrdown/{method}/{layout}/{r}/{name}", t)
        cfg = CompressionConfig(method=method, bucketed=True, participation=_spec(), **kw)
        st = init_state(params, cfg, 1)
        for r in range(ROUNDS):
            k = prng.fold_in(prng.PRNGKey(SEED), r)
            names = []
            orig = dist.all_gather_into_tensor

            def counted(*a, _orig=orig, **kw2):
                names.append(tuple(a[1].shape))
                return _orig(*a, **kw2)
            dist.all_gather_into_tensor = counted
            try:
                ghat, st = aggregate_distributed(own("g", r), st, worker_key(k, rank), cfg,
                                                 part_key=prng.fold_in(k, PART_FOLD), step=r,
                                                 faults=plan)
            finally:
                dist.all_gather_into_tensor = orig
            calls[f"{method}/{r}"] = names
            for name, t in (("ghat", ghat), ("hw", st.h_worker), ("hs", st.h_server)):
                _save(out, f"faults/{method}/{r}/{name}", t)
    for layout in ("bucketed", "perleaf"):
        pol = CompressionPolicy(rules=parse_rules(GROUPED % layout), bucketed=True,
                                participation=_spec())
        st = init_state(params, pol, 1)
        for r in range(GROUPED_ROUNDS):
            k = prng.fold_in(prng.PRNGKey(GROUPED_SEED), r)
            ghat, st = aggregate_distributed(own("gg", r), st, worker_key(k, rank), pol,
                                             down_key=prng.fold_in(k, DOWN_FOLD),
                                             part_key=prng.fold_in(k, PART_FOLD), step=r)
            for name, t in (("ghat", ghat), ("hw", st.h_worker), ("hs", st.h_server),
                            ("hd", st.h_down)):
                _save(out, f"grouped/{layout}/{r}/{name}", t)
    # the elastic distributed trainer, 3 steps from the same initial state
    for method in TRAIN_METHODS:
        cfg = _train_config(method)
        opt = train.make_optimizer(cfg, lr=3e-4, participation=TRAIN_SPEC)
        tparams = init_model(cfg, "cpu", seed=1)
        state = opt.init(tparams, 1)
        step_fn = train.build_distributed_step(cfg, opt, parse_faults(TRAIN_FAULTS))
        for s in range(TRAIN_STEPS):
            batch = {k: torch.from_numpy(v)
                     for k, v in make_lm_batch(cfg, TRAIN_SHAPE, s).items()}
            tparams, state, _ = step_fn(tparams, state, batch, prng.fold_in(prng.PRNGKey(0), s))
        _save(out, f"train/{method}/params", tparams)
        _save(out, f"train/{method}/hw", state.diana.h_worker)
        _save(out, f"train/{method}/hs", state.diana.h_server)
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(calls))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_dist")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT % dict(cases=CASES, spec=SPEC, faults=FAULTS, seed=SEED,
                               shapes=SHAPES, rounds=ROUNDS, grouped=GROUPED,
                               grouped_seed=GROUPED_SEED, grouped_rounds=GROUPED_ROUNDS)
    jproc = subprocess.Popen([sys.executable, "-c", script, str(tmp / "inputs.npz"),
                              str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        ctx = mp.start_processes(_rank_main, args=(str(tmp), str(tmp / "store")), nprocs=N,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + 400
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError("the gloo ranks did not finish in 400 s")
    finally:
        jout, jerr = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, f"stdout:\n{jout}\nstderr:\n{jerr[-3000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
    calls = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N)]
    return dict(np.load(tmp / "jax.npz")), ranks, calls


def _check(jax_out, ranks, prefix):
    keys = [k for k in jax_out if k.startswith(prefix)]
    assert keys, prefix
    for k in keys:
        name = k.split("/")[4 if prefix.startswith("vrdown") else 3]
        for rank in range(N):
            got = ranks[rank][k]
            want = (jax_out[k][rank:rank + 1] if name in ("hw", "snap", "mu") else jax_out[k])
            assert got.dtype == want.dtype and got.shape == want.shape, (k, rank)
            assert got.tobytes() == want.tobytes(), (k, rank, float(np.abs(got - want).max()))


@pytest.mark.parametrize("layout", ["bucketed", "perleaf"])
@pytest.mark.parametrize("method", list(CASES))
def test_elastic_vr_downlink_bitwise_aggregate_shardmap(runs, method, layout):
    jax_out, ranks, _ = runs
    _check(jax_out, ranks, f"vrdown/{method}/{layout}/")


@pytest.mark.parametrize("method", list(CASES))
def test_elastic_faults_bitwise_aggregate_shardmap(runs, method):
    """The checksummed wire: one all-gather of a 1-D uint8 wire (the fused
    payload plus the 8-byte tail) per round."""
    jax_out, ranks, calls = runs
    _check(jax_out, ranks, f"faults/{method}/")
    for c in calls:
        for r in range(ROUNDS):
            (shape,) = c[f"{method}/{r}"]
            assert len(shape) == 2 and shape[1] == 1, shape   # (L + 8, 1) bytes


@pytest.mark.parametrize("layout", ["bucketed", "perleaf"])
def test_elastic_grouped_topk_ef_downlink_bitwise_aggregate_shardmap(runs, layout):
    """Three participants (scale 4/3) at rounds 2 and 3 of ``PRNGKey(5)``."""
    jax_out, ranks, _ = runs
    _check(jax_out, ranks, f"grouped/{layout}/")
    assert any(k.startswith(f"grouped/{layout}/3/hd/") for k in jax_out)
    masks = [step_ctx(_spec(), prng.fold_in(prng.fold_in(prng.PRNGKey(GROUPED_SEED), r),
                                            PART_FOLD), N, r) for r in range(GROUPED_ROUNDS)]
    assert [int(m.mask.sum()) for m in masks if m.ok][1:] == [3, 3]


@pytest.mark.parametrize("method", TRAIN_METHODS)
def test_elastic_distributed_trainer_bitwise_in_turn(runs, method):
    _, ranks, _ = runs
    cfg = _train_config(method)
    opt = train.make_optimizer(cfg, lr=3e-4, participation=TRAIN_SPEC)
    params = init_model(cfg, "cpu", seed=1)
    state = opt.init(params, N)
    step_fn = train.build_train_step(cfg, opt, N, "cpu", parse_faults(TRAIN_FAULTS))
    masks = []
    for s in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, TRAIN_SHAPE, s).items()}
        params, state, met = step_fn(params, state, batch, prng.fold_in(prng.PRNGKey(0), s))
        masks.append((met["mask"], met["ok"], met["valid"]))
    assert masks[1] == ([True] * 4, True, [False, True, True, True]) and not masks[2][1]
    for rank in range(N):
        got = ranks[rank]
        for p, v in params.items():
            assert got[f"train/{method}/params/{p}"].tobytes() == v.detach().numpy().tobytes(), \
                (rank, p)
        assert got[f"train/{method}/hw"].tobytes() == \
            state.diana.h_worker[rank:rank + 1].numpy().tobytes(), rank
        assert got[f"train/{method}/hs"].tobytes() == state.diana.h_server.numpy().tobytes()
