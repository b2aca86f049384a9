"""The shard-local per-leaf round on a (2, 2) mesh: 4 gloo ranks of CPU
processes (2 DIANA workers x 2 model shards) against the JAX package's
nested fully-manual round, ``aggregate_shardmap(..., inner_axes=("model",),
grad_specs=param_specs(...), h_specs=h_flat_specs(...))`` inside the
trainer's shard_map over ``data`` on an Auto-axis ``(2, 2)`` host mesh (a
JAX subprocess with 4 host devices; ``jax.make_mesh`` gives Explicit axes
on jax 0.9.0, which the JAX package's ``shard`` refuses, so the mesh is
``jax.sharding.Mesh`` over the devices).

Both sides take the same numpy-seeded gradients for a tree whose leaves
meet every rule kind (the embedding's feature columns, the LM head's
vocabulary, a column- and a row-parallel block matrix, and replicated
norms), two rounds from zero memories, keys ``fold_in(fold_in(key, r),
worker)``.  Rank ``(w, m)`` runs ``aggregate_distributed(group=its data
group)`` on shard ``m`` of worker ``w``'s gradients with shard-local
memories:

* ``diana`` (B = 64), ``randk`` / ``topk_ef`` (k = 8 per shard) and
  ``none``: ghat, h_worker and h_server bitwise the JAX arrays' shards
  (``none`` sums two terms, so its all-reduce order cannot matter);
* ``natural``: the codes every rank gathered bitwise the JAX nested body's
  codes (each shard's encode with the shared leaf key); the decoded values
  within the JAX package's CPU ``exp2`` error on the first round, as
  ``tests/test_torch_distributed.py`` holds them;
* a replicated leaf's results are the same bits on both model ranks; one
  all-gather per populated field per leaf over the data group of 2.

The JAX round script and the gloo spawner here are shared by the other
``test_torch_mesh_*`` files.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
N, M = 2, 2
ROUNDS = 2
SEED_KEY = 42
CASES = {"diana": dict(block_size=64), "natural": {}, "randk": dict(k=8),
         "topk_ef": dict(k=8), "none": {}}
SHAPES = {"embed": (64, 16), "lm_head": (16, 64), "final_norm/scale": (16,),
          "blocks/layer0/mixer/wq": (2, 16, 32), "blocks/layer0/mixer/wo": (2, 32, 16),
          "blocks/layer0/norm1/scale": (2, 16)}
EXP2_RTOL = 4.1e-6  # XLA CPU exp2 at integer arguments (tests/test_torch_natural.py)
F32_EPS = 2.0 ** -23
FIELDS = {"diana": 2, "natural": 1, "randk": 2, "topk_ef": 2}

# The JAX trainer's round (the nested per-leaf one, or with "bucketed" the
# flat-buffer one), fed per-worker global gradients ("g/{case}/{r}/{path}",
# (N, *shape)) and writing the global ghat, h_worker and h_server
# ("{case}/{r}/{ghat,hw,hs}[/{path}]"); with "codes", natural's
# per-(worker, shard, leaf) codes of round 0 from each shard's own encode.
JAX_ROUND = r"""
import json, math, sys, types
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import CompressionConfig, DianaState, aggregate_shardmap, init_state
from repro.launch.sharding_rules import param_specs
from repro.launch.train import h_flat_specs

spec = json.loads(sys.argv[1])
inp, outp = sys.argv[2], sys.argv[3]
data = np.load(inp)
N, M = spec["N"], spec["M"]
mesh = Mesh(np.array(jax.devices()[:N * M]).reshape(N, M), ("data", "model"))
tmap = jax.tree_util.tree_map


def nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        *head, last = path.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


shapes = {p: tuple(s) for p, s in spec["shapes"].items()}
tmpl = nest({p: jnp.zeros(s, jnp.float32) for p, s in shapes.items()})
gspecs = param_specs(tmpl, types.SimpleNamespace(moe=None), mesh)
hspecs = h_flat_specs(gspecs)


def round_fn(cfg, state):
    def body(g_st, hw, hs, key, widx):
        g = tmap(lambda x: x[0], g_st)
        ghat, ns = aggregate_shardmap(
            g, DianaState(hw, hs), jax.random.fold_in(key, widx[0]), cfg,
            axis_names=("data",), n_workers=N, inner_axes=("model",), grad_specs=gspecs,
            h_specs=hspecs, mesh=mesh)
        return ghat, ns.h_worker, ns.h_server
    wsp = lambda t: tmap(lambda _: P("data"), t)
    rep = lambda t: tmap(lambda _: P(), t)
    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(wsp(tmpl), wsp(state.h_worker), rep(state.h_server), P(), P("data")),
        out_specs=(rep(tmpl), wsp(state.h_worker), rep(state.h_server)),
        axis_names={"data"}, check_vma=False))


def model_dim(s):
    return next((i for i, e in enumerate(s) if e == "model"), None)


dims = {p: model_dim(s) for p, s in flat(gspecs).items()}
out = {"specs": np.array(json.dumps(dims))}
key = jax.random.PRNGKey(spec["seed"])
for case in spec["cases"]:
    method, kw = case["method"], dict(case["kw"])
    cfg = CompressionConfig(method=method, p=kw.pop("p", math.inf),
                            bucketed=case.get("bucketed", False), **kw)
    state = init_state(tmpl, cfg, N)
    hw, hs = state.h_worker, state.h_server
    f = round_fn(cfg, state)
    for r in range(spec["rounds"]):
        g = nest({p: jnp.asarray(data[f"g/{case['tag']}/{r}/{p}"]) for p in shapes})
        ghat, hw, hs = f(g, hw, hs, jax.random.fold_in(key, r), jnp.arange(N, dtype=jnp.int32))
        for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs)):
            for p, v in (flat(t).items() if isinstance(t, dict) else [(None, t)]):
                out[f"{case['tag']}/{r}/{name}" + ("" if p is None else f"/{p}")] = np.asarray(v)
    if spec.get("codes") and method == "natural":
        comp = cfg.make()
        paths = sorted(shapes, key=lambda p: tuple(p.split("/")))
        k0 = jax.random.fold_in(key, 0)
        for w in range(N):
            keys = jax.random.split(jax.random.fold_in(k0, w), len(paths))
            for m in range(M):
                for i, p in enumerate(paths):
                    x = data[f"g/{case['tag']}/0/{p}"][w]
                    if dims[p] is not None:
                        x = np.split(x, M, axis=dims[p])[m]
                    pay = comp.compress(jnp.asarray(x).reshape(-1), keys[i])
                    out[f"codes/{case['tag']}/{w}/{m}/{p}"] = np.asarray(pay.packed)
np.savez(outp, **out)
"""


def jax_env(devices=4):
    return dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def start_jax(script, args, devices=4):
    """The JAX side as a subprocess (its own host device count)."""
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            env=jax_env(devices), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_jax(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    return out


def spawn(fn, nprocs, args, timeout=600):
    """``fn(rank, *args)`` on ``nprocs`` spawned processes, joined."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the gloo ranks did not finish in {timeout} s")


def init_gloo(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def shard_of(x, dim, m, model=M):
    """Shard ``m`` of a global numpy array split along ``dim`` (or whole)."""
    return x if dim is None else np.split(x, model, axis=dim)[m]


def _inputs():
    rng = np.random.default_rng(5)
    data = {}
    for method in CASES:
        for r in range(ROUNDS):
            for p, s in SHAPES.items():
                g = rng.standard_normal((N, *s)).astype(np.float32)
                if p == "embed":
                    g[:, :3] = 0.0  # exact zeros where the memories are live
                data[f"g/{method}/{r}/{p}"] = g
    return data


def _rank_main(rank, tmp):
    from repro_torch.core import prng
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.diana import aggregate_distributed, init_state, worker_key
    from repro_torch.launch.mesh import mesh_groups, parse_mesh
    from repro_torch.launch.sharding_rules import param_specs

    tmp = Path(tmp)
    init_gloo(rank, N * M, str(tmp / "store"))
    groups = mesh_groups(parse_mesh(f"{N}x{M}"))
    w, m = groups.worker, groups.shard
    specs = param_specs(SHAPES, None, M)
    data = np.load(tmp / "inputs.npz")
    out, calls = {}, {}
    key = prng.PRNGKey(SEED_KEY)
    for method, kw in CASES.items():
        cfg = CompressionConfig(method=method, bucketed=False, **kw)
        local = {p: torch.from_numpy(shard_of(data[f"g/{method}/0/{p}"][w], specs[p], m).copy())
                 for p in SHAPES}
        state = init_state(local, cfg, 1)
        for r in range(ROUNDS):
            grads = {p: torch.from_numpy(shard_of(data[f"g/{method}/{r}/{p}"][w], specs[p],
                                                  m).copy()) for p in SHAPES}
            gathered, orig = [], dist.all_gather_into_tensor

            def counting(out_, src, *a, **k):
                gathered.append(src.clone())
                return orig(out_, src, *a, **k)
            dist.all_gather_into_tensor = counting
            try:
                ghat, state = aggregate_distributed(
                    grads, state, worker_key(prng.fold_in(key, r), w), cfg, group=groups.data)
            finally:
                dist.all_gather_into_tensor = orig
            calls[f"{method}/{r}"] = len(gathered)
            for name, t in (("ghat", ghat), ("hw", state.h_worker), ("hs", state.h_server)):
                for p, v in t.items():
                    out[f"{method}/{r}/{name}/{p}"] = v.numpy()
            if method == "natural" and r == 0:
                for i, g in enumerate(gathered):
                    out[f"codes/{i}"] = g.numpy()
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps({"calls": calls, "coords": [w, m]}))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_round")
    np.savez(tmp / "inputs.npz", **_inputs())
    spec = {"N": N, "M": M, "seed": SEED_KEY, "rounds": ROUNDS, "codes": True,
            "shapes": SHAPES,
            "cases": [{"tag": m, "method": m, "kw": kw} for m, kw in CASES.items()]}
    jproc = start_jax(JAX_ROUND, [json.dumps(spec), tmp / "inputs.npz", tmp / "jax.npz"])
    try:
        spawn(_rank_main, N * M, (str(tmp),))
    finally:
        finish_jax(jproc)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N * M)]
    meta = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N * M)]
    return dict(np.load(tmp / "jax.npz")), ranks, meta


def _dims(jax_out):
    return json.loads(str(jax_out["specs"]))


def test_specs_match_the_jax_param_specs(runs):
    """The port's rules split the same dimension of each leaf as the JAX
    ``param_specs`` on the Auto (2, 2) mesh."""
    from repro_torch.launch.sharding_rules import param_specs

    jax_out, _, meta = runs
    assert param_specs(SHAPES, None, M) == _dims(jax_out)
    assert [m["coords"] for m in meta] == [[0, 0], [0, 1], [1, 0], [1, 1]]


@pytest.mark.parametrize("method", ["diana", "randk", "topk_ef", "none"])
def test_round_bitwise_the_nested_aggregate_shardmap(runs, method):
    """Each rank's ghat, h_worker row and h_server are the JAX global
    arrays' shards, bit for bit, over two rounds."""
    jax_out, ranks, meta = runs
    dims = _dims(jax_out)
    for r in range(ROUNDS):
        for rank, (w, m) in enumerate(mm["coords"] for mm in meta):
            for p in SHAPES:
                hdim = None if dims[p] is None else 0
                got = ranks[rank]
                tag = f"{method}/{r}"
                assert same_bits(got[f"{tag}/ghat/{p}"],
                                 shard_of(jax_out[f"{tag}/ghat/{p}"], dims[p], m)), (tag, p, rank)
                assert same_bits(got[f"{tag}/hw/{p}"][0],
                                 shard_of(jax_out[f"{tag}/hw/{p}"][w], hdim, m)), (tag, p, rank)
                assert same_bits(got[f"{tag}/hs/{p}"],
                                 shard_of(jax_out[f"{tag}/hs/{p}"], hdim, m)), (tag, p, rank)


def test_natural_codes_bitwise_values_within_exp2(runs):
    """natural: each rank gathered its data group's codes, which are the JAX
    nested body's codes of each (worker, shard); ghat and h_server within
    the reference's exp2 error of the decoded magnitudes on round 0."""
    jax_out, ranks, meta = runs
    paths = sorted(SHAPES, key=lambda p: tuple(p.split("/")))
    tol = EXP2_RTOL + (N + 2) * F32_EPS
    for rank, (w, m) in enumerate(mm["coords"] for mm in meta):
        for i, p in enumerate(paths):
            want = jax_out[f"codes/natural/{w}/{m}/{p}"]
            got = ranks[rank][f"codes/{i}"].view(want.dtype).reshape(want.shape)
            assert same_bits(got, want), (rank, p)
        dims = _dims(jax_out)
        for p in paths:
            for name, dim in (("ghat", dims[p]), ("hs", None if dims[p] is None else 0)):
                a = ranks[rank][f"natural/0/{name}/{p}"].astype(np.float64)
                b = shard_of(jax_out[f"natural/0/{name}/{p}"], dim, m).astype(np.float64)
                scale = np.abs(b).reshape(-1).max() + 1e-30
                assert np.all(np.abs(a - b) <= tol * scale), (rank, name, p)


@pytest.mark.parametrize("method", list(CASES))
def test_replicated_leaves_equal_across_model_ranks(runs, method):
    """The norms (replicated) get the same bits on both shards of a worker,
    and one all-gather per populated field per leaf ran over the data
    group (``none``: all-reduces only)."""
    _, ranks, meta = runs
    for w in range(N):
        a, b = (ranks[w * M + m] for m in range(M))
        for r in range(ROUNDS):
            for p in ("final_norm/scale", "blocks/layer0/norm1/scale"):
                for name in ("ghat", "hw", "hs"):
                    k = f"{method}/{r}/{name}/{p}"
                    assert same_bits(a[k], b[k]), k
    want = FIELDS.get(method, 0) * len(SHAPES)
    for mm in meta:
        assert [mm["calls"][f"{method}/{r}"] for r in range(ROUNDS)] == [want] * ROUNDS
