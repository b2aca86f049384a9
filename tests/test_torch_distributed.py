"""The port's ``torch.distributed`` DIANA round and its one-worker-per-rank
trainer, on 4 gloo ranks of CPU processes.

* The round (``repro_torch.core.diana.aggregate_distributed``) against the
  JAX package's ``aggregate_shardmap`` in a ``(4, 1)`` host mesh (a JAX
  subprocess with 8 host devices; the harness is ``tests/test_bucket.py``'s),
  on the same numpy-seeded gradients ``{"w": (32, 16), "b": (24,)}`` and keys,
  over two rounds, in the bucketed and the per-leaf layouts:
  - bitwise for ``diana`` (B = 64), ``randk`` and ``topk_ef`` (k = 8);
  - ``natural``: the gathered codes bitwise; the decoded values within the
    JAX package's CPU ``exp2`` error (``EXP2_RTOL`` = 4.1e-6 of the summed
    magnitudes plus one f32 rounding per addition, as
    ``tests/test_torch_natural.py`` documents).  Its second round starts from
    memories that carry that error on the JAX side, so a code may flip: the
    natural values are held on the first round;
  - ``none``: its round is one all-reduce, and gloo and XLA each own their
    all-reduce order, so ghat is held within 2(n-1) eps of the summed
    magnitudes (two summation orders), not within an ulp of the mean, which
    can cancel.
* ``ghat`` and ``h_server`` are equal on all 4 ranks; a bucketed round is one
  collective, a per-leaf round one per field per leaf.
* The distributed trainer (4 ranks x 1 worker, reduced llama3.2-1b at
  d_model 128) against
  the in-turn trainer's ``--mesh 4x1`` after 2 steps, both with one torch
  thread so that the CPU GEMMs block the same way: parameters and both
  memories bitwise; ``none`` step by step from the same state, each
  parameter within what its all-reduce order can move it.
* The wire format against the JAX package's ``fuse_payload`` bytes.
* VR-DIANA and the compressed downlink together (``vr=True``, ``vr_p =
  0.5``, each operator as its own downlink), on inputs on the 1/64 grid
  (``tests/test_torch_vr.py``): ``aggregate_distributed`` against
  ``aggregate_shardmap`` (driven as in ``tests/test_downlink.py:287``) over
  two rounds, in both layouts, bit for bit in ghat, every rank's
  ``h_worker`` row, ``h_server``, ``h_down`` and the rank's (snapshot, mu)
  row, all five operators; and the distributed trainer with ``--vr`` /
  ``--down-method`` against the in-turn ``--mesh 4x1`` trainer.
"""

import contextlib
import io
import json
import math
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
from repro_torch.core.bucket import fuse_payload, payload_recipe, unfuse_payload
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.diana import (DOWN_FOLD, aggregate_distributed, bucket_layout,
                                    bucketed_compressor, init_state, reference_init,
                                    reference_step, worker_key)
from repro_torch.core.vr import VRState
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import train
from repro_torch.models.transformer import init_model, train_loss

ROOT = Path(__file__).resolve().parents[1]
N = 4
SEED_KEY = 42
ROUNDS = 2
CASES = {"diana": dict(block_size=64), "natural": {}, "randk": dict(k=8),
         "topk_ef": dict(k=8), "none": {}}
LAYOUTS = ("bucketed", "perleaf")
SHAPES = {"w": (32, 16), "b": (24,)}
EXP2_RTOL = 4.1e-6  # XLA CPU exp2 at integer arguments (tests/test_torch_natural.py)
F32_EPS = 2.0 ** -23
TRAIN_METHODS = ("diana", "natural", "randk", "topk_ef", "none")
TRAIN_SHAPE = ShapeConfig("t", 16, 4, "train")
# The trainer's VR and downlink configurations (``--vr --vr-p 0.5``,
# ``--down-method ...``), each on the ``diana`` uplink.
TRAIN_VR_DOWN = {"vr": dict(vr=True, vr_p=0.5), "down-diana": dict(comp_down_method="diana"),
                 "vr+down-topk_ef": dict(vr=True, vr_p=0.5, comp_down_method="topk_ef",
                                         comp_down_k=512)}


def _train_config():
    """reduced llama3.2-1b (2 layers), narrowed further so that the plain
    versions of the PRNG encodes (int64 threefry on one thread) keep the
    file well inside a minute."""
    return replace(reduced(get_config("llama3.2-1b")), d_model=128, n_heads=4, n_kv_heads=2,
                   head_dim=32, d_ff=256)

# Collectives per round: bucketed, ONE; per leaf, one per populated field per leaf.
PERLEAF_CALLS = {"diana": 4, "natural": 2, "randk": 4, "topk_ef": 4, "none": 2}

JAX_SCRIPT = """
import sys, math
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import CompressionConfig, DianaState, aggregate_shardmap, init_state
from repro.core import bucketed_compressor
from repro.core.bucket import fuse_payload
from repro.core.diana import bucket_layout
from repro.launch.mesh import make_mesh

inp, outp = sys.argv[1], sys.argv[2]
CASES = %(cases)r
data = np.load(inp)
mesh = make_mesh((4, 1), ("data", "model"))
n = 4
params = {"w": jnp.zeros((32, 16)), "b": jnp.zeros((24,))}
key = jax.random.PRNGKey(%(seed)d)

def dist_fn(cfg, state):
    def body(grads_stacked, h_worker, h_server, key):
        g_local = jax.tree_util.tree_map(lambda g: g[0], grads_stacked)
        wkey = jax.random.fold_in(key, jax.lax.axis_index("data"))
        ghat, new_state = aggregate_shardmap(
            g_local, DianaState(h_worker, h_server), wkey, cfg,
            axis_names=("data",), n_workers=n)
        return ghat, new_state.h_worker, new_state.h_server
    return shard_map(body, mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: P("data"), params),
                  jax.tree_util.tree_map(lambda _: P("data"), state.h_worker),
                  jax.tree_util.tree_map(lambda _: P(), state.h_server), P()),
        out_specs=(jax.tree_util.tree_map(lambda _: P(), params),
                   jax.tree_util.tree_map(lambda _: P("data"), state.h_worker),
                   jax.tree_util.tree_map(lambda _: P(), state.h_server)),
        axis_names={"data"}, check_vma=False)

def leaves(prefix, t, out):
    if isinstance(t, dict):
        for p, v in t.items():
            out[prefix + "/" + p] = np.asarray(v)
    else:
        out[prefix] = np.asarray(t)


out = {}
for method, kw in CASES.items():
    for layout in ("bucketed", "perleaf"):
        cfg = CompressionConfig(method=method, p=math.inf, bucketed=layout == "bucketed", **kw)
        state = init_state(params, cfg, n)
        hw, hs = state.h_worker, state.h_server
        f = jax.jit(dist_fn(cfg, state))
        for r in range(%(rounds)d):
            grads = {p: jnp.asarray(data[f"{p}{r}"]) for p in params}
            ghat, hw, hs = f(grads, hw, hs, jax.random.fold_in(key, r))
            tag = f"{method}/{layout}/{r}"
            leaves(tag + "/ghat", ghat, out)
            leaves(tag + "/hw", hw, out)
            leaves(tag + "/hs", hs, out)
    # Worker w's first-round payload, bucketed: its wire bytes (worker 0) and,
    # for natural, its codes; per leaf, natural's codes of each leaf.
    cfg = CompressionConfig(method=method, p=math.inf, bucketed=True, **kw)
    g = [{p: jnp.asarray(data[f"{p}0"][w]) for p in params} for w in range(n)]
    layout = bucket_layout(cfg, g[0])
    comp = bucketed_compressor(cfg, layout)
    k0 = jax.random.fold_in(key, 0)
    pays = [comp.compress(layout.flatten(g[w]), jax.random.fold_in(k0, w)) for w in range(n)]
    out[f"{method}/wire"] = np.asarray(fuse_payload(pays[0]))
    if method == "natural":
        out["natural/codes/bucketed"] = np.stack([np.asarray(p.packed) for p in pays])
        pcomp = cfg.make()
        for i, p in enumerate(sorted(params)):
            out[f"natural/codes/perleaf/{p}"] = np.stack([np.asarray(pcomp.compress(
                g[w][p].reshape(-1), jax.random.split(jax.random.fold_in(k0, w), 2)[i]).packed)
                for w in range(n)])
# VR-DIANA with each operator as its own downlink (tests/test_downlink.py:287)
from repro.core import VRState
from repro.core.diana import DOWN_FOLD
vdata = np.load(sys.argv[3])
vparams = {p: jnp.asarray(vdata[f"params/{p}"]) for p in params}
tmap = jax.tree_util.tree_map

def vr_fn(cfg, st):
    def body(g_st, snap_st, mu_st, gsnap_st, mucand_st, h_w, h_s, h_d, k):
        own = lambda t: tmap(lambda x: x[0], t)
        stl = DianaState(h_w, h_s, VRState(snapshot=snap_st, mu=mu_st), h_d)
        wkey = jax.random.fold_in(k, jax.lax.axis_index("data"))
        ghat, ns = aggregate_shardmap(
            own(g_st), stl, wkey, cfg, axis_names=("data",), n_workers=n,
            vr_aux=(own(gsnap_st), own(mucand_st)), params_local=vparams,
            down_key=jax.random.fold_in(k, DOWN_FOLD))
        return ghat, ns.h_worker, ns.h_server, ns.h_down, ns.vr.snapshot, ns.vr.mu
    sh = lambda t: tmap(lambda _: P("data"), t)
    rep = lambda t: tmap(lambda _: P(), t)
    hd = tmap(lambda _: P(), st.h_down)
    return shard_map(body, mesh=mesh,
        in_specs=(sh(params), sh(params), sh(params), sh(params), sh(params),
                  tmap(lambda _: P("data"), st.h_worker), rep(st.h_server), hd, P()),
        out_specs=(rep(params), tmap(lambda _: P("data"), st.h_worker), rep(st.h_server),
                   hd, sh(params), sh(params)),
        axis_names={"data"}, check_vma=False)

for method, kw in CASES.items():
    for layout in ("bucketed", "perleaf"):
        cfg = CompressionConfig(method=method, p=math.inf, bucketed=layout == "bucketed",
                                vr=True, vr_p=0.5, down_method=method, down_k=kw.get("k"), **kw)
        st = init_state(vparams, cfg, n)
        hw, hs, hd = st.h_worker, st.h_server, st.h_down
        snap = {p: jnp.asarray(vdata[f"snap/{p}"]) for p in params}
        mu = {p: jnp.asarray(vdata[f"mu/{p}"]) for p in params}
        f = jax.jit(vr_fn(cfg, st))
        for r in range(%(rounds)d):
            tree = lambda name: {p: jnp.asarray(vdata[f"{name}/{p}{r}"]) for p in params}
            ghat, hw, hs, hd, snap, mu = f(tree("g"), snap, mu, tree("gsnap"), tree("mucand"),
                                           hw, hs, hd, jax.random.fold_in(key, r))
            tag = f"vrdown/{method}/{layout}/{r}"
            for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs), ("hd", hd),
                            ("snap", snap), ("mu", mu)):
                leaves(f"{tag}/{name}", t, out)
np.savez(outp, **out)
"""


def _vr_inputs():
    """VR and downlink rounds: parameters, snapshots and mu, and each round's
    gradients, gradients at the snapshots and mu candidates, on the 1/64
    grid (numpy-seeded)."""
    rng = np.random.default_rng(11)

    def grid(shape):
        return (np.round(rng.standard_normal(shape) * 64) / 64).astype(np.float32)
    data = {}
    for p, s in SHAPES.items():
        data[f"params/{p}"] = grid(s)
        data[f"snap/{p}"], data[f"mu/{p}"] = grid((N, *s)), grid((N, *s))
        for r in range(ROUNDS):
            for name in ("g", "gsnap", "mucand"):
                data[f"{name}/{p}{r}"] = grid((N, *s))
    return data


def _inputs():
    """Each round's stacked per-worker gradients, numpy-seeded."""
    rng = np.random.default_rng(7)
    data = {f"{p}{r}": rng.standard_normal((N, *s)).astype(np.float32)
            for r in range(ROUNDS) for p, s in SHAPES.items()}
    data["b1"][:, :3] = 0.0  # exact zeros where the memories are live
    return data


def _config(method, layout):
    return CompressionConfig(method=method, bucketed=layout == "bucketed", **CASES[method])


class _Collectives:
    """Counts (and keeps the outputs of) the collectives the round calls,
    by wrapping ``torch.distributed``'s functions."""

    def __init__(self):
        self.calls, self.gathered = [], []
        self._orig = {}

    def __enter__(self):
        for name in ("all_gather_into_tensor", "all_reduce"):
            orig = getattr(dist, name)
            self._orig[name] = orig

            def wrapped(*args, _name=name, _orig=orig, **kw):
                self.calls.append(_name)
                out = _orig(*args, **kw)
                if _name == "all_gather_into_tensor":
                    self.gathered.append(args[0].clone())
                return out
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(dist, name, orig)


def _trainer_states(cfg, params0, steps, step_fn, opt_state):
    params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in params0.items()}
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, TRAIN_SHAPE, s).items()}
        params, opt_state, met = step_fn(params, opt_state, batch,
                                         prng.fold_in(prng.PRNGKey(0), s))
        losses.append(float(met["loss"]))
    return losses, params, opt_state.diana


def _digest(params):
    return float(sum(v.detach().double().sum() for v in params.values()))


def _save(out, tag, trees):
    """``{tag}/{name}[/{path}]`` -> numpy, for each (name, tensor or tree)."""
    for name, t in trees:
        if isinstance(t, dict):
            for p, v in t.items():
                out[f"{tag}/{name}/{p}"] = v.numpy()
        else:
            out[f"{tag}/{name}"] = t.numpy()


def _ulp(x):
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def _none_steps(cfg, opt, params0):
    """``none`` sums in the backend's all-reduce order, so its trainer is
    held step by step from the in-turn trainer's state: both take the same
    step, and each parameter of the distributed step must lie within what
    a different summation order can move it.  Two orders of the same n
    terms differ by at most 2(n-1) eps sum_i |g_i| (the recursive-summation
    bound, twice), so ghat (the sum over n = 4, exact) by 2(n-1) eps
    mean_i |g_i|; the momentum add, the product with lr and the parameter
    write each round once more, by at most one ulp of their result."""
    t_step = train.build_train_step(cfg, opt, N, "cpu")
    d_step = train.build_distributed_step(cfg, opt)
    params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in params0.items()}
    state = opt.init(params, N)
    worst, losses, zeros = 0.0, [], True
    for s in range(2):
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, TRAIN_SHAPE, s).items()}
        key = prng.fold_in(prng.PRNGKey(0), s)
        paths = list(params)
        per_worker = [torch.autograd.grad(
            train_loss(params, train._worker_batch(batch, w, N), cfg),
            [params[p] for p in paths]) for w in range(N)]
        mag = {p: sum(g[i].abs() for g in per_worker) / N for i, p in enumerate(paths)}
        d_params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in params.items()}
        d_state = state._replace(inner={k: v.clone() for k, v in state.inner.items()},
                                 diana=opt.init(d_params, 1).diana)
        d_params, d_state, d_met = d_step(d_params, d_state, batch, key)
        lr = opt.schedule(state.step)
        params, state, t_met = t_step(params, state, batch, key)
        losses.append([float(d_met["loss"]), float(t_met["loss"])])
        for p in paths:
            v = state.inner[p]
            bound = (lr * (2 * (N - 1) * F32_EPS * mag[p] + _ulp(v)) + _ulp(lr * v)
                     + _ulp(params[p].detach()))
            worst = max(worst, float(((d_params[p] - params[p]).abs() / bound).max()))
        zeros &= not (d_state.diana.h_worker.any() or d_state.diana.h_server.any())
    return {"params_within_bound": worst, "h_worker": zeros, "h_server": zeros,
            "losses": list(map(list, zip(*losses))), "param_digest": _digest(d_params)}


def _rank_main(rank, tmp, store):
    """One gloo rank: every round case, then the trainer against the
    in-turn trainer, then the CLI under a torchrun-like environment."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, N), rank=rank, world_size=N)
    tmp = Path(tmp)
    data = np.load(tmp / "inputs.npz")
    out, summary = {}, {"calls": {}, "train": {}}
    key = prng.PRNGKey(SEED_KEY)
    for method in CASES:
        for layout in LAYOUTS:
            cfg = _config(method, layout)
            params = {p: torch.zeros(s) for p, s in SHAPES.items()}
            state = init_state(params, cfg, 1)
            for r in range(ROUNDS):
                grads = {p: torch.from_numpy(data[f"{p}{r}"][rank].copy()) for p in SHAPES}
                with _Collectives() as col:
                    ghat, state = aggregate_distributed(
                        grads, state, worker_key(prng.fold_in(key, r), rank), cfg)
                tag = f"{method}/{layout}/{r}"
                summary["calls"][tag] = col.calls
                _save(out, tag, (("ghat", ghat), ("hw", state.h_worker), ("hs", state.h_server)))
                if method == "natural" and r == 0:
                    for i, g in enumerate(col.gathered):
                        out[f"{tag}/gathered/{i}"] = g.numpy()
            if rank == 0:  # the port's one-process reference on the stacked grads
                ref = reference_init(params, cfg, N)
                for r in range(ROUNDS):
                    stacked = {p: torch.from_numpy(data[f"{p}{r}"]) for p in SHAPES}
                    ghat, ref = reference_step(stacked, ref, prng.fold_in(key, r), cfg)
                    _save(out, f"{method}/{layout}/{r}/ref",
                          (("ghat", ghat), ("hw", ref.h_worker), ("hs", ref.h_server)))

    vdata = np.load(tmp / "vr_inputs.npz")
    vparams = {p: torch.from_numpy(vdata[f"params/{p}"]) for p in SHAPES}
    for method in CASES:
        for layout in LAYOUTS:
            cfg = replace(_config(method, layout), vr=True, vr_p=0.5, down_method=method,
                          down_k=CASES[method].get("k"))
            state = init_state(vparams, cfg, 1)
            state = state._replace(vr=VRState(
                snapshot={p: torch.from_numpy(vdata[f"snap/{p}"][rank:rank + 1]) for p in SHAPES},
                mu={p: torch.from_numpy(vdata[f"mu/{p}"][rank:rank + 1]) for p in SHAPES}))
            for r in range(ROUNDS):
                row = {name: {p: torch.from_numpy(vdata[f"{name}/{p}{r}"][rank]) for p in SHAPES}
                       for name in ("g", "gsnap", "mucand")}
                kr = prng.fold_in(key, r)
                ghat, state = aggregate_distributed(
                    row["g"], state, worker_key(kr, rank), cfg,
                    vr_aux=(row["gsnap"], row["mucand"]), params_local=vparams,
                    down_key=prng.fold_in(kr, DOWN_FOLD))
                _save(out, f"vrdown/{method}/{layout}/{r}",
                      (("ghat", ghat), ("hw", state.h_worker), ("hs", state.h_server),
                       ("hd", state.h_down), ("snap", state.vr.snapshot), ("mu", state.vr.mu)))

    base = _train_config()
    for name, extra in TRAIN_VR_DOWN.items():
        cfg = replace(base, compression="diana", comp_k=4096, **extra)
        params0 = init_model(cfg, "cpu", seed=1)
        opt = train.make_optimizer(cfg, lr=3e-4)
        t_loss, t_params, t_diana = _trainer_states(
            cfg, params0, 2, train.build_train_step(cfg, opt, N, "cpu"), opt.init(params0, N))
        d_loss, d_params, d_diana = _trainer_states(
            cfg, params0, 2, train.build_distributed_step(cfg, opt), opt.init(params0, 1))
        rows = {"h_worker": (d_diana.h_worker[0], t_diana.h_worker[rank]),
                "h_server": (d_diana.h_server, t_diana.h_server)}
        if d_diana.h_down is not None:
            rows["h_down"] = (d_diana.h_down, t_diana.h_down)
        if d_diana.vr is not None:
            for p in t_params:
                rows[f"snapshot/{p}"] = (d_diana.vr.snapshot[p][0], t_diana.vr.snapshot[p][rank])
                rows[f"mu/{p}"] = (d_diana.vr.mu[p][0], t_diana.vr.mu[p][rank])
        summary["train"][name] = {
            "params": all(torch.equal(d_params[p], t_params[p]) for p in t_params),
            **{k: bool(torch.equal(a, b)) for k, (a, b) in rows.items()},
            "losses": [d_loss, t_loss], "param_digest": _digest(d_params),
        }
    for method in TRAIN_METHODS:
        cfg = replace(base, compression=method, comp_k=4096)
        params0 = init_model(cfg, "cpu", seed=1)
        opt = train.make_optimizer(cfg, lr=3e-4)
        if method == "none":
            summary["train"][method] = _none_steps(cfg, opt, params0)
            continue
        in_turn = _trainer_states(cfg, params0, 2, train.build_train_step(cfg, opt, N, "cpu"),
                                  opt.init(params0, N))
        ranked = _trainer_states(cfg, params0, 2, train.build_distributed_step(cfg, opt),
                                 opt.init(params0, 1))
        (t_loss, t_params, t_diana), (d_loss, d_params, d_diana) = in_turn, ranked
        summary["train"][method] = {
            "params": all(torch.equal(d_params[p], t_params[p]) for p in t_params),
            "h_worker": bool(torch.equal(d_diana.h_worker[0], t_diana.h_worker[rank])),
            "h_server": bool(torch.equal(d_diana.h_server, t_diana.h_server)),
            "losses": [d_loss, t_loss],
            "param_digest": _digest(d_params),
        }

    # The CLI: under a torchrun-like environment with the group already up,
    # one rank per worker; rank 0 logs the all-reduced loss.
    os.environ["WORLD_SIZE"] = str(N)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "4x1",
                    "--steps", "1", "--batch", "4", "--seq", "16", "--compression", "natural"])
    summary["cli"] = buf.getvalue()
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(summary))
    if dist.is_initialized():
        dist.destroy_process_group()


def _spawn(tmp, timeout=600):
    ctx = mp.start_processes(_rank_main, args=(str(tmp), str(tmp / "store")), nprocs=N,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the gloo ranks did not finish in {timeout} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the 4 gloo ranks, run side by side."""
    tmp = tmp_path_factory.mktemp("dist")
    np.savez(tmp / "inputs.npz", **_inputs())
    np.savez(tmp / "vr_inputs.npz", **_vr_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT % dict(cases=CASES, seed=SEED_KEY, rounds=ROUNDS)
    jproc = subprocess.Popen([sys.executable, "-c", script, str(tmp / "inputs.npz"),
                              str(tmp / "jax.npz"), str(tmp / "vr_inputs.npz")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        _spawn(tmp)
    finally:
        jout, jerr = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, f"stdout:\n{jout}\nstderr:\n{jerr[-3000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
    summaries = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N)]
    return dict(np.load(tmp / "jax.npz")), ranks, summaries


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _keys(arrays, prefix):
    return sorted(k for k in arrays if k.startswith(prefix + "/") or k == prefix)


def _nat_values(codes):
    k = np.abs(codes.astype(np.int64)) - 160
    with np.errstate(over="ignore"):
        mag = np.ldexp(np.float32(1.0), k).astype(np.float32)
    return np.where(codes < 0, -mag, mag).astype(np.float32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", ["diana", "randk", "topk_ef"])
def test_round_bitwise_equals_aggregate_shardmap(runs, method, layout):
    """ghat, every rank's h_worker row and h_server equal the JAX package's
    distributed round bit for bit, over two rounds."""
    jax_out, ranks, _ = runs
    for r in range(ROUNDS):
        tag = f"{method}/{layout}/{r}"
        for name in ("ghat", "hs"):
            for k in _keys(jax_out, f"{tag}/{name}"):
                assert _same_bits(ranks[0][k], jax_out[k]), k
        for k in _keys(jax_out, f"{tag}/hw"):
            for rank in range(N):
                assert _same_bits(ranks[rank][k][0], jax_out[k][rank]), (k, rank)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_natural_round_codes_bitwise_values_within_exp2(runs, layout):
    """natural: the codes every rank gathered are the JAX package's codes;
    ghat, h_server and each rank's h_worker agree within the reference's
    exp2 error of the decoded magnitudes (plus one f32 rounding per
    addition and one for the memory rate)."""
    jax_out, ranks, _ = runs
    tag = f"natural/{layout}/0"
    paths = sorted(SHAPES)
    if layout == "bucketed":
        want = [jax_out["natural/codes/bucketed"]]
    else:
        want = [jax_out[f"natural/codes/perleaf/{p}"] for p in paths]
    for rank in range(N):
        for i, w in enumerate(want):
            got = ranks[rank][f"{tag}/gathered/{i}"].view(np.int16).reshape(w.shape)
            assert _same_bits(got, w), (rank, i)
    # |decoded terms| per coordinate: each worker's own, and their mean
    mags = [np.abs(_nat_values(w).astype(np.float64)) for w in want]
    if layout == "bucketed":
        flat = mags[0]
        sizes = [math.prod(SHAPES[p]) for p in paths]
        offs = np.cumsum([0] + sizes)
        leaf_mags = {p: flat[:, o:o + n] for p, o, n in zip(paths, offs, sizes)}
        mem = {"": flat}
    else:
        leaf_mags = dict(zip(paths, mags))
        mem = {f"/{p}": m for p, m in leaf_mags.items()}
    tol = EXP2_RTOL + (N + 2) * F32_EPS
    for p, m in leaf_mags.items():
        k = f"{tag}/ghat/{p}"
        d = np.abs(ranks[0][k].reshape(-1).astype(np.float64) - jax_out[k].reshape(-1))
        assert np.all(d <= tol * m.mean(axis=0)), (k, float(d.max()))
    for suffix, m in mem.items():
        k = f"{tag}/hs{suffix}"
        d = np.abs(ranks[0][k].astype(np.float64) - jax_out[k])
        assert np.all(d <= tol * m.mean(axis=0)), (k, float(d.max()))
        k = f"{tag}/hw{suffix}"
        for rank in range(N):
            d = np.abs(ranks[rank][k][0].astype(np.float64) - jax_out[k][rank])
            assert np.all(d <= (EXP2_RTOL + 2 * F32_EPS) * m[rank]), (k, rank, float(d.max()))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_none_round_is_the_all_reduce_mean(runs, layout):
    """none: ghat is the all-reduced mean.  gloo and XLA each own their
    all-reduce order, and two orders of n terms differ by at most 2(n-1)
    eps sum_i |g_i| (the recursive-summation bound, twice): a bound on the
    summed magnitudes, since where the mean cancels one ulp of the result
    is far below one rounding of a partial sum.  The memories stay zero."""
    jax_out, ranks, _ = runs
    inputs = _inputs()
    for r in range(ROUNDS):
        tag = f"none/{layout}/{r}"
        for p in SHAPES:
            k = f"{tag}/ghat/{p}"
            mag = np.abs(inputs[f"{p}{r}"].astype(np.float64)).mean(axis=0)
            d = np.abs(ranks[0][k].astype(np.float64) - jax_out[k])
            assert np.all(d <= 2 * (N - 1) * F32_EPS * mag), (k, float(d.max()))
        for name in ("hw", "hs"):
            for k in _keys(jax_out, f"{tag}/{name}"):
                assert not ranks[0][k].any() and not jax_out[k].any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", ["diana", "natural", "randk", "topk_ef"])
def test_round_bitwise_equals_port_reference_step(runs, method, layout):
    """Inside the port the distributed round is the one-process
    ``reference_step`` on the stacked grads bit for bit, natural included
    (both decode exact powers of two)."""
    _, ranks, _ = runs
    for r in range(ROUNDS):
        tag = f"{method}/{layout}/{r}"
        for k in _keys(ranks[0], f"{tag}/ref"):
            name = k[len(tag) + len("/ref/"):]
            for rank in range(N):
                got = ranks[rank][f"{tag}/{name}"]
                want = ranks[0][k][rank:rank + 1] if name.startswith("hw") else ranks[0][k]
                assert _same_bits(got, want), (k, rank)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", list(CASES))
def test_round_replicated_on_every_rank(runs, method, layout):
    """ghat and h_server are the same bits on all four ranks."""
    _, ranks, _ = runs
    for r in range(ROUNDS):
        tag = f"{method}/{layout}/{r}"
        for k in _keys(ranks[0], f"{tag}/ghat") + _keys(ranks[0], f"{tag}/hs"):
            for rank in range(1, N):
                assert _same_bits(ranks[rank][k], ranks[0][k]), (k, rank)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", list(CASES))
def test_round_collective_count(runs, method, layout):
    """Bucketed: ONE collective per round (one all-gather of the fused
    payload, or one all-reduce for none).  Per leaf: one per field per leaf."""
    _, _, summaries = runs
    kind = "all_reduce" if method == "none" else "all_gather_into_tensor"
    want = 1 if layout == "bucketed" else PERLEAF_CALLS[method]
    for s in summaries:
        for r in range(ROUNDS):
            assert s["calls"][f"{method}/{layout}/{r}"] == [kind] * want


@pytest.mark.parametrize("method", TRAIN_METHODS)
def test_distributed_trainer_equals_in_turn_trainer(runs, method):
    """4 ranks x 1 worker against the in-turn trainer's 4 workers, 2 steps:
    parameters, each rank's h_worker row and h_server bitwise (none: within
    1 ulp, its all-reduce order); the logged loss is the mean over ranks."""
    _, _, summaries = runs
    for s in summaries:
        got = s["train"][method]
        assert got["h_worker"] and got["h_server"], got
        if method == "none":
            assert got["params_within_bound"] <= 1.0, got
        else:
            assert got["params"], got
        for d, t in zip(*got["losses"]):
            assert math.isclose(d, t, rel_tol=1e-6) and math.isfinite(d)
    digests = {s["train"][method]["param_digest"] for s in summaries}
    assert len(digests) == 1  # the same parameters on every rank


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", list(CASES))
def test_vr_downlink_round_bitwise_equals_aggregate_shardmap(runs, method, layout):
    """VR and the downlink: ghat, h_server and h_down on every rank, and each
    rank's h_worker, snapshot and mu rows, equal the JAX package's
    distributed round bit for bit, over two rounds (the refreshed rows and
    h_down carried into the second)."""
    jax_out, ranks, _ = runs
    for r in range(ROUNDS):
        tag = f"vrdown/{method}/{layout}/{r}"
        keys = [k for name in ("ghat", "hs", "hd") for k in _keys(jax_out, f"{tag}/{name}")]
        assert keys and any("/hd" in k for k in keys)
        for k in keys:
            for rank in range(N):
                assert _same_bits(ranks[rank][k], jax_out[k]), (k, rank)
        rows = [k for name in ("hw", "snap", "mu") for k in _keys(jax_out, f"{tag}/{name}")]
        assert len(rows) >= 5
        for k in rows:
            for rank in range(N):
                assert _same_bits(ranks[rank][k][0], jax_out[k][rank]), (k, rank)


@pytest.mark.parametrize("name", list(TRAIN_VR_DOWN))
def test_distributed_trainer_vr_downlink_equals_in_turn(runs, name):
    """``--vr`` and ``--down-method``: 4 ranks x 1 worker against the in-turn
    trainer's 4 workers, 2 steps (step 0 forces the refresh, step 1 draws
    the coins): parameters, h_worker, h_server, h_down and each rank's
    (snapshot, mu) row bit for bit."""
    _, _, summaries = runs
    for s in summaries:
        got = s["train"][name]
        flags = {k: v for k, v in got.items() if isinstance(v, bool)}
        assert all(flags.values()) and len(flags) >= 3, got
        for d, t in zip(*got["losses"]):
            assert math.isclose(d, t, rel_tol=1e-6) and math.isfinite(d)
    assert len({s["train"][name]["param_digest"] for s in summaries}) == 1


def test_trainer_cli_runs_one_worker_per_rank(runs):
    """``main`` under a torchrun-like environment: rank 0 logs one step."""
    _, _, summaries = runs
    assert "step    0 loss" in summaries[0]["cli"]
    assert all(s["cli"] == "" for s in summaries[1:])


# ------------------------------------------------------------------ wire


@pytest.mark.parametrize("method", list(CASES))
def test_fused_wire_bytes_equal_jax_and_roundtrip(runs, method):
    """The bucketed payload of worker 0's first round: its fused uint8 wire
    buffer equals the JAX package's ``fuse_payload`` byte for byte, and
    ``unfuse_payload`` (also with a leading worker dim) gives every field
    back bitwise."""
    jax_out, _, _ = runs
    cfg = _config(method, "bucketed")
    g = {p: torch.from_numpy(v[0]) for p, v in ((p, _inputs()[f"{p}0"]) for p in SHAPES)}
    layout = bucket_layout(cfg, g)
    comp = bucketed_compressor(cfg, layout)
    key = worker_key(prng.fold_in(prng.PRNGKey(SEED_KEY), 0), 0)
    pay = comp.compress(layout.flatten(g), key)
    wire = fuse_payload(pay)
    assert wire.dtype == torch.uint8 and wire.dim() == 2
    assert np.array_equal(wire.numpy(), jax_out[f"{method}/wire"])
    recipe = payload_recipe(pay)
    for back in (unfuse_payload(wire, recipe),
                 unfuse_payload(torch.stack([wire, wire]), recipe).select(1)):
        for f, b in zip(pay, back):
            assert (f is None) == (b is None)
            if f is not None:
                assert b.dtype == f.dtype and torch.equal(b.view(torch.uint8),
                                                          f.contiguous().view(torch.uint8))




# ------------------------------------------------------- world of one


@pytest.fixture(scope="module")
def world_of_one():
    """A one-rank gloo group in this process (the card's NCCL world of one
    runs the same code in chip_smoke.py)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", TRAIN_METHODS)
def test_world_of_one_trainer_bitwise_in_turn(world_of_one, one_thread, method):
    """At world 1 the distributed trainer is the in-turn trainer at n = 1 bit
    for bit, losses included, ``none`` too (its all-reduce is one term)."""
    cfg = replace(_train_config(), compression=method, comp_k=4096)
    params0 = init_model(cfg, "cpu", seed=2)
    opt = train.make_optimizer(cfg, lr=3e-4)
    shape = ShapeConfig("t", 16, 2, "train")

    def run(step_fn):
        params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in params0.items()}
        state, losses = opt.init(params, 1), []
        for s in range(2):
            batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, shape, s).items()}
            params, state, met = step_fn(params, state, batch, prng.fold_in(prng.PRNGKey(0), s))
            losses.append(met["loss"])
        return losses, params, state.diana

    t_loss, t_params, t_diana = run(train.build_train_step(cfg, opt, 1, "cpu"))
    d_loss, d_params, d_diana = run(train.build_distributed_step(cfg, opt))
    assert all(torch.equal(a, b) for a, b in zip(d_loss, t_loss))
    assert all(torch.equal(d_params[p], t_params[p]) for p in t_params)
    assert torch.equal(d_diana.h_worker, t_diana.h_worker)
    assert torch.equal(d_diana.h_server, t_diana.h_server)


def test_policy_and_chunked_configs_refused(world_of_one):
    """A policy runs: a uniform policy's round is the flat config's bit for
    bit (its state too, over two rounds, with a downlink); anything else
    than a config or a policy raises TypeError, as does a participation
    that is not a spec; and a ``chunk_bytes`` config (two chunks, with its
    chunked downlink) runs, its rounds bitwise the monolithic config's."""
    from repro_torch.core.policy import CompressionPolicy

    cfg = replace(_config("diana", "bucketed"), down_method="topk_ef", down_k=8)
    pol = CompressionPolicy.uniform(cfg)
    data = _inputs()
    s_cfg = init_state({p: torch.zeros(s) for p, s in SHAPES.items()}, cfg, 1)
    s_pol = init_state({p: torch.zeros(s) for p, s in SHAPES.items()}, pol, 1)
    for r in range(ROUNDS):
        grads = {p: torch.from_numpy(data[f"{p}{r}"][0].copy()) for p in SHAPES}
        key = prng.fold_in(prng.PRNGKey(SEED_KEY), r)
        extra = dict(down_key=prng.fold_in(key, DOWN_FOLD))
        g1, s_cfg = aggregate_distributed(grads, s_cfg, worker_key(key, 0), cfg, **extra)
        g2, s_pol = aggregate_distributed(grads, s_pol, worker_key(key, 0), pol, **extra)
        assert all(torch.equal(g1[p], g2[p]) for p in SHAPES)
        for a, b in zip(s_cfg, s_pol):
            assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(TypeError):
        aggregate_distributed(grads, s_cfg, prng.PRNGKey(0), object())
    with pytest.raises(TypeError, match="participation"):
        CompressionPolicy(participation=0.5)
    chunked = replace(cfg, chunk_bytes=256)
    layout = bucket_layout(chunked, {p: torch.zeros(s) for p, s in SHAPES.items()})
    from repro_torch.core.bucket import ChunkedSchedule
    assert ChunkedSchedule.for_layout(layout, 256).n_chunks == 2
    s_mono = init_state({p: torch.zeros(s) for p, s in SHAPES.items()}, cfg, 1)
    s_chunk = init_state({p: torch.zeros(s) for p, s in SHAPES.items()}, chunked, 1)
    for r in range(ROUNDS):
        grads = {p: torch.from_numpy(data[f"{p}{r}"][0].copy()) for p in SHAPES}
        key = prng.fold_in(prng.PRNGKey(SEED_KEY), r)
        extra = dict(down_key=prng.fold_in(key, DOWN_FOLD))
        g1, s_mono = aggregate_distributed(grads, s_mono, worker_key(key, 0), cfg, **extra)
        g2, s_chunk = aggregate_distributed(grads, s_chunk, worker_key(key, 0), chunked, **extra)
        assert all(torch.equal(g1[p], g2[p]) for p in SHAPES)
        for a, b in zip(s_mono, s_chunk):
            assert (a is None and b is None) or torch.equal(a, b)


def test_cli_mesh_must_match_the_world(monkeypatch):
    """Under torchrun (``WORLD_SIZE`` set) ``--mesh Nx1`` needs N = the world
    size: ``--mesh 2x1`` in a world of 4 raises before joining it."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="4 ranks"):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x1",
                    "--steps", "1", "--batch", "4", "--seq", "16"])
