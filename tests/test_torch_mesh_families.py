"""The port's ``--mesh 2x2`` trainer on the MoE family against the JAX
package's ``build_train_step`` on an Auto-axis ``(2, 2)`` host mesh, from
the JAX trainer's own initial weights, batch 4 x 32, lr 3e-4, per leaf:
reduced granite-moe-3b-a800m (the ``ffn`` partition) and
phi3.5-moe-42b-a6.6b (the ``expert`` partition, bf16 memories).
``tests/test_torch_mesh_frontends.py`` holds internvl2-2b and
musicgen-large (the column-parallel frontend projection) the same way, with
this file's JAX script and checks (one file each keeps each under a minute).

phi3.5-moe's JAX config sets ``comp_worker_axes=("pod",)``; a ``(data,
model)`` mesh has no ``pod`` axis, so the JAX trainer would open no worker
``shard_map`` and run the MoE body manual over both axes.  The JAX side
runs it with ``comp_worker_axes=("pod", "data")`` (the default), which is
the port's layout: the worker ``shard_map`` over ``data``, the nested MoE
``shard_map`` over ``model`` (the port has one worker axis, ROADMAP.md "Not
ported, by design").

One JAX subprocess (4 host devices) writes every arch's initial weights,
their shards on worker 0's devices and the batches, traces every trainer
and the round replayed below and compiles them together, trains, then
waits for the port's gradient shards and replays the JAX trainer's round on
them (the nested per-leaf ``aggregate_shardmap``, the arch's own
``param_specs``); 4 gloo ranks of CPU processes run the port, 2 workers x 2
model shards, from the initial weights while the JAX trainer compiles:

* every rank's initial parameters (``params_shard_from_jax``) are the bits
  of the JAX trainer's shards on its devices;

* ``none`` with ``sgd``, 2 steps: the losses, ``ghat_norm`` and every
  parameter shard within rtol 1e-5 / atol 1e-6 of the JAX trainer's (the
  gradients differ in the order of the tensor-parallel sums and the MoE
  combine);
* ``diana`` with momentum, 2 steps (bucketed asked, downgraded per leaf
  with one warning): each step's round bitwise the JAX round fed the
  port's gradient shards (ghat, its ``ghat_norm`` within 1e-6, and the
  memories gathered by ``gather_train_state``); the losses within rtol
  1e-5 / atol 1e-6; the parameters within
  ``tests/test_torch_mesh_train.py``'s flip bound;
* ``gather_train_state`` -> ``shard_train_state`` gives every rank's
  parameters, momentum and memories back bit for bit;
* the CLI (``--arch phi3.5-moe-42b-a6.6b --reduced --mesh 2x2
  --compression none --inner sgd``) logs the JAX trainer's losses.
"""

import contextlib
import io
import json
import os
import time
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_round import init_gloo, same_bits, shard_of, spawn, start_jax
from test_torch_mesh_train import RoundRecorder

N, M = 2, 2
STEPS, LR, BATCH, SEQ = 2, 3e-4, 4, 32
RTOL, ATOL = 1e-5, 1e-6
SSM_NORMWISE = 1e-4    # tests/test_torch_model_families.py's bound for the Mamba-2 archs
SSM_FLIPS = 1e-5 * SSM_NORMWISE / RTOL   # see check_diana_flip_bound
ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
WORKER_AXES = {"phi3.5-moe-42b-a6.6b": ["pod", "data"], "jamba-v0.1-52b": ["pod", "data"]}
CLI_ARCH = "phi3.5-moe-42b-a6.6b"
RUNS = [{"tag": "none", "method": "none", "inner": "sgd"},
        {"tag": "diana", "method": "diana", "inner": "momentum"}]

# The JAX trainer on an Auto (N, M) mesh per arch: the initial weights
# ("{arch}/init/{path}") and the shard of each on the devices of worker 0
# ("{arch}/shard/{m}/{path}"), the batches ("{arch}/batch/{s}/{k}"), per run each
# step's loss and the last step's parameters; then, once "feed.npz" appears
# (the port's per-worker global gradients "{arch}/{s}/{path}", (N, *shape)),
# the JAX trainer's round replayed on them ("{arch}/{s}/{ghat,hw,hs}/{path}").
# Each step's state goes back into the shardings it started in, so that the
# step compiles once (the first step's outputs come back in other ones).
JAX_FAMILIES = r"""
import json, os, sys, time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.core import DianaState, aggregate_shardmap, init_state
from repro.data import make_lm_batch
from repro.launch.sharding_rules import batch_specs, param_specs
from repro.launch.train import build_train_step, h_flat_specs, init_train_state, make_optimizer
from repro.optim import DianaOptimizer, constant_schedule
from repro.optim.optimizers import sgd

spec, tmp = json.loads(sys.argv[1]), sys.argv[2]
N, M = spec["N"], spec["M"]
mesh = Mesh(np.array(jax.devices()[:N * M]).reshape(N, M), ("data", "model"))
shape = ShapeConfig("t", spec["seq"], spec["batch"], "train")
key = jax.random.PRNGKey(0)
tmap = jax.tree_util.tree_map


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def nest(fl):
    out = {}
    for path, v in fl.items():
        d = out
        *head, last = path.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def arch_cfg(arch):
    cfg = reduced(get_config(arch))
    if arch in spec["worker_axes"]:
        cfg = replace(cfg, comp_worker_axes=tuple(spec["worker_axes"][arch]))
    return cfg


def optimizer(cfg, inner):
    opt = make_optimizer(cfg, lr=spec["lr"])
    if inner == "sgd":
        opt = DianaOptimizer(inner=sgd(), schedule=constant_schedule(spec["lr"]),
                             policy=opt.policy)
    return opt


def save(name, tree):
    np.savez(f"{tmp}/{name}.tmp.npz", **tree)
    os.replace(f"{tmp}/{name}.tmp.npz", f"{tmp}/{name}.npz")


def host(v):
    # bf16 leaves (phi3.5-moe's memories) as their exact f32 values: numpy
    # cannot load ml_dtypes' bfloat16 without it
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# the initial weights and the batches first, so the port's ranks start while
# the JAX trainer compiles
init, out, setups = {}, {}, []
for arch in spec["archs"]:
    cfg0 = arch_cfg(arch)
    batches = [make_lm_batch(cfg0, shape, s) for s in range(spec["steps"])]
    for s, b in enumerate(batches):
        for k, v in b.items():
            init[f"{arch}/batch/{s}/{k}"] = v
    for run in spec["runs"]:
        cfg = replace(cfg0, compression=run["method"], comp_bucketed=False)
        opt = optimizer(cfg, run["inner"])
        params, state, shardings = init_train_state(cfg, opt, mesh, key)
        for p, v in flat(params).items():
            init.setdefault(f"{arch}/init/{p}", np.asarray(v))
            assert np.array_equal(init[f"{arch}/init/{p}"], np.asarray(v))
            for m in range(M):
                dev = mesh.devices[0, m]
                init[f"{arch}/shard/{m}/{p}"] = next(
                    np.asarray(sh.data) for sh in v.addressable_shards if sh.device == dev)
        setups.append((arch, run, cfg, opt, params, state, shardings, batches))
save("init", init)


def placed(tree, spec_of):
    return tmap(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)), tree, spec_of(tree))


def replay_fn(arch):
    # The JAX trainer's round alone (the nested per-leaf aggregate_shardmap
    # under the worker shard_map), lowered on inputs placed as its specs say.
    cfg = replace(arch_cfg(arch), compression="diana", comp_bucketed=False)
    comp = optimizer(cfg, "momentum").policy
    pre = f"{arch}/init/"
    tmpl = nest({k[len(pre):]: jnp.zeros(v.shape, v.dtype) for k, v in init.items()
                 if k.startswith(pre)})
    gspecs = param_specs(tmpl, cfg, mesh)
    hspecs = h_flat_specs(gspecs)
    st = init_state(tmpl, comp, N)

    def body(g_st, hw, hs, k, widx):
        g = tmap(lambda x: x[0], g_st)
        ghat, ns = aggregate_shardmap(
            g, DianaState(hw, hs), jax.random.fold_in(k, widx[0]), comp,
            axis_names=("data",), n_workers=N, inner_axes=("model",), grad_specs=gspecs,
            h_specs=hspecs, mesh=mesh)
        return ghat, ns.h_worker, ns.h_server

    wsp = lambda t: tmap(lambda _: P("data"), t)
    rep = lambda t: tmap(lambda _: P(), t)
    in_specs = (wsp(tmpl), wsp(st.h_worker), rep(st.h_server), P(), P("data"))
    f = jax.jit(shard_map(
        body, mesh=mesh, in_specs=in_specs,
        out_specs=(rep(tmpl), wsp(st.h_worker), rep(st.h_server)),
        axis_names={"data"}, check_vma=False))
    args = (tmap(lambda t: jax.ShapeDtypeStruct((N, *t.shape), t.dtype), tmpl),
            placed(st.h_worker, wsp), placed(st.h_server, rep), jax.random.fold_in(key, 0),
            jax.device_put(jnp.arange(N, dtype=jnp.int32), NamedSharding(mesh, P("data"))))
    args = (placed(tmap(jnp.zeros_like, args[0]), wsp),) + args[1:]
    return f.lower(*args), args, (lambda g: placed(g, wsp))


# every executable traced here and compiled together: the runs' steps, then
# each arch's replayed round
lowered = [build_train_step(cfg, opt, mesh, shape).lower(
               params, state, placed(batches[0], lambda t: batch_specs(t, mesh)),
               jax.random.fold_in(key, 0))
           for arch, run, cfg, opt, params, state, shardings, batches in setups]
replays = {arch: replay_fn(arch) for arch in spec["archs"]}
lowered += [r[0] for r in replays.values()]
with ThreadPoolExecutor(len(lowered)) as pool:
    compiled = list(pool.map(lambda lo: lo.compile(), lowered))
for i, (arch, run, cfg, opt, params, state, shardings, batches) in enumerate(setups):
    for s, hb in enumerate(batches):
        b = placed(hb, lambda t: batch_specs(t, mesh))
        params, state, met = compiled[i](params, state, b, jax.random.fold_in(key, s))
        # back into the shardings the executable takes
        params, state = jax.device_put((params, state), shardings)
        out[f"{arch}/{run['tag']}/loss/{s}"] = np.asarray(met["loss"])
        out[f"{arch}/{run['tag']}/ghat_norm/{s}"] = np.asarray(met["ghat_norm"])
    for p, v in flat(params).items():
        out[f"{arch}/{run['tag']}/params/{p}"] = np.asarray(v)
save("jax_train", out)

deadline = time.monotonic() + 600
while not os.path.exists(f"{tmp}/feed.npz"):
    if time.monotonic() > deadline:
        sys.exit("no feed.npz from the port's ranks")
    time.sleep(0.2)
feed = np.load(f"{tmp}/feed.npz")
replay = {}
for (arch, (_, args, place_g)), f in zip(replays.items(), compiled[len(setups):]):
    _, hw, hs, _, widx = args
    h_shardings = tmap(lambda a: a.sharding, (hw, hs))
    paths = [k[len(f"{arch}/0/"):] for k in feed.files if k.startswith(f"{arch}/0/")]
    for s in range(spec["steps"]):
        g = place_g(nest({p: jnp.asarray(feed[f"{arch}/{s}/{p}"]) for p in paths}))
        ghat, hw, hs = f(g, hw, hs, jax.random.fold_in(key, s), widx)
        # the memories come back split over the model axis as well
        hw, hs = jax.device_put((hw, hs), h_shardings)
        for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs)):
            for p, v in flat(t).items():
                replay[f"{arch}/{s}/{name}/{p}"] = host(v)
save("replay", replay)
"""


def _batches(cfg, data, arch, seq):
    """The port's batches, each asserted equal to the JAX package's."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_lm_batch

    out = []
    for s in range(STEPS):
        b = make_lm_batch(cfg, ShapeConfig("t", seq, BATCH, "train"), s)
        assert all(np.array_equal(v, data[f"{arch}/batch/{s}/{k}"]) for k, v in b.items())
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def _init(data, arch):
    return {k[len(f"{arch}/init/"):]: data[k] for k in data.files if k.startswith(f"{arch}/init/")}


def _same_state(a, b) -> bool:
    """Parameters, momentum and memories of two per-leaf states, bitwise."""
    (pa, sa), (pb, sb) = a, b
    return (all(torch.equal(pa[p], pb[p]) for p in pa)
            and all(torch.equal(sa.inner[p], sb.inner[p]) for p in sa.inner)
            and all(torch.equal(sa.diana.h_worker[p], sb.diana.h_worker[p])
                    and torch.equal(sa.diana.h_server[p], sb.diana.h_server[p])
                    for p in sa.diana.h_worker))


def _rank_main(rank, tmp, archs, cli_arch, seq):
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import (gather_train_state, params_from_jax, params_shard_from_jax,
                                     shard_train_state)
    from repro_torch.core import prng
    from repro_torch.launch import train
    from repro_torch.launch.mesh import mesh_groups, parse_mesh

    tmp = Path(tmp)
    init_gloo(rank, N * M, str(tmp / "store"))
    mesh = parse_mesh(f"{N}x{M}")
    groups = mesh_groups(mesh)
    data = np.load(tmp / "init.npz")
    out, summary = {}, {}
    for arch in archs:
        cfg0 = reduced(get_config(arch))
        bs = _batches(cfg0, data, arch, seq)
        mine = params_shard_from_jax(_init(data, arch), cfg0, "cpu", M, groups.shard)
        summary[f"{arch}/not_the_jax_shard"] = [
            p for p, v in mine.items()
            if not same_bits(v.detach().numpy(), data[f"{arch}/shard/{groups.shard}/{p}"])]
        for run in RUNS:
            cfg = replace(cfg0, compression=run["method"], comp_bucketed=run["tag"] == "diana")
            opt = train.make_optimizer(cfg, lr=LR, inner=run["inner"])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                opt = train.resolve_bucketed(opt, mesh)
            summary[f"{arch}/{run['tag']}/warnings"] = len(caught)
            params = params_shard_from_jax(_init(data, arch), cfg, "cpu", M, groups.shard)
            state = opt.init(params, 1)
            step_fn = train.build_distributed_step(cfg, opt, mesh=mesh)
            losses, norms = [], []
            with RoundRecorder(train) as rec:
                for s, b in enumerate(bs):
                    params, state, met = step_fn(params, state, b,
                                                 prng.fold_in(prng.PRNGKey(0), s))
                    losses.append(float(met["loss"]))
                    norms.append(float(met["ghat_norm"]))
            summary[f"{arch}/{run['tag']}/losses"] = losses
            summary[f"{arch}/{run['tag']}/ghat_norms"] = norms
            for p, v in params.items():
                out[f"{arch}/{run['tag']}/params/{p}"] = v.detach().numpy()
            if run["tag"] != "diana":
                continue
            for s, call in enumerate(rec.calls):
                for name in ("grads", "ghat"):
                    for p, v in call[name].items():
                        out[f"{arch}/{s}/{name}/{p}"] = v
            gp, gstate = gather_train_state(params, state, cfg, mesh, groups)
            for name, t in (("hw", gstate.diana.h_worker), ("hs", gstate.diana.h_server)):
                for p, v in t.items():
                    out[f"{arch}/gathered/{name}/{p}"] = v.float().numpy()
                    summary[f"{arch}/gathered/{name}/{p}/dtype"] = str(v.dtype)
            back = shard_train_state(gp, gstate, cfg, mesh, groups.worker, groups.shard)
            summary[f"{arch}/round_trip_bitwise"] = _same_state((params, state), back)

    if cli_arch is not None:
        # The CLI, under a torchrun-like environment with the group already
        # up, from the JAX trainer's initial weights.
        full = params_from_jax(_init(data, cli_arch), reduced(get_config(cli_arch)), "cpu")
        train.init_model = lambda cfg, device, seed=0: {
            p: torch.nn.Parameter(v.detach().clone()) for p, v in full.items()}
        os.environ["WORLD_SIZE"] = str(N * M)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            train.main(["--arch", cli_arch, "--reduced", "--device", "cpu", "--mesh", f"{N}x{M}",
                        "--compression", "none", "--inner", "sgd", "--steps", str(STEPS),
                        "--batch", str(BATCH), "--seq", str(seq)])
        summary["cli"] = buf.getvalue()
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(summary))
    if dist.is_initialized():
        dist.destroy_process_group()


def _global(ranks, key, dim):
    """Worker ``w``'s shards of a per-rank field concatenated along the
    leaf's split dimension, stacked over the workers: ``(N, *shape)``."""
    rows = []
    for w in range(N):
        parts = [ranks[w * M + m][key] for m in range(M)]
        rows.append(parts[0] if dim is None else np.concatenate(parts, axis=dim))
    return np.stack(rows)


def specs_of(arch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.sharding_rules import param_specs
    from repro_torch.models.transformer import param_shapes

    cfg = reduced(get_config(arch))
    return param_specs(param_shapes(cfg), cfg, M)


def _wait_for(path, proc, timeout=600):
    deadline = time.monotonic() + timeout
    while not path.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            out, err = proc.communicate(timeout=60)
            raise AssertionError(f"the JAX side ended before {path.name}:\n{out}\n{err[-4000:]}")
        time.sleep(0.2)


def run_families(tmp, archs, cli_arch=None, seq=SEQ):
    """The JAX subprocess and the port's ranks for ``archs`` on ``BATCH`` x
    ``seq``: ``(jax_train, replay, ranks, summaries)``."""
    spec = {"N": N, "M": M, "seq": seq, "batch": BATCH, "lr": LR, "steps": STEPS,
            "runs": RUNS, "archs": archs, "worker_axes": WORKER_AXES}
    proc = start_jax(JAX_FAMILIES, [json.dumps(spec), tmp])
    try:
        _wait_for(tmp / "init.npz", proc)
        spawn(_rank_main, N * M, (str(tmp), archs, cli_arch, seq))
        ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N * M)]
        feed = {}
        for arch in archs:
            for s in range(STEPS):
                for p, d in specs_of(arch).items():
                    feed[f"{arch}/{s}/{p}"] = _global(ranks, f"{arch}/{s}/grads/{p}", d)
        np.savez(tmp / "feed.tmp.npz", **feed)
        os.replace(tmp / "feed.tmp.npz", tmp / "feed.npz")
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    finally:
        if proc.poll() is None:
            proc.kill()
    summaries = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N * M)]
    return (dict(np.load(tmp / "jax_train.npz")), dict(np.load(tmp / "replay.npz")), ranks,
            summaries)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(tmp_path_factory.mktemp("mesh_families"), ARCHS, CLI_ARCH)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= ATOL + RTOL * np.abs(b)


def ssm_close(a, b):
    """The Mamba-2 families' bound against the JAX package
    (``tests/test_torch_model_families.py``): within ``SSM_NORMWISE`` of the
    array's largest entry, plus ``ATOL``.  The port forms the SSD's prefix
    sums in float64, the JAX package in f32."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= ATOL + SSM_NORMWISE * np.abs(b).max()


def check_none_sgd(runs, arch, close=_close):
    """The losses (the MoE aux included), ``ghat_norm`` (the split leaves'
    squares summed over the model group, the replicated ones once) and
    every parameter shard against the JAX trainer's, within ``close``."""
    jax_out, _, ranks, summaries = runs
    for s in range(STEPS):
        for summary in summaries:
            assert close(summary[f"{arch}/none/losses"][s], jax_out[f"{arch}/none/loss/{s}"])
            assert close(summary[f"{arch}/none/ghat_norms"][s],
                         jax_out[f"{arch}/none/ghat_norm/{s}"])
    for rank, got in enumerate(ranks):
        for p, d in specs_of(arch).items():
            want = shard_of(jax_out[f"{arch}/none/params/{p}"], d, rank % M)
            assert np.all(close(got[f"{arch}/none/params/{p}"], want)), (rank, p)


def check_diana_rounds(runs, arch):
    _, replay, ranks, summaries = runs
    assert summaries[0][f"{arch}/diana/warnings"] == 1
    specs = specs_of(arch)
    for s in range(STEPS):
        for rank, got in enumerate(ranks):
            for p, d in specs.items():
                want = shard_of(replay[f"{arch}/{s}/ghat/{p}"], d, rank % M)
                assert same_bits(got[f"{arch}/{s}/ghat/{p}"], want), (s, rank, p)
    for s in range(STEPS):      # ghat_norm of the bitwise ghat: the f32 sums' order apart
        want = np.sqrt(sum(np.sum(replay[f"{arch}/{s}/ghat/{p}"].astype(np.float64) ** 2)
                           for p in specs))
        for summary in summaries:
            assert abs(summary[f"{arch}/diana/ghat_norms"][s] - want) <= 1e-6 * want, s
    from repro_torch.configs import get_config

    h_dtype = str(get_config(arch).h_dtype)
    for p in specs:
        for name in ("hw", "hs"):
            want = replay[f"{arch}/{STEPS - 1}/{name}/{p}"]
            for got, summary in zip(ranks, summaries):
                assert summary[f"{arch}/gathered/{name}/{p}/dtype"] == h_dtype
                assert same_bits(got[f"{arch}/gathered/{name}/{p}"], want), (name, p)


def check_diana_flip_bound(runs, arch, close=_close, flips=1e-5):
    """The losses within ``close``; the parameters as
    ``tests/test_torch_mesh_train.py``: at most ``flips`` (1e-5) of the
    coordinates outside rtol 1e-5 / atol 1e-6, none by more than ``steps *
    lr * (1 + beta) * s / n``, ``s`` the largest ``|g - h|`` a rank
    encoded.  A coordinate's ternary draw flips with a probability of its
    gradient's difference from the JAX trainer's over its block scale, so
    the Mamba-2 archs, whose gradients may differ ten times as much
    (``SSM_NORMWISE`` against rtol 1e-5), allow ten times the flips
    (``SSM_FLIPS``)."""
    jax_out, replay, ranks, summaries = runs
    specs = specs_of(arch)
    for s in range(STEPS):
        assert close(summaries[0][f"{arch}/diana/losses"][s], jax_out[f"{arch}/diana/loss/{s}"])
    s_max = 0.0
    for s in range(STEPS):
        for rank, got in enumerate(ranks):
            w, m = divmod(rank, M)
            for p, d in specs.items():
                h = (np.zeros(1) if s == 0 else shard_of(
                    replay[f"{arch}/{s - 1}/hw/{p}"][w].astype(np.float64),
                    None if d is None else 0, m))
                g = got[f"{arch}/{s}/grads/{p}"].reshape(-1).astype(np.float64)
                s_max = max(s_max, float(np.abs(g - h).max()))
    bound = STEPS * LR * (1 + 0.9) * s_max / N + ATOL
    outside, total = 0, 0
    for rank, got in enumerate(ranks):
        for p, d in specs.items():
            want = shard_of(jax_out[f"{arch}/diana/params/{p}"], d, rank % M)
            ok = _close(got[f"{arch}/diana/params/{p}"], want)
            outside += int((~ok).sum())
            total += ok.size
            assert np.abs(got[f"{arch}/diana/params/{p}"].astype(np.float64) - want).max() \
                <= bound, p
    assert outside <= flips * total, (outside, total)


def check_jax_shards(runs, arch):
    """Every rank's initial parameters (``params_shard_from_jax``) are the
    bits of the JAX trainer's shards on its devices (``param_specs`` placed
    by ``NamedSharding``): the contiguous slices of the split leaves, the
    replicated leaves whole."""
    _, _, _, summaries = runs
    assert all(s[f"{arch}/not_the_jax_shard"] == [] for s in summaries)


def check_round_trip(runs, arch):
    """``gather_train_state`` -> ``shard_train_state`` on every rank gives
    back its parameters, momentum and memories bitwise."""
    _, _, _, summaries = runs
    assert all(s[f"{arch}/round_trip_bitwise"] for s in summaries)


@pytest.mark.parametrize("arch", ARCHS)
def test_initial_shards_are_the_jax_shards(runs, arch):
    check_jax_shards(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_none_sgd_matches_the_jax_trainer(runs, arch):
    check_none_sgd(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_diana_rounds_bitwise_the_jax_round_on_the_ports_gradients(runs, arch):
    check_diana_rounds(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_diana_losses_and_parameters_within_the_flip_bound(runs, arch):
    check_diana_flip_bound(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_state_shards_back_bitwise(runs, arch):
    check_round_trip(runs, arch)


def test_cli_mesh_2x2_matches_the_jax_trainer(runs):
    jax_out, _, _, summaries = runs
    lines = [ln for ln in summaries[0]["cli"].splitlines() if ln.startswith("step")]
    assert len(lines) == STEPS
    for s, ln in enumerate(lines):
        assert abs(float(ln.split()[3]) - float(jax_out[f"{CLI_ARCH}/none/loss/{s}"])) <= 1e-4, ln
    assert all(s["cli"] == "" for s in summaries[1:])
