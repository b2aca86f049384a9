"""The port's ``--mesh 2x2`` trainer against the JAX package's
``build_train_step`` on an Auto-axis ``(2, 2)`` host mesh (a JAX
subprocess with 4 host devices; ``jax.make_mesh``'s Explicit axes fail the
JAX trainer on jax 0.9.0, ``jax.sharding.Mesh`` does not), from the JAX
trainer's own initial weights (``init_train_state``, converted), reduced
llama3.2-1b, batch 4 x 32, lr 3e-4, per leaf (the JAX package's bucketed
round aborts in XLA's SPMD partitioner on this mesh, so the port's
``resolve_bucketed`` downgrades a bucketed config, with one warning).

4 gloo ranks of CPU processes, 2 workers x 2 model shards:

* ``none`` with ``sgd``, 2 steps, through ``build_distributed_step`` and
  through the CLI (``--mesh 2x2 --compression none --inner sgd``, the
  bucketed default downgraded, ``--checkpoint-dir``): the losses and the
  parameters (the CLI's gathered into its checkpoint) within rtol 1e-5 /
  atol 1e-6 of the JAX trainer's.  The gradients differ from GSPMD's only
  in the order of the tensor-parallel sums (``tests/test_torch_mesh_model
  .py``), and ``none`` adds two terms exactly;
* ``diana`` with momentum, 2 steps: each step's round, fed the port's own
  gradient shards (gathered into the global arrays), is bitwise the JAX
  trainer's round (the nested per-leaf ``aggregate_shardmap`` on the same
  mesh, keys ``fold_in(fold_in(PRNGKey(0), step), worker)``), ghat, and
  the memories gathered by ``gather_train_state`` into the JAX trainer's
  global layout; the losses within rtol 1e-5 / atol 1e-6 of the JAX
  trainer's; and the parameters within ``tests/test_torch_train.py``'s
  stochastic-rounding bound: at most 1e-5 of the coordinates outside rtol
  1e-5 / atol 1e-6, none by more than ``steps * lr * (1 + beta) * s / n``,
  ``s`` the largest block scale (at most the largest ``|g - h|`` a worker
  encoded).
"""

import contextlib
import io
import json
import os
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_round import (JAX_ROUND, finish_jax, init_gloo, same_bits, shard_of, spawn,
                                   start_jax)

N, M = 2, 2
STEPS, LR, BATCH, SEQ = 2, 3e-4, 4, 32
RTOL, ATOL = 1e-5, 1e-6
RUNS = [{"tag": "none", "method": "none", "inner": "sgd", "bucketed": False},
        {"tag": "diana", "method": "diana", "inner": "momentum", "bucketed": False}]

# The JAX trainer on an Auto (N, M) mesh: the initial weights ("init/{path}"),
# the batches ("batch/{s}/{k}"), and per run each step's loss and
# parameters ("{tag}/loss/{s}", "{tag}/params/{s}/{path}"); with "save", the
# JAX CLI's checkpoint of the parameters after the steps.
JAX_TRAIN = r"""
import json, sys, warnings
from dataclasses import replace
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.data import make_lm_batch
from repro.launch.sharding_rules import batch_specs
from repro.launch.train import build_train_step, init_train_state, make_optimizer
from repro.optim import DianaOptimizer, constant_schedule
from repro.optim.optimizers import sgd

spec, tmp = json.loads(sys.argv[1]), sys.argv[2]
N, M = spec["N"], spec["M"]
mesh = Mesh(np.array(jax.devices()[:N * M]).reshape(N, M), ("data", "model"))
cfg0 = reduced(get_config("llama3.2-1b"))
shape = ShapeConfig("t", spec["seq"], spec["batch"], "train")
key = jax.random.PRNGKey(0)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


out = {}
batches = [make_lm_batch(cfg0, shape, s) for s in range(spec["steps"])]
for s, b in enumerate(batches):
    for k, v in b.items():
        out[f"batch/{s}/{k}"] = v
for run in spec["runs"]:
    cfg = replace(cfg0, compression=run["method"], comp_bucketed=run["bucketed"])
    opt = make_optimizer(cfg, lr=spec["lr"])
    if run["inner"] == "sgd":
        opt = DianaOptimizer(inner=sgd(), schedule=constant_schedule(spec["lr"]),
                             policy=opt.policy)
    params, state, _ = init_train_state(cfg, opt, mesh, key)
    for p, v in flat(params).items():
        out[f"init/{p}"] = np.asarray(v)
    step = build_train_step(cfg, opt, mesh, shape)
    for s, hb in enumerate(batches):
        b = jax.tree_util.tree_map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)),
                                   hb, batch_specs(hb, mesh))
        params, state, met = step(params, state, b, jax.random.fold_in(key, s))
        out[f"{run['tag']}/loss/{s}"] = np.asarray(met["loss"])
        for p, v in flat(params).items():
            out[f"{run['tag']}/params/{s}/{p}"] = np.asarray(v)
    if run.get("save"):
        from repro.checkpoint import save_checkpoint

        save_checkpoint(f"{tmp}/jax_ckpt_{run['tag']}", spec["steps"], {"params": params},
                        metadata={"policy": opt.policy.to_json_dict()})
np.savez(f"{tmp}/jax_train.npz", **out)
"""


def jax_train_spec(runs, n=N, m=M, steps=STEPS):
    return {"N": n, "M": m, "seq": SEQ, "batch": BATCH, "lr": LR, "steps": steps, "runs": runs}


def init_tree(data):
    return {k[len("init/"):]: data[k] for k in data.files if k.startswith("init/")}


def batches(cfg, data, steps=STEPS):
    """The port's batches, each asserted equal to the JAX package's."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_lm_batch

    out = []
    for s in range(steps):
        b = make_lm_batch(cfg, ShapeConfig("t", SEQ, BATCH, "train"), s)
        assert all(np.array_equal(v, data[f"batch/{s}/{k}"]) for k, v in b.items())
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


class RoundRecorder:
    """Wraps ``aggregate_distributed`` in the trainer module: each call's
    gradient shards, key and results, as numpy."""

    def __init__(self, train):
        self.train, self.calls = train, []

    def __enter__(self):
        orig = self.orig = self.train.aggregate_distributed

        def rec(grads, state, key, cfg, **kw):
            g = {p: v.detach().clone().numpy() for p, v in grads.items()}
            ghat, new = orig(grads, state, key, cfg, **kw)
            self.calls.append({"grads": g, "ghat": {p: v.numpy() for p, v in ghat.items()}})
            return ghat, new
        self.train.aggregate_distributed = rec
        return self

    def __exit__(self, *exc):
        self.train.aggregate_distributed = self.orig


def run_steps(cfg, opt, step_fn, params, state, bs):
    from repro_torch.core import prng

    losses = []
    for s, b in enumerate(bs):
        params, state, met = step_fn(params, state, b, prng.fold_in(prng.PRNGKey(0), s))
        losses.append(float(met["loss"]))
    return losses, params, state


def _rank_main(rank, tmp):
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import gather_train_state, params_from_jax, params_shard_from_jax
    from repro_torch.launch import train
    from repro_torch.launch.mesh import mesh_groups, parse_mesh

    tmp = Path(tmp)
    init_gloo(rank, N * M, str(tmp / "store"))
    mesh = parse_mesh(f"{N}x{M}")
    groups = mesh_groups(mesh)
    data = np.load(tmp / "jax_train.npz")
    cfg0 = reduced(get_config("llama3.2-1b"))
    bs = batches(cfg0, data)
    out, summary = {}, {}
    for run in RUNS:
        cfg = replace(cfg0, compression=run["method"], comp_bucketed=run["tag"] == "diana")
        opt = train.make_optimizer(cfg, lr=LR, inner=run["inner"])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            opt = train.resolve_bucketed(opt, mesh)
        summary[f"{run['tag']}/warnings"] = [str(w.message) for w in caught]
        params = params_shard_from_jax(init_tree(data), cfg, "cpu", M, groups.shard)
        state = opt.init(params, 1)
        with RoundRecorder(train) as rec:
            losses, params, state = run_steps(cfg, opt, train.build_distributed_step(
                cfg, opt, mesh=mesh), params, state, bs)
        summary[f"{run['tag']}/losses"] = losses
        for p, v in params.items():
            out[f"{run['tag']}/params/{p}"] = v.detach().numpy()
        for s, call in enumerate(rec.calls):
            for name in ("grads", "ghat"):
                for p, v in call[name].items():
                    out[f"{run['tag']}/{s}/{name}/{p}"] = v
        gp, gstate = gather_train_state(params, state, cfg, mesh, groups)
        for name, t in (("hw", gstate.diana.h_worker), ("hs", gstate.diana.h_server)):
            for p, v in t.items():
                out[f"{run['tag']}/gathered/{name}/{p}"] = v.numpy()

    # The CLI, under a torchrun-like environment with the group already up,
    # from the JAX trainer's initial weights.
    full = params_from_jax(init_tree(data), cfg0, "cpu")
    train.init_model = lambda cfg, device, seed=0: {p: torch.nn.Parameter(v.detach().clone())
                                                    for p, v in full.items()}
    os.environ["WORLD_SIZE"] = str(N * M)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x2",
                    "--compression", "none", "--inner", "sgd", "--steps", str(STEPS),
                    "--batch", str(BATCH), "--seq", str(SEQ), "--checkpoint-dir",
                    str(tmp / "port_ckpt")])
    summary["cli"] = buf.getvalue()
    summary["cli/warnings"] = [str(w.message) for w in caught if w.category is RuntimeWarning]
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(summary))
    if dist.is_initialized():
        dist.destroy_process_group()


def _global(ranks, key, specs_p, fn):
    """The global numpy array of a per-rank field: worker ``w``'s model
    shards concatenated along the leaf's split dimension."""
    parts = [[ranks[w * M + m][key] for m in range(M)] for w in range(N)]
    return [fn(row) if specs_p is None else np.concatenate(row, axis=specs_p) for row in parts]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.sharding_rules import param_specs
    from repro_torch.models.transformer import param_shapes

    tmp = tmp_path_factory.mktemp("mesh_train")
    finish_jax(start_jax(JAX_TRAIN, [json.dumps(jax_train_spec(RUNS)), tmp]))
    spawn(_rank_main, N * M, (str(tmp),))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N * M)]
    summaries = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N * M)]
    cfg = reduced(get_config("llama3.2-1b"))
    specs = param_specs(param_shapes(cfg), cfg, M)
    # the JAX trainer's round fed the port's gradients, step by step
    feed, block = {}, cfg.comp_block
    for s in range(STEPS):
        for p, d in specs.items():
            rows = _global(ranks, f"diana/{s}/grads/{p}", d, lambda r: r[0])
            feed[f"g/diana/{s}/{p}"] = np.stack(rows)
    np.savez(tmp / "feed.npz", **feed)
    spec = {"N": N, "M": M, "seed": 0, "rounds": STEPS,
            "shapes": {p: list(s) for p, s in param_shapes(cfg).items()},
            "cases": [{"tag": "diana", "method": "diana", "kw": {"block_size": block}}]}
    finish_jax(start_jax(JAX_ROUND, [json.dumps(spec), tmp / "feed.npz", tmp / "replay.npz"]))
    return (dict(np.load(tmp / "jax_train.npz")), dict(np.load(tmp / "replay.npz")), ranks,
            summaries, specs, tmp)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= ATOL + RTOL * np.abs(b)


def test_none_sgd_matches_the_jax_trainer(runs):
    jax_out, _, ranks, summaries, specs, _ = runs
    for s in range(STEPS):
        assert _close(summaries[0]["none/losses"][s], jax_out[f"none/loss/{s}"]), s
    for rank, got in enumerate(ranks):
        m = rank % M
        for p, d in specs.items():
            want = shard_of(jax_out[f"none/params/{STEPS - 1}/{p}"], d, m)
            assert np.all(_close(got[f"none/params/{p}"], want)), (rank, p)


def test_cli_mesh_2x2_matches_the_jax_trainer(runs):
    """The CLI downgrades the bucketed default once (the JAX form), logs the
    JAX trainer's losses and checkpoints its parameters, gathered whole."""
    from repro_torch.checkpoint import restore_checkpoint

    jax_out, _, _, summaries, specs, tmp = runs
    warned = summaries[0]["cli/warnings"]
    assert len(warned) == 1 and "inner_axes=('model',) resulting_layout=per-leaf" in warned[0]
    lines = [ln for ln in summaries[0]["cli"].splitlines() if ln.startswith("step")]
    assert len(lines) == STEPS
    for s, ln in enumerate(lines):
        assert abs(float(ln.split()[3]) - float(jax_out[f"none/loss/{s}"])) <= 1e-4, ln
    assert all(s["cli"] == "" for s in summaries[1:])
    template = {"params": {p: torch.zeros(jax_out[f"init/{p}"].shape) for p in specs}}
    tree, step = restore_checkpoint(str(tmp / "port_ckpt"), template)
    assert step == STEPS
    for p in specs:
        assert np.all(_close(tree["params"][p].numpy(), jax_out[f"none/params/{STEPS - 1}/{p}"]))


def test_diana_rounds_bitwise_the_jax_round_on_the_ports_gradients(runs):
    jax_out, replay, ranks, summaries, specs, _ = runs
    assert len(summaries[0]["diana/warnings"]) == 1
    for s in range(STEPS):
        for rank, got in enumerate(ranks):
            m = rank % M
            for p, d in specs.items():
                want = shard_of(replay[f"diana/{s}/ghat/{p}"], d, m)
                assert same_bits(got[f"diana/{s}/ghat/{p}"], want), (s, rank, p)
    # the memories, gathered into the JAX trainer's global layout
    for p in specs:
        for name in ("hw", "hs"):
            for got in ranks:
                assert same_bits(got[f"diana/gathered/{name}/{p}"],
                                 replay[f"diana/{STEPS - 1}/{name}/{p}"]), (name, p)


def test_diana_losses_and_parameters_within_the_flip_bound(runs):
    jax_out, replay, ranks, summaries, specs, _ = runs
    for s in range(STEPS):
        assert _close(summaries[0]["diana/losses"][s], jax_out[f"diana/loss/{s}"]), s
    # s_max <= the largest |g - h| any rank encoded (its shard-local delta)
    s_max = 0.0
    for s in range(STEPS):
        for rank, got in enumerate(ranks):
            w, m = divmod(rank, M)
            for p, d in specs.items():
                h = (np.zeros(1) if s == 0 else
                     shard_of(replay[f"diana/{s - 1}/hw/{p}"][w], None if d is None else 0, m))
                g = got[f"diana/{s}/grads/{p}"].reshape(-1).astype(np.float64)
                s_max = max(s_max, float(np.abs(g - h).max()))
    bound = STEPS * LR * (1 + 0.9) * s_max / N + ATOL
    outside, total = 0, 0
    for rank, got in enumerate(ranks):
        for p, d in specs.items():
            want = shard_of(jax_out[f"diana/params/{STEPS - 1}/{p}"], d, rank % M)
            ok = _close(got[f"diana/params/{p}"], want)
            outside += int((~ok).sum())
            total += ok.size
            assert np.abs(got[f"diana/params/{p}"].astype(np.float64) - want).max() <= bound, p
    assert outside <= 1e-5 * total, (outside, total)
