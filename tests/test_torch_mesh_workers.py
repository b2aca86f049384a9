"""The port's ``--mesh 2x1`` trainer, in turn (``build_train_step``) and
one worker per rank (``build_distributed_step``, 2 gloo ranks of CPU
processes), against the JAX package's ``build_train_step`` on an Auto-axis
``(2, 1)`` host mesh (a JAX subprocess; ``jax.sharding.Mesh``, whose Auto
axes the JAX trainer lowers on jax 0.9.0, where ``jax.make_mesh``'s
Explicit axes fail it), bucketed and per leaf, from the JAX trainer's
initial weights: reduced llama3.2-1b, batch 4 x 32, lr 3e-4, 2 steps.
This file holds the bucketed layout, ``test_torch_mesh_workers_perleaf.py``
the per-leaf one.

* ``none`` with ``sgd``: the losses and the parameters of both port
  trainers within rtol 1e-5 / atol 1e-6 of the JAX trainer's (the
  gradients differ from XLA's in summation order only);
* ``diana`` with momentum: each step's round of the distributed trainer,
  fed its own gradients, bitwise the JAX trainer's round on the same mesh
  (``aggregate_shardmap`` bucketed, or the nested per-leaf round over a
  model axis of 1), ghat and the memories; the in-turn trainer bitwise the
  distributed one; the losses within rtol 1e-5 / atol 1e-6 and the
  parameters within ``tests/test_torch_train.py``'s stochastic-rounding
  bound (as ``tests/test_torch_mesh_train.py`` states it).
"""

import json
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_round import JAX_ROUND, finish_jax, init_gloo, same_bits, spawn, start_jax
from test_torch_mesh_train import (ATOL, JAX_TRAIN, LR, RTOL, STEPS, RoundRecorder, batches,
                                   init_tree, jax_train_spec, run_steps)

N = 2


def _runs_of(layout):
    return [{"tag": f"{m}/{layout}", "method": m, "inner": inner,
             "bucketed": layout == "bucketed"}
            for m, inner in (("none", "sgd"), ("diana", "momentum"))]


def _setup(run, data):
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import train

    cfg = replace(reduced(get_config("llama3.2-1b")), compression=run["method"],
                  comp_bucketed=run["bucketed"])
    opt = train.make_optimizer(cfg, lr=LR, inner=run["inner"])
    return cfg, opt, params_from_jax(init_tree(data), cfg, "cpu")


def _save_state(out, tag, params, diana, row=None):
    for p, v in params.items():
        out[f"{tag}/params/{p}"] = v.detach().numpy()
    for name, t in (("hw", diana.h_worker), ("hs", diana.h_server)):
        items = t.items() if isinstance(t, dict) else [(None, t)]
        for p, v in items:
            v = v if row is None or name == "hs" else v[row:row + 1]
            out[f"{tag}/{name}" + ("" if p is None else f"/{p}")] = v.numpy()


def _rank_main(rank, tmp, layout):
    from repro_torch.launch import train
    from repro_torch.launch.mesh import parse_mesh

    tmp = Path(tmp)
    init_gloo(rank, N, str(tmp / "store"))
    data = np.load(tmp / "jax_train.npz")
    out, summary = {}, {}
    for run in _runs_of(layout):
        cfg, opt, params = _setup(run, data)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step_fn = train.build_distributed_step(cfg, opt, mesh=parse_mesh(f"{N}x1"))
        assert not caught and train.resolved_layout(opt, parse_mesh(f"{N}x1")) == (
            "bucketed" if run["bucketed"] else "per-leaf")
        with RoundRecorder(train) as rec:
            losses, params, state = run_steps(cfg, opt, step_fn, params, opt.init(params, 1),
                                              batches(cfg, data))
        summary[run["tag"]] = losses
        _save_state(out, f"dist/{run['tag']}", params, state.diana)
        for s, call in enumerate(rec.calls):
            for name in ("grads", "ghat"):
                for p, v in call[name].items():
                    out[f"{run['tag']}/{s}/{name}/{p}"] = v
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(summary))
    dist.destroy_process_group()


def run_layout(tmp, layout):
    """The JAX trainer, the distributed trainer, the JAX rounds fed its
    gradients and the in-turn trainer, for one layout."""
    from repro_torch.launch import train

    runs = _runs_of(layout)
    finish_jax(start_jax(JAX_TRAIN, [json.dumps(jax_train_spec(runs, n=N, m=1)), tmp]),
               timeout=900)
    spawn(_rank_main, N, (str(tmp), layout))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
    summaries = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N)]
    data = np.load(tmp / "jax_train.npz")
    # the JAX trainer's rounds fed the distributed trainer's gradients
    feed, cases = {}, []
    for run in runs:
        if run["method"] != "diana":
            continue
        for s in range(STEPS):
            for k in ranks[0]:
                if k.startswith(f"{run['tag']}/{s}/grads/"):
                    p = k.split("/grads/")[1]
                    feed[f"g/{run['tag']}/{s}/{p}"] = np.stack([r[k] for r in ranks])
        cases.append({"tag": run["tag"], "method": "diana", "bucketed": run["bucketed"],
                      "kw": {"block_size": 2048}})
    np.savez(tmp / "feed.npz", **feed)
    shapes = {k.split("/grads/")[1]: list(ranks[0][k].shape) for k in ranks[0]
              if k.startswith(f"diana/{layout}/0/grads/")}
    spec = {"N": N, "M": 1, "seed": 0, "rounds": STEPS, "shapes": shapes, "cases": cases}
    jproc = start_jax(JAX_ROUND, [json.dumps(spec), tmp / "feed.npz", tmp / "replay.npz"], 2)
    # meanwhile, the in-turn trainer
    torch.set_num_threads(1)
    in_turn, losses = {}, {}
    for run in runs:
        cfg, opt, params = _setup(run, data)
        losses[run["tag"]], params, state = run_steps(
            cfg, opt, train.build_train_step(cfg, opt, N, "cpu"), params, opt.init(params, N),
            batches(cfg, data))
        _save_state(in_turn, run["tag"], params, state.diana)
    finish_jax(jproc)
    return (dict(data), dict(np.load(tmp / "replay.npz")), ranks, summaries, in_turn, losses)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= ATOL + RTOL * np.abs(b)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_layout(tmp_path_factory.mktemp("mesh_workers"), "bucketed")


def check_none_sgd(runs, layout):
    jax_out, _, ranks, summaries, in_turn, losses = runs
    tag = f"none/{layout}"
    for s in range(STEPS):
        want = jax_out[f"{tag}/loss/{s}"]
        assert _close(summaries[0][tag][s], want) and _close(losses[tag][s], want), s
    for k in in_turn:
        if k.startswith(f"{tag}/params/"):
            want = jax_out[k.replace("/params/", f"/params/{STEPS - 1}/")]
            assert np.all(_close(in_turn[k], want)), k
            for r in ranks:
                assert np.all(_close(r["dist/" + k], want)), k


def check_diana_rounds(runs, layout):
    jax_out, replay, ranks, summaries, in_turn, losses = runs
    tag = f"diana/{layout}"
    for s in range(STEPS):
        for k in ranks[0]:
            if k.startswith(f"{tag}/{s}/ghat/"):
                for r in ranks:
                    assert same_bits(r[k], replay[k]), k
    last = STEPS - 1
    for name in ("hw", "hs"):
        keys = [k for k in replay if k.startswith(f"{tag}/{last}/{name}")]
        assert keys
        for k in keys:
            mine = k.replace(f"{tag}/{last}/", f"{tag}/")
            for w, r in enumerate(ranks):
                got = r["dist/" + mine]
                assert same_bits(got, replay[k][w:w + 1] if name == "hw" else replay[k]), k
            assert same_bits(in_turn[mine], replay[k]), k
    for k in in_turn:
        if k.startswith(f"{tag}/params/"):
            assert all(same_bits(r["dist/" + k], in_turn[k]) for r in ranks), k
    assert summaries[0][tag] == losses[tag]
    for s in range(STEPS):
        assert _close(losses[tag][s], jax_out[f"{tag}/loss/{s}"]), s


def check_diana_flip_bound(runs, layout):
    jax_out, replay, ranks, _, in_turn, _ = runs
    tag = f"diana/{layout}"
    feedmax = max(float(np.abs(r[k]).max()) for r in ranks for k in r
                  if k.startswith(f"{tag}/") and "/grads/" in k)
    hmax = max(float(np.abs(v).max()) for k, v in replay.items() if k.startswith(f"{tag}/")
               and "/hw" in k)
    s_max = feedmax + hmax      # |g - h| <= |g| + |h|
    bound = STEPS * LR * (1 + 0.9) * s_max / N + ATOL
    outside, total = 0, 0
    for k in in_turn:
        if k.startswith(f"{tag}/params/"):
            want = jax_out[k.replace("/params/", f"/params/{STEPS - 1}/")]
            ok = _close(in_turn[k], want)
            outside += int((~ok).sum())
            total += ok.size
            assert np.abs(in_turn[k].astype(np.float64) - want).max() <= bound, k
    assert outside <= 1e-5 * total, (outside, total)


def test_none_sgd_both_trainers_match_the_jax_trainer(runs):
    check_none_sgd(runs, "bucketed")


def test_diana_rounds_bitwise_the_jax_round_and_in_turn(runs):
    check_diana_rounds(runs, "bucketed")


def test_diana_parameters_within_the_flip_bound(runs):
    check_diana_flip_bound(runs, "bucketed")
