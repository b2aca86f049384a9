"""The distributed trainer (``build_distributed_step``, 4 gloo ranks of CPU
processes, one worker each) on the new model families, against the in-turn
trainer's ``--mesh 4x1`` from the same weights, batches and keys:

* reduced ``nemotron-4-15b`` with bf16 DIANA memories (flat ``diana``,
  momentum), 2 steps: the parameters, each rank's ``h_worker`` row and
  ``h_server`` bit for bit, and the memories bf16 on both sides;
* reduced ``granite-moe-3b-a800m`` with ``--comp-policy default --inner
  adamw``, 1 step: every compressed group's memories (top-k EF, natural,
  ternary) bit for bit; the identity group (the router and the norm scales)
  is one all-reduce across ranks, in gloo's summation order, so those
  leaves' parameters are held within rtol 1e-6 of the in-turn step and
  every other parameter bit for bit (a second step would carry that
  difference into every gradient).

Each process runs torch with one thread, so that the CPU GEMMs block the
same way in both trainers.
"""

import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 4
SHAPE = ("t", 32, 8, "train")
CASES = {"nemotron-bf16": ("nemotron-4-15b", None, "momentum", 2),
         "granite-moe-policy-adamw": ("granite-moe-3b-a800m", "default", "adamw", 1)}


def _train(cfg, opt, build, state, params0, steps):
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import prng
    from repro_torch.data.pipeline import make_lm_batch
    params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in params0.items()}
    step_fn = build(opt)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_lm_batch(cfg, ShapeConfig(*SHAPE), s).items()}
        params, state, met = step_fn(params, state, batch, prng.fold_in(prng.PRNGKey(0), s))
        losses.append(float(met["loss"]))
    return losses, params, state


def _rank_main(rank, tmp, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, N), rank=rank, world_size=N)
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import partition_for
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    out = {}
    for name, (arch, policy, inner, steps) in CASES.items():
        cfg = reduced(get_config(arch))
        params0 = init_model(cfg, "cpu", seed=1)
        opt = train.make_optimizer(cfg, lr=3e-4, inner=inner, policy=policy)
        t_loss, t_params, t_state = _train(
            cfg, opt, lambda o: train.build_train_step(cfg, o, N, "cpu"), opt.init(params0, N),
            params0, steps)
        d_loss, d_params, d_state = _train(
            cfg, opt, lambda o: train.build_distributed_step(cfg, o), opt.init(params0, 1),
            params0, steps)
        td, dd = t_state.diana, d_state.diana
        res = {"losses": [d_loss, t_loss], "memories": {}, "params": {}}
        if isinstance(td.h_worker, dict):
            groups = sorted(td.h_worker)
            rows = {g: (dd.h_worker[g][0], td.h_worker[g][rank]) for g in groups}
            servers = {g: (dd.h_server[g], td.h_server[g]) for g in groups}
            part = partition_for(opt.policy, t_params)
            exact = {p for g, paths in zip(part.group_names, part.group_paths)
                     if not g.endswith("identity") for p in paths}
        else:
            rows = {"flat": (dd.h_worker[0], td.h_worker[rank])}
            servers = {"flat": (dd.h_server, td.h_server)}
            exact = set(t_params)
            res["dtypes"] = [str(dd.h_worker.dtype), str(td.h_server.dtype)]
        for g in rows:
            res["memories"][g] = [bool(torch.equal(*rows[g])), bool(torch.equal(*servers[g])),
                                  float(servers[g][1].float().abs().sum())]
        for p in t_params:
            a, b = d_params[p].detach(), t_params[p].detach()
            if p in exact:
                res["params"][p] = bool(torch.equal(a, b))
            else:
                res["params"][p] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
        out[name] = res
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fam_dist")
    ctx = mp.start_processes(_rank_main, args=(str(tmp), str(tmp / "store")), nprocs=N,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError("the gloo ranks did not finish in 600 s")
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N)]


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_trainer_equals_in_turn(runs, name):
    for r, summary in enumerate(runs):
        got = summary[name]
        for g, (row, server, mass) in got["memories"].items():
            assert row and server, (r, g)
            assert mass > 0 or g.endswith(("identity", "topk_ef")), (r, g)  # no server memory
        for p, v in got["params"].items():
            if isinstance(v, bool):
                assert v, (r, p)
            else:
                assert v <= 1e-6, (r, p, v)
        for d, t in zip(*got["losses"]):
            assert math.isfinite(d) and math.isclose(d, t, rel_tol=1e-6)
    if name == "nemotron-bf16":
        assert all(s[name]["dtypes"] == ["torch.bfloat16"] * 2 for s in runs)
    else:
        assert sorted(runs[0][name]["memories"]) == [
            "g00_identity", "g01_topk_ef", "g02_natural", "g03_ternary"]
        assert any(not isinstance(v, bool) for v in runs[0][name]["params"].values())
