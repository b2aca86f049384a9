"""The checkpoint on a ``(2, 2)`` mesh (4 gloo ranks of CPU processes, 2
workers x 2 model shards, reduced llama3.2-1b from the JAX trainer's
initial weights, batch 4 x 32):

* the CLI's ``--checkpoint-dir`` after one ``none`` step (``--inner
  sgd``) gathers the shards into the global arrays and writes the JAX
  trainer's checkpoint of the same mesh, weights and step (the JAX package's
  ``build_train_step`` on an Auto-axis ``(2, 2)`` host mesh, its CLI's
  ``save_checkpoint(dir, steps, {"params": params}, metadata={"policy":
  ...})``): the same step, file, keys and dtypes, the same policy document
  (the JAX-only ``worker_axes`` aside), and the values within rtol 1e-5 /
  atol 1e-6 (the gradients differ in the order of the tensor-parallel sums);
* a ``diana`` run saved after one step through ``gather_train_state``
  (parameters, momentum and the memories in the JAX trainer's global
  layout: ``h_worker`` ``(2, d)``, ``h_server`` ``(d,)``), restored and
  sharded back (``shard_train_state``), continues bitwise its uninterrupted
  second step on every rank.
"""

import contextlib
import io
import json
import os
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_round import finish_jax, init_gloo, spawn, start_jax
from test_torch_mesh_train import (ATOL, BATCH, JAX_TRAIN, LR, RTOL, SEQ, batches, init_tree,
                                   jax_train_spec, run_steps)

N, M = 2, 2
JAX_RUNS = [{"tag": "none", "method": "none", "inner": "sgd", "bucketed": False, "save": True}]


def _rank_main(rank, tmp):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import (gather_train_state, params_from_jax, params_shard_from_jax,
                                     shard_train_state)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import mesh_groups, parse_mesh

    tmp = Path(tmp)
    init_gloo(rank, N * M, str(tmp / "store"))
    mesh = parse_mesh(f"{N}x{M}")
    groups = mesh_groups(mesh)
    data = np.load(tmp / "jax_train.npz")
    cfg = replace(reduced(get_config("llama3.2-1b")), compression="diana", comp_bucketed=False)
    opt = train.make_optimizer(cfg, lr=LR)
    step_fn = train.build_distributed_step(cfg, opt, mesh=mesh)
    bs = batches(cfg, data, 1) * 2    # the same batch twice
    fresh = lambda: params_shard_from_jax(init_tree(data), cfg, "cpu", M, groups.shard)  # noqa
    p0 = fresh()
    _, whole_p, whole_s = run_steps(cfg, opt, step_fn, p0, opt.init(p0, 1), bs)
    p1 = fresh()
    _, p1, s1 = run_steps(cfg, opt, step_fn, p1, opt.init(p1, 1), bs[:1])
    gp, gs = gather_train_state(p1, s1, cfg, mesh, groups)
    shapes = {p: [list(gs.diana.h_worker[p].shape), list(gs.diana.h_server[p].shape)]
              for p in gs.diana.h_worker}
    ck = str(tmp / "resume")
    if rank == 0:
        save_checkpoint(ck, 1, {"params": gp, "opt_state": gs})
    dist.barrier()
    zeros = lambda t: {p: torch.zeros_like(v) for p, v in t.items()}  # noqa: E731
    template = {"params": zeros(gp), "opt_state": gs._replace(
        step=0, inner=zeros(gs.inner),
        diana=gs.diana._replace(h_worker=zeros(gs.diana.h_worker),
                                h_server=zeros(gs.diana.h_server)))}
    tree, step = restore_checkpoint(ck, template)
    rp, rs = shard_train_state(tree["params"], tree["opt_state"], cfg, mesh, groups.worker,
                               groups.shard)
    from repro_torch.core import prng

    rp, rs, _ = step_fn(rp, rs, bs[1], prng.fold_in(prng.PRNGKey(0), 1))
    same = (step == 1 and rs.step == whole_s.step
            and all(torch.equal(rp[p], whole_p[p]) for p in whole_p)
            and all(torch.equal(rs.inner[p], whole_s.inner[p]) for p in whole_p)
            and all(torch.equal(rs.diana.h_worker[p], whole_s.diana.h_worker[p])
                    and torch.equal(rs.diana.h_server[p], whole_s.diana.h_server[p])
                    for p in whole_p))
    summary = {"resume_bitwise": bool(same), "h_shapes": shapes,
               "h_live": bool(any(v.any() for v in rs.diana.h_worker.values()))}

    # the CLI: one none step from the JAX trainer's initial weights
    full = params_from_jax(init_tree(data), cfg, "cpu")
    train.init_model = lambda cfg, device, seed=0: {p: torch.nn.Parameter(v.detach().clone())
                                                    for p, v in full.items()}
    os.environ["WORLD_SIZE"] = str(N * M)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x2",
                    "--compression", "none", "--inner", "sgd", "--steps", "1", "--batch",
                    str(BATCH), "--seq", str(SEQ), "--checkpoint-dir", str(tmp / "port_ckpt")])
    summary["cli"] = buf.getvalue()
    (tmp / f"rank{rank}.json").write_text(json.dumps(summary))
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    finish_jax(start_jax(JAX_TRAIN, [json.dumps(jax_train_spec(JAX_RUNS, steps=1)), tmp]))
    spawn(_rank_main, N * M, (str(tmp),))
    return tmp, [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N * M)]


def test_cli_checkpoint_is_the_jax_trainers(runs):
    from repro_torch.checkpoint import restore_checkpoint

    tmp, summaries = runs
    assert f"checkpoint written to {tmp / 'port_ckpt'}" in summaries[0]["cli"]
    mine = json.loads((tmp / "port_ckpt" / "manifest.json").read_text())
    theirs = json.loads((tmp / "jax_ckpt_none" / "manifest.json").read_text())
    theirs["metadata"]["policy"].pop("worker_axes")
    assert mine == theirs
    data = np.load(tmp / "jax_train.npz")
    template = {"params": {k[len("init/"):]: torch.zeros(data[k].shape) for k in data.files
                           if k.startswith("init/")}}
    got, _ = restore_checkpoint(str(tmp / "port_ckpt"), template)
    want = dict(np.load(tmp / "jax_ckpt_none" / theirs["file"]))
    assert sorted(want) == sorted(f"params/{p}" for p in got["params"])
    for p, v in got["params"].items():
        w = want[f"params/{p}"].astype(np.float64)
        assert np.all(np.abs(v.numpy() - w) <= ATOL + RTOL * np.abs(w)), p


def test_gathered_state_restores_and_continues_bitwise(runs):
    """The restored, re-sharded state's next step is bitwise the
    uninterrupted run's on every rank; the memories were gathered whole
    (``h_worker`` one row per worker, live after a ``diana`` step)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import param_shapes

    _, summaries = runs
    sizes = {p: int(np.prod(s)) for p, s in param_shapes(reduced(get_config("llama3.2-1b")))
             .items()}
    for s in summaries:
        assert s["resume_bitwise"] and s["h_live"]
        assert s["h_shapes"] == {p: [[N, d], [d]] for p, d in sizes.items()}
