"""The MoE family served over a ``(2, 2)`` mesh against the JAX GSPMD serve
step (``tests/test_torch_serve_mesh.py``'s JAX script, ranks and checks):
reduced granite-moe-3b-a800m (the ``ffn`` partition) and
phi3.5-moe-42b-a6.6b (the ``expert`` partition), four teacher-forced steps
at batch 4 (each data rank its 2 rows) and at batch 1 (each its 8 rows of
the 16-row KV cache).

The JAX serve step runs no manual axis, so its MoE takes the pure GSPMD
path over the *global* batch: the capacity of the global tokens, the
positions in global token order.  ``granite-drops`` (``capacity_factor``
1.0, batch 4) is a decode whose global capacity, max(1, int(1.0 * 4 * 2 /
4)) = 2 per expert, drops choices; its logits are held to the JAX step's,
and the kept choices, summed over the data ranks, are the single-device
decode's, step by step.

The layer alone on the 4 ranks (``granite`` and ``phi3.5`` reduced,
``capacity_factor`` 1.0, 8 tokens, seed 31): under the data group
(``split="batch"``) each rank's keep mask is its rows of the single-device
layer's, which drops choices, and its output within ``RTOL`` normwise of
those rows; a rank's own dispatch (its 4 tokens alone, the training path)
keeps another set.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_serve_mesh import (RTOL, WORLD, cfg_of, check_caches, check_logits, run_cases,
                                   serve_case, wait_for)
from test_torch_mesh_round import init_gloo

CASES = [
    {"tag": "granite-rows", "arch": "granite-moe-3b-a800m", "kind": "decode", "batch": 4,
     "len": 16, "name": "decode", "steps": 4, "seed": 21},
    {"tag": "granite-seq", "arch": "granite-moe-3b-a800m", "kind": "decode", "batch": 1,
     "len": 16, "name": "decode", "steps": 4, "seed": 22},
    {"tag": "phi-rows", "arch": "phi3.5-moe-42b-a6.6b", "kind": "decode", "batch": 4,
     "len": 16, "name": "decode", "steps": 4, "seed": 23},
    {"tag": "phi-seq", "arch": "phi3.5-moe-42b-a6.6b", "kind": "decode", "batch": 1,
     "len": 16, "name": "decode", "steps": 4, "seed": 24},
    {"tag": "granite-drops", "arch": "granite-moe-3b-a800m", "kind": "decode", "batch": 4,
     "len": 16, "name": "decode", "steps": 4, "seed": 25, "over": {"cf": 1.0}},
]
LAYER_ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
LAYER_TOKENS, LAYER_SEED = 8, 31


class RouteSpy:
    """Records each ``moe.route`` call's keep mask while in use."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.keeps = moe, moe.route, []

    def __enter__(self):
        def spy(*a, **kw):
            out = self.route(*a, **kw)
            self.keeps.append(out[3].clone().numpy())
            return out

        self.moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def layer_inputs(arch):
    cfg = cfg_of({"arch": arch, "over": {"cf": 1.0}})
    mc, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(LAYER_SEED)
    p = {"router": rng.standard_normal((d, mc.n_experts)) / np.sqrt(d),
         "w_in": rng.standard_normal((mc.n_experts, d, mc.d_ff)) / np.sqrt(d),
         "w_gate": rng.standard_normal((mc.n_experts, d, mc.d_ff)) / np.sqrt(d),
         "w_out": rng.standard_normal((mc.n_experts, mc.d_ff, d)) / np.sqrt(mc.d_ff)}
    x = rng.standard_normal((LAYER_TOKENS, 1, d))
    return cfg, {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}, \
        torch.from_numpy(x.astype(np.float32))


def layer_check(rank, out):
    """The MoE layer on this rank's rows under the data group, whole on one
    device, and a rank's own dispatch."""
    from repro_torch.launch.mesh import mesh_groups, parse_mesh
    from repro_torch.launch.sharding_rules import param_specs, shard_tree
    from repro_torch.models.moe import moe_layer
    from repro_torch.models.sharding import DataGroup, data_parallel, model_parallel

    mesh = parse_mesh("2x2")
    groups = mesh_groups(mesh)
    for arch in LAYER_ARCHS:
        cfg, p, x = layer_inputs(arch)
        specs = param_specs({f"mlp/{k}": v for k, v in p.items()}, cfg, mesh.model)
        mine = {k[4:]: v for k, v in shard_tree({f"mlp/{k}": v for k, v in p.items()}, specs,
                                                mesh.model, groups.shard).items()}
        rows = x.chunk(2, dim=0)[groups.worker]
        dg = DataGroup(groups.data, 2, groups.worker, "batch")
        with torch.inference_mode():
            with RouteSpy() as spy:
                whole, _ = moe_layer(p, x, cfg)
            out[f"{arch}/whole"], out[f"{arch}/whole_keep"] = whole.numpy(), spy.keeps[0]
            with RouteSpy() as spy, model_parallel(groups.model), data_parallel(dg):
                served, _ = moe_layer(mine, rows, cfg)
            out[f"{arch}/served"], out[f"{arch}/served_keep"] = served.numpy(), spy.keeps[0]
            with RouteSpy() as spy, model_parallel(groups.model):
                moe_layer(mine, rows, cfg)
            out[f"{arch}/own_keep"] = spy.keeps[0]


def _rank_main(rank, tmp, cases):
    tmp = Path(tmp)
    init_gloo(rank, WORLD, str(tmp / "store"))
    from repro_torch.launch.mesh import parse_mesh

    mesh = parse_mesh("2x2")
    wait_for(tmp / "init.npz")
    data = np.load(tmp / "init.npz")
    out, summary = {}, {}
    for c in cases:
        with RouteSpy() as spy:
            serve_case(c, data, mesh, rank, out, summary)
        summary[f"{c['tag']}/kept"] = [int(k.sum()) for k in spy.keeps]
        summary[f"{c['tag']}/dropped"] = [int((~k).sum()) for k in spy.keeps]
    layer_check(rank, out)
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(summary))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("serve_mesh_moe"), CASES, _rank_main)


@pytest.mark.parametrize("case", CASES, ids=[c["tag"] for c in CASES])
def test_decode_logits_match_the_jax_serve_step(runs, case):
    jax_out, _, ranks, summaries = runs
    check_logits(case, jax_out, ranks, summaries)


@pytest.mark.parametrize("case", CASES, ids=[c["tag"] for c in CASES])
def test_each_ranks_caches_are_its_shard_of_the_jax_caches(runs, case):
    jax_out, init, ranks, _ = runs
    check_caches(case, jax_out, init, ranks)


@pytest.fixture(scope="module")
def single_device_keeps(runs):
    from repro_torch.configs import ShapeConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.serve import build_serve_step, init_serve_caches

    from test_torch_serve_mesh import nest

    _, init, _, _ = runs
    c = next(c for c in CASES if c["tag"] == "granite-drops")
    cfg = cfg_of(c)
    pre = f"{c['tag']}/params/"
    params = params_from_jax(nest({k[len(pre):]: init[k] for k in init.files
                                   if k.startswith(pre)}), cfg, "cpu")
    shape = ShapeConfig(c["name"], c["len"], c["batch"], "decode")
    caches, step = init_serve_caches(cfg, shape), build_serve_step(cfg, shape)
    toks = torch.from_numpy(init[f"{c['tag']}/tokens"]).long()
    with RouteSpy() as spy:
        for i in range(c["steps"]):
            _, caches = step(params, caches, toks[:, i:i + 1])
    return spy.keeps


def test_the_drop_case_keeps_the_global_choices(runs, single_device_keeps):
    """The drop case's kept choices: each step's, summed over the two data
    ranks (on each model shard), equal the single-device decode's of the
    same weights and tokens, and some are dropped."""
    _, _, _, summaries = runs
    want = [int(k.sum()) for k in single_device_keeps]
    assert sum(int((~k).sum()) for k in single_device_keeps) > 0   # the capacity drops
    for shard in range(2):
        kept = [summaries[w * 2 + shard]["granite-drops/kept"] for w in range(2)]
        assert [a + b for a, b in zip(*kept)] == want


@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_layer_keeps_the_global_choices_not_its_own(runs, arch):
    _, _, ranks, _ = runs
    for r in range(WORLD):
        whole_keep = ranks[r][f"{arch}/whole_keep"]
        mine = np.split(whole_keep, 2, axis=0)[r // 2]
        assert not whole_keep.all()                                 # global drops
        assert np.array_equal(ranks[r][f"{arch}/served_keep"], mine)
        whole = ranks[r][f"{arch}/whole"]
        rows = np.split(whole, 2, axis=0)[r // 2]
        err = np.abs(ranks[r][f"{arch}/served"] - rows).max()
        assert err <= RTOL * np.abs(whole).max(), err
    # a rank's own dispatch keeps a different set on some data rank
    assert any(not np.array_equal(ranks[r][f"{arch}/own_keep"],
                                  np.split(ranks[r][f"{arch}/whole_keep"], 2, axis=0)[r // 2])
               for r in range(WORLD))


def test_serve_moe_gathers_only_where_the_rows_split(runs):
    _, _, _, summaries = runs
    for c in CASES:
        cfg = cfg_of(c)
        layers = sum(s.mlp == "moe" for s in cfg.pattern) * cfg.n_blocks
        for s in summaries:
            split = s[f"{c['tag']}/split"]
            assert split == ("batch" if c["batch"] == 4 else "seq")
            assert s[f"{c['tag']}/steps"].get("serve_moe", 0) == (
                layers * c["steps"] if split == "batch" else 0)
