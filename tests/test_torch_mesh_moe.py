"""The MoE layer over the model axis (``repro_torch/models/moe.py`` under a
model group) against the JAX package's nested fully-manual path
(``repro/models/moe.py:195-241``) and against the port's own single-device
layer.

The JAX side runs ``moe_layer`` inside a ``shard_map`` over ``data`` under
``GSPMDPolicy(mesh, manual=("data",))`` on an Auto-axis ``(2, 2)`` host
mesh (a JAX subprocess with 4 host devices), the experts placed by the JAX
``param_specs``: the layer opens its nested ``shard_map`` over ``model``,
as it does inside the JAX trainer's worker ``shard_map``.  Each worker's
loss is ``sum(out * probe) + aux`` for a numpy-seeded probe, and its
gradients come back per worker.

The port runs the same two workers' rows in turn on two gloo ranks (M = 2),
each holding its shards (``param_specs`` / ``shard_leaf``), and gathers the
experts' gradients whole.  Cases: reduced granite-moe (``ffn`` partition)
and reduced phi3.5-moe (``expert`` partition), each as configured (the
reduced configs never drop), with drops (``capacity_factor`` 1.25) and in
token chunks of 16 (``token_chunk`` dividing T = 64, each chunk recomputed
in the backward).

Tolerance: each array within rtol 1e-5 of its largest entry plus atol 1e-6
(the aux loss elementwise), the single-device layer's bound for the combine order
(``tests/test_torch_moe.py``): the JAX package sums a token's slots in
``segment_sum``'s order and splits the ``ffn`` products over F, the port
adds the slots in choice order.  The router's and the input's gradients
are the ones that catch a misplaced ``copy_to_model`` (a factor of M on a
whole branch, or a branch left partial).  Besides:

* the output, the aux loss and the replicated gradients (input, router)
  are the same bits on both model ranks;
* the collectives tagged ``moe`` are exactly the path's: ``ffn`` all-reduces
  the combined (T, D) forward (never the (E cap, D) slots) and the
  dispatch input and the combine weights backward; ``expert`` all-gathers
  the per-expert outputs forward and all-reduces the dispatch input
  backward;
* a split the JAX nested path does not take (E % M != 0, ``d_ff`` % M !=
  0) is refused, naming ROADMAP.md queue 1 item 12(g).
"""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_round import finish_jax, init_gloo, same_bits, spawn, start_jax

M = 2
B, S, D = 2, 32, 256          # rows per worker, sequence, reduced d_model
T = B * S
RTOL, ATOL = 1e-5, 1e-6
CASES = [
    {"tag": "ffn", "arch": "granite-moe-3b-a800m", "moe": {}, "seed": 1},
    {"tag": "expert", "arch": "phi3.5-moe-42b-a6.6b", "moe": {}, "seed": 2},
    {"tag": "ffn-drops", "arch": "granite-moe-3b-a800m", "moe": {"capacity_factor": 1.25},
     "seed": 29},
    {"tag": "expert-drops", "arch": "phi3.5-moe-42b-a6.6b", "moe": {"capacity_factor": 1.25},
     "seed": 23},
    {"tag": "ffn-chunked", "arch": "granite-moe-3b-a800m", "moe": {"token_chunk": 16},
     "seed": 5},
    {"tag": "expert-chunked", "arch": "phi3.5-moe-42b-a6.6b", "moe": {"token_chunk": 16},
     "seed": 6},
]
LEAVES = ("router", "w_in", "w_gate", "w_out")

JAX_MOE = r"""
import json, sys
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config, reduced
from repro.launch.sharding_rules import param_specs
from repro.models.moe import init_moe, moe_layer
from repro.models.sharding import GSPMDPolicy, sharding_policy

cases, tmp = json.loads(sys.argv[1]), sys.argv[2]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
data = np.load(f"{tmp}/inputs.npz")
out = {}
for case in cases:
    tag = case["tag"]
    base = reduced(get_config(case["arch"]))
    cfg = replace(base, moe=replace(base.moe, **case["moe"]))
    params = init_moe(jax.random.PRNGKey(case["seed"]), cfg, jnp.float32)
    specs = param_specs({"mlp": params}, cfg, mesh)["mlp"]
    placed = {k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in params.items()}

    def body(p, xl, pl):
        with sharding_policy(GSPMDPolicy(mesh, manual=("data",))):
            def f(p, xl):
                y, aux = moe_layer(p, xl, cfg)
                return jnp.sum(y * pl) + aux, (y, aux)
            (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, xl)
        return y, aux[None], gx, {k: v[None] for k, v in gp.items()}

    fn = jax.jit(shard_map(
        body, mesh=mesh, in_specs=({k: P() for k in params}, P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), {k: P("data") for k in params}),
        axis_names={"data"}, check_vma=False))
    y, aux, gx, gp = fn(placed, jnp.asarray(data[f"{tag}/x"]), jnp.asarray(data[f"{tag}/probe"]))
    out[f"{tag}/y"], out[f"{tag}/aux"], out[f"{tag}/gx"] = map(np.asarray, (y, aux, gx))
    for k in params:
        out[f"{tag}/params/{k}"] = np.asarray(params[k])
        out[f"{tag}/grad/{k}"] = np.asarray(gp[k])
np.savez(f"{tmp}/jax.npz", **out)
"""


def _cfg(case):
    from repro_torch.configs import get_config, reduced

    base = reduced(get_config(case["arch"]))
    return replace(base, moe=replace(base.moe, **case["moe"]))


def _layer(params, x, probe, cfg):
    """The layer's output, aux loss and the gradients of ``sum(out * probe)
    + aux`` with respect to the input and the leaves."""
    from repro_torch.models.moe import moe_layer

    x = x.clone().requires_grad_()
    y, aux = moe_layer(params, x, cfg)
    grads = torch.autograd.grad(torch.sum(y * probe) + aux, [x, *params.values()])
    return y.detach(), aux.detach(), grads[0], dict(zip(params, grads[1:]))


def _rank_main(rank, tmp):
    from repro_torch.core import transport
    from repro_torch.launch.sharding_rules import gather_leaf, param_specs, shard_leaf
    from repro_torch.models.sharding import ModelGroup, model_parallel

    tmp = Path(tmp)
    init_gloo(rank, M, str(tmp / "store"))
    mp = ModelGroup(dist.group.WORLD, M, rank)
    inputs, jax_out = np.load(tmp / "inputs.npz"), np.load(tmp / "jax.npz")
    out, stats = {}, {}
    for case in CASES:
        tag, cfg = case["tag"], _cfg(case)
        full = {k: torch.from_numpy(jax_out[f"{tag}/params/{k}"]).requires_grad_()
                for k in LEAVES}
        specs = param_specs({f"mlp/{k}": v for k, v in full.items()}, cfg, M)
        specs = {k: specs[f"mlp/{k}"] for k in LEAVES}
        local = {k: shard_leaf(v.detach(), specs[k], M, rank).requires_grad_()
                 for k, v in full.items()}
        for w in range(2):
            x = torch.from_numpy(inputs[f"{tag}/x"][w * B:(w + 1) * B])
            probe = torch.from_numpy(inputs[f"{tag}/probe"][w * B:(w + 1) * B])
            before = dict(transport.STATS)
            with model_parallel(mp):
                y, aux, gx, gp = _layer(local, x, probe, cfg)
            stats[f"{tag}/{w}"] = {f"{k[0]} {k[1]}": v - before.get(k, 0)
                                   for k, v in transport.STATS.items() if k[0] == "moe"}
            out[f"{tag}/{w}/y"], out[f"{tag}/{w}/aux"] = y.numpy(), aux.numpy()
            out[f"{tag}/{w}/gx"] = gx.numpy()
            for k, g in gp.items():
                out[f"{tag}/{w}/grad/{k}"] = gather_leaf(g, specs[k], mp).numpy()
            if rank == 0:   # the port's single-device layer on the same rows
                y, aux, gx, gp = _layer(full, x, probe, cfg)
                out[f"{tag}/{w}/single/y"], out[f"{tag}/{w}/single/aux"] = y.numpy(), aux.numpy()
                out[f"{tag}/{w}/single/gx"] = gx.numpy()
                for k, g in gp.items():
                    out[f"{tag}/{w}/single/grad/{k}"] = g.numpy()
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(stats))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    rng = np.random.default_rng(11)
    inputs = {}
    for case in CASES:
        inputs[f"{case['tag']}/x"] = rng.standard_normal((2 * B, S, D)).astype(np.float32)
        inputs[f"{case['tag']}/probe"] = rng.standard_normal((2 * B, S, D)).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inputs)
    finish_jax(start_jax(JAX_MOE, [json.dumps(CASES), tmp]))
    spawn(_rank_main, M, (str(tmp),))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(M)]
    stats = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(M)]
    return inputs, dict(np.load(tmp / "jax.npz")), ranks, stats


def _normwise(got, want):
    """Within rtol 1e-5 of the array's largest entry, plus atol 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max() + ATOL, (err, np.abs(want).max())


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_layer_matches_the_jax_nested_path(runs, tag):
    _, jax_out, ranks, _ = runs
    for got in ranks:
        for w in range(2):
            rows = slice(w * B, (w + 1) * B)
            _normwise(got[f"{tag}/{w}/y"], jax_out[f"{tag}/y"][rows])
            _normwise(got[f"{tag}/{w}/gx"], jax_out[f"{tag}/gx"][rows])
            assert np.allclose(got[f"{tag}/{w}/aux"], jax_out[f"{tag}/aux"][w], rtol=RTOL,
                               atol=ATOL)
            for k in LEAVES:
                _normwise(got[f"{tag}/{w}/grad/{k}"], jax_out[f"{tag}/grad/{k}"][w])


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_layer_matches_the_single_device_layer(runs, tag):
    """The sharded layer's output, aux and gathered gradients against the
    port's unsharded layer on the same rows; the replicated values (output,
    aux, the input's and the router's gradients) are the same bits on both
    model ranks."""
    _, _, ranks, _ = runs
    for w in range(2):
        for got in ranks:
            for name in ("y", "gx", *(f"grad/{k}" for k in LEAVES)):
                _normwise(got[f"{tag}/{w}/{name}"], ranks[0][f"{tag}/{w}/single/{name}"])
            assert np.allclose(got[f"{tag}/{w}/aux"], ranks[0][f"{tag}/{w}/single/aux"],
                               rtol=RTOL, atol=ATOL)
        for name in ("y", "aux", "gx", "grad/router"):
            assert same_bits(ranks[0][f"{tag}/{w}/{name}"], ranks[1][f"{tag}/{w}/{name}"]), name


def test_the_cases_drop_and_chunk_as_named(runs):
    """The drop cases drop choices (at T = 64 the reduced routers are near
    uniform, so the seeds are ones whose router drops at cf 1.25), the
    others drop none, and the chunked cases run more than one chunk."""
    from repro_torch.models.moe import route

    inputs, jax_out, _, _ = runs
    for case in CASES:
        cfg, tag = _cfg(case), case["tag"]
        router = torch.from_numpy(jax_out[f"{tag}/params/router"])
        chunk, drops = cfg.moe.token_chunk or T, 0
        for w in range(2):
            x = torch.from_numpy(inputs[f"{tag}/x"][w * B:(w + 1) * B]).reshape(T, D)
            kept = sum(int(route(router, x[i:i + chunk], cfg)[3].sum())
                       for i in range(0, T, chunk))
            drops += T * cfg.moe.top_k - kept
        assert (drops > 0) == tag.endswith("drops"), (tag, drops)
        assert (T // (cfg.moe.token_chunk or T) > 1) == tag.endswith("chunked")


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_moe_collectives_are_the_nested_paths(runs, tag):
    """Per worker and rank, per chunk: ``ffn`` all-reduces the combined (T,
    D) forward, and the dispatch input (T, D) and the combine weights (T, k)
    backward; ``expert`` all-gathers the (E, cap, D) outputs forward and
    all-reduces the dispatch input backward.  A chunk's all-gather runs
    again in its backward's recompute; its all-reduce does not (the
    checkpoint stops recomputing once it has what the backward saved, and
    the backward of the all-reduce saves nothing)."""
    cfg = _cfg(next(c for c in CASES if c["tag"] == tag))
    mc, f32 = cfg.moe, 4
    chunk = mc.token_chunk or T
    nc = T // chunk
    forwards = nc * (2 if nc > 1 else 1)
    cap = max(1, int(mc.capacity_factor * chunk * mc.top_k / mc.n_experts))
    if mc.partition == "ffn":
        calls = 3 * nc
        nbytes = nc * (2 * chunk * D + chunk * mc.top_k) * f32
    else:
        calls = forwards + nc
        nbytes = (forwards * mc.n_experts * cap * D + nc * chunk * D) * f32
    _, _, _, stats = runs
    for rank_stats in stats:
        for w in range(2):
            assert rank_stats[f"{tag}/{w}"] == {"moe calls": calls, "moe bytes": nbytes}, (tag, w)


@pytest.mark.parametrize("arch,moe", [("phi3.5-moe-42b-a6.6b", {"n_experts": 3}),
                                      ("granite-moe-3b-a800m", {"d_ff": 129})],
                         ids=["expert-undivided", "ffn-undivided"])
def test_undivided_splits_are_refused(arch, moe):
    """E % M != 0 (``expert``) or ``d_ff`` % M != 0 (``ffn``): the JAX
    package's pure GSPMD fallback, which has no port (12(g)).  The trainer's
    gate refuses it, naming the item; the layer, handed the shards that the
    rules' divisibility fallback leaves, asserts before any collective."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.sharding_rules import param_specs, shard_leaf
    from repro_torch.models.moe import moe_layer
    from repro_torch.models.sharding import ModelGroup, model_parallel
    from repro_torch.models.transformer import init_model

    cfg = _cfg({"arch": arch, "moe": moe})
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item 12\(g\)"):
        train.check_model_axis(cfg, train.make_optimizer(cfg), parse_mesh("2x2"))
    params = init_model(cfg, "cpu", seed=0)
    mlp = {k: params[f"blocks/layer0/mlp/{k}"][0] for k in LEAVES}
    specs = param_specs({f"mlp/{k}": v for k, v in mlp.items()}, cfg, M)
    local = {k: shard_leaf(v, specs[f"mlp/{k}"], M, 0) for k, v in mlp.items()}
    with model_parallel(ModelGroup(None, M, 0)):
        with pytest.raises(AssertionError, match="an undivided MoE split"):
            moe_layer(local, torch.zeros(1, 4, cfg.d_model), cfg)
