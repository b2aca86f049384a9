"""The tensor-parallel model on (1, 2) and (2, 2) gloo worlds of CPU
processes against the JAX package's GSPMD ``value_and_grad(train_loss)``
on an Auto-axis ``(1, 2)`` host mesh, the parameters placed by the JAX
``param_specs`` and traced under ``GSPMDPolicy`` (a JAX subprocess with 4
host devices), for the four reduced dense archs (llama3.2-1b, granite-8b,
nemotron-4-15b, stablelm-3b) from the JAX package's weights.

Each rank loads its shards (``params_shard_from_jax``) and runs
``train_loss`` and its backward under its worker's model group: worker
``w`` takes rows ``[2w, 2w + 2)`` of a 4-row batch, and the (1, 2) world
the first two.  The worker's loss and each gradient shard agree with the
JAX loss and the shard of its global gradient within rtol 1e-5 / atol
1e-6 (the products and reductions sum in other orders); llama runs 1,025
positions, so its cross-entropy takes two ``CE_SEQ_CHUNK`` chunks.  The
replicated leaves' gradients (the norms) are the same bits on both ranks
of a worker: every replicated value comes out of an all-reduce.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_round import finish_jax, init_gloo, same_bits, shard_of, spawn, start_jax

ARCHS = ("llama3.2-1b", "granite-8b", "nemotron-4-15b", "stablelm-3b")
SEQ = {"llama3.2-1b": 1025}
ROWS = 2          # per worker
RTOL, ATOL = 1e-5, 1e-6

JAX_MODEL = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config, reduced
from repro.launch.sharding_rules import param_specs
from repro.models import init_model, train_loss
from repro.models.sharding import GSPMDPolicy, sharding_policy

archs, tmp = json.loads(sys.argv[1]), sys.argv[2]
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


out = {}
for arch in archs:
    cfg = reduced(get_config(arch))
    params = init_model(cfg, jax.random.PRNGKey(3))
    specs = param_specs(params, cfg, mesh)
    placed = jax.tree_util.tree_map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                                    params, specs)
    tokens = np.load(f"{tmp}/tokens_{arch}.npy")
    with sharding_policy(GSPMDPolicy(mesh)):
        f = jax.jit(jax.value_and_grad(lambda p, b: train_loss(p, b, cfg)))
        for w in range(tokens.shape[0] // 2):
            loss, grads = f(placed, {"tokens": jnp.asarray(tokens[2 * w:2 * w + 2])})
            out[f"{arch}/{w}/loss"] = np.asarray(loss)
            for p, g in flat(grads).items():
                out[f"{arch}/{w}/grad/{p}"] = np.asarray(g)
    for p, a in flat(params).items():
        out[f"params/{arch}/{p}"] = np.asarray(a)
np.savez(f"{tmp}/jax.npz", **out)
"""


def _rank_main(rank, tmp, world):
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_shard_from_jax
    from repro_torch.launch.mesh import mesh_groups, parse_mesh
    from repro_torch.models.sharding import model_parallel
    from repro_torch.models.transformer import train_loss

    tmp = Path(tmp)
    init_gloo(rank, world, str(tmp / f"store{world}"))
    groups = mesh_groups(parse_mesh(f"{world // 2}x2"))
    data = np.load(tmp / "jax.npz")
    out = {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        tree = {k[len(f"params/{arch}/"):]: data[k] for k in data.files
                if k.startswith(f"params/{arch}/")}
        params = params_shard_from_jax(tree, cfg, "cpu", 2, groups.shard)
        tokens = np.load(tmp / f"tokens_{arch}.npy")
        w = groups.worker
        batch = {"tokens": torch.from_numpy(tokens[ROWS * w:ROWS * (w + 1)])}
        with model_parallel(groups.model):
            loss = train_loss(params, batch, cfg)
            grads = torch.autograd.grad(loss, list(params.values()))
        out[f"{arch}/loss"] = loss.detach().numpy()
        for p, g in zip(params, grads):
            out[f"{arch}/grad/{p}"] = g.numpy()
    np.savez(tmp / f"w{world}_rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_model")
    rng = np.random.default_rng(9)
    for arch in ARCHS:
        np.save(tmp / f"tokens_{arch}.npy",
                rng.integers(0, 512, (2 * ROWS, SEQ.get(arch, 65))).astype(np.int32))
    finish_jax(start_jax(JAX_MODEL, [json.dumps(ARCHS), tmp]))
    for world in (2, 4):
        spawn(_rank_main, world, (str(tmp), world))
    ranks = {world: [dict(np.load(tmp / f"w{world}_rank{r}.npz")) for r in range(world)]
             for world in (2, 4)}
    return dict(np.load(tmp / "jax.npz")), ranks


def _close(a, b):
    return np.all(np.abs(a.astype(np.float64) - b) <= ATOL + RTOL * np.abs(b.astype(np.float64)))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_loss_and_grads_match_gspmd(runs, arch, world):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.sharding_rules import param_specs
    from repro_torch.models.transformer import param_shapes

    jax_out, ranks = runs
    cfg = reduced(get_config(arch))
    specs = param_specs(param_shapes(cfg), cfg, 2)
    assert sum(s is not None for s in specs.values()) > len(specs) // 2
    for rank, got in enumerate(ranks[world]):
        w, m = divmod(rank, 2)
        assert _close(got[f"{arch}/loss"], jax_out[f"{arch}/{w}/loss"]), (rank, arch)
        for p, dim in specs.items():
            want = shard_of(jax_out[f"{arch}/{w}/grad/{p}"], dim, m)
            assert _close(got[f"{arch}/grad/{p}"], want), (rank, p)


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_leaf_grads_bitwise_across_model_ranks(runs, world):
    """The norm scales' gradients (and the loss) are the same bits on both
    model ranks of each worker."""
    _, ranks = runs
    for w in range(world // 2):
        a, b = ranks[world][2 * w], ranks[world][2 * w + 1]
        for arch in ARCHS:
            reps = [k for k in a if k.startswith(f"{arch}/grad/") and k.endswith("scale")]
            assert len(reps) >= 3
            for k in reps + [f"{arch}/loss"]:
                assert same_bits(a[k], b[k]), k
