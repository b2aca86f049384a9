"""Mamba-2 over the model axis: reduced mamba2-130m's ``--mesh 2x2`` trainer
against the JAX package's ``build_train_step`` on an Auto-axis ``(2, 2)``
host mesh, and the mixer on a model group of 2 gloo ranks against the port's
own single-device mixer.

Each rank holds the JAX shards of the split leaves: ``in_proj`` (256, 1104)
in two contiguous halves of its packed ``[z, x, B, C, dt]`` columns (552
each: rank 0 holds ``z`` and the first 40 of ``x``), ``conv_w`` (4, 576) in
two halves of its ``[x, B, C]`` channels, ``out_proj`` (512, 256) by rows;
``A_log``, ``D``, ``dt_bias``, ``conv_b`` and ``norm_scale`` whole.  The
mixer gathers the three whole (``gather_from_model``, tagged ``mamba``) and runs
replicated.

The trainer, with ``tests/test_torch_mesh_families.py``'s JAX script and
checks on batch 4 x 64 (the reduced SSD chunk is 64), per leaf, lr 3e-4:

* every rank's initial shards are the bits of the JAX trainer's shards on
  its devices;
* ``none`` with ``sgd``, 2 steps: the losses, ``ghat_norm`` and every
  parameter shard within the Mamba-2 archs' bound against the JAX package
  (``SSM_NORMWISE`` = 1e-4 of the array's largest entry plus atol 1e-6,
  ``tests/test_torch_model_families.py``: the port forms the SSD's prefix
  sums in float64, the JAX package in f32);
* ``diana`` with momentum, 2 steps: each round bitwise the JAX nested round
  fed the port's gradient shards, the losses within ``SSM_NORMWISE``, the
  parameters within ``tests/test_torch_mesh_train.py``'s flip bound (its
  share of flipped coordinates scaled by ``SSM_NORMWISE`` / 1e-5,
  ``SSM_FLIPS``);
* ``gather_train_state`` -> ``shard_train_state`` bitwise;
* the CLI (``--arch mamba2-130m --reduced --device cpu --mesh 2x2
  --compression none --inner sgd``) logs the JAX trainer's losses.

The mixer on 2 gloo ranks (f32, bf16 weights and compute, and under a
checkpoint, whose recompute gathers again): the output, the input's gradient
and every leaf's gradient (the split ones gathered) bitwise the unsharded
mixer's, and the ``mamba`` collectives exactly three all-gathers of the whole
leaves per forward.
"""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_families import (check_diana_flip_bound, check_diana_rounds,
                                      check_jax_shards, check_none_sgd, check_round_trip,
                                      SSM_FLIPS, run_families, ssm_close)
from test_torch_mesh_round import init_gloo, same_bits, spawn

ARCH = "mamba2-130m"
SEQ = 64
M = 2
LAYER_CASES = {"f32": {}, "bf16": {"dtype": "bfloat16"}, "checkpoint": {"remat": True}}
LEAVES = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_scale", "out_proj")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(tmp_path_factory.mktemp("mesh_mamba"), (ARCH,), ARCH, seq=SEQ)


def test_initial_shards_are_the_jax_shards(runs):
    check_jax_shards(runs, ARCH)


def test_none_sgd_matches_the_jax_trainer(runs):
    check_none_sgd(runs, ARCH, close=ssm_close)


def test_diana_rounds_bitwise_the_jax_round_on_the_ports_gradients(runs):
    check_diana_rounds(runs, ARCH)


def test_diana_losses_and_parameters_within_the_flip_bound(runs):
    check_diana_flip_bound(runs, ARCH, close=ssm_close, flips=SSM_FLIPS)


def test_gathered_state_shards_back_bitwise(runs):
    check_round_trip(runs, ARCH)


def test_cli_mesh_2x2_matches_the_jax_trainer(runs):
    jax_out, _, _, summaries = runs
    lines = [ln for ln in summaries[0]["cli"].splitlines() if ln.startswith("step")]
    assert len(lines) == 2
    for s, ln in enumerate(lines):
        assert ssm_close(float(ln.split()[3]), jax_out[f"{ARCH}/none/loss/{s}"]), ln
    assert all(s["cli"] == "" for s in summaries[1:])


def test_split_leaves_cut_across_the_packed_components():
    """The shard boundaries of the reduced mixer fall inside ``x``, as the
    JAX rules place them: nothing in the port splits by component."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.sharding_rules import param_specs
    from repro_torch.models.mamba2 import SPLIT, dims, mamba_shapes

    cfg = reduced(get_config(ARCH))
    _, d_in, h, _, n, g = dims(cfg)
    shapes = {f"mixer/{k}": s for k, (s, _) in mamba_shapes(cfg).items()}
    specs = param_specs(shapes, cfg, M)
    assert {k: specs[f"mixer/{k}"] for k in SPLIT} == SPLIT
    assert all(specs[f"mixer/{k}"] is None for k in LEAVES if k not in SPLIT)
    half = shapes["mixer/in_proj"][1] // M
    assert (shapes["mixer/in_proj"][1], half) == (2 * d_in + 2 * g * n + h, 552)
    assert d_in < half < 2 * d_in                  # rank 0: z and the start of x
    assert d_in // 2 < shapes["mixer/conv_w"][1] // M < d_in


def _layer_inputs():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.mamba2 import mamba_shapes

    rng = np.random.default_rng(29)
    cfg = reduced(get_config(ARCH))
    params = {}
    for k, (shape, _) in mamba_shapes(cfg).items():
        params[k] = (rng.standard_normal(shape) * (0.5 if k != "A_log" else 1.0)).astype(
            np.float32)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    probe = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    return params, x, probe


def _mixer(params, x, probe, cfg, remat):
    """The mixer's output and the gradients of ``sum(out * probe)`` with
    respect to the input and every leaf."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.mamba2 import mamba_layer

    x = x.clone().requires_grad_()
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    y = (checkpoint(mamba_layer, leaves, x, cfg, use_reentrant=False) if remat
         else mamba_layer(leaves, x, cfg))
    grads = torch.autograd.grad(torch.sum(y.float() * probe), [x, *leaves.values()])
    return y.detach(), grads[0], dict(zip(leaves, grads[1:]))


def _layer_rank(rank, tmp):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import transport
    from repro_torch.launch.sharding_rules import gather_leaf, param_specs, shard_leaf
    from repro_torch.models.sharding import ModelGroup, model_parallel

    tmp = Path(tmp)
    init_gloo(rank, M, str(tmp / "store"))
    mp = ModelGroup(dist.group.WORLD, M, rank)
    out, stats = {}, {}
    for tag, case in LAYER_CASES.items():
        dt = getattr(torch, case.get("dtype", "float32"))
        cfg = replace(reduced(get_config(ARCH)), param_dtype=dt, compute_dtype=dt)
        params, x, probe = _layer_inputs()
        full = {k: torch.from_numpy(v).to(torch.float32 if k in ("dt_bias", "A_log", "D")
                                          else dt) for k, v in params.items()}
        x, probe = torch.from_numpy(x).to(dt), torch.from_numpy(probe)
        specs = param_specs({f"mixer/{k}": v for k, v in full.items()}, cfg, M)
        specs = {k: specs[f"mixer/{k}"] for k in full}
        local = {k: shard_leaf(v, specs[k], M, rank) for k, v in full.items()}
        before = dict(transport.STATS)
        with model_parallel(mp):
            y, gx, gp = _mixer(local, x, probe, cfg, case.get("remat", False))
        stats[tag] = {f"{k[0]} {k[1]}": v - before.get(k, 0)
                      for k, v in transport.STATS.items() if k[0] == "mamba"}
        stats[f"{tag}/whole_bytes"] = sum(full[k].numel() * full[k].element_size()
                                          for k, s in specs.items() if s is not None)
        y1, gx1, gp1 = _mixer(full, x, probe, cfg, case.get("remat", False))
        out[f"{tag}/y"], out[f"{tag}/single/y"] = y.float().numpy(), y1.float().numpy()
        out[f"{tag}/gx"], out[f"{tag}/single/gx"] = gx.float().numpy(), gx1.float().numpy()
        for k in full:
            out[f"{tag}/grad/{k}"] = gather_leaf(gp[k], specs[k], mp).float().numpy()
            out[f"{tag}/single/grad/{k}"] = gp1[k].float().numpy()
            out[f"{tag}/local/grad/{k}"] = gp[k].float().numpy()
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(stats))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_mamba_layer")
    spawn(_layer_rank, M, (str(tmp),))
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(M)],
            [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(M)])


@pytest.mark.parametrize("tag", LAYER_CASES)
def test_mixer_on_a_model_group_is_bitwise_the_unsharded_mixer(layer_runs, tag):
    """On each rank: the output, the input's gradient and every leaf's
    gradient (the split leaves' shards gathered) are the unsharded mixer's
    bits; a split leaf's shard gradient is the rank's slice of the whole."""
    ranks, _ = layer_runs
    for got in ranks:
        for name in ("y", "gx", *(f"grad/{k}" for k in LEAVES)):
            assert same_bits(got[f"{tag}/{name}"], got[f"{tag}/single/{name}"]), (tag, name)
    for k in LEAVES:
        parts = [r[f"{tag}/local/grad/{k}"] for r in ranks]
        whole = ranks[0][f"{tag}/single/grad/{k}"]
        if parts[0].shape != whole.shape:
            dim = next(i for i, (a, b) in enumerate(zip(parts[0].shape, whole.shape)) if a != b)
            assert same_bits(np.concatenate(parts, axis=dim), whole), k


@pytest.mark.parametrize("tag", LAYER_CASES)
def test_mamba_collectives_gather_the_whole_leaves(layer_runs, tag):
    """Three all-gathers per forward, of the whole ``in_proj``, ``conv_w``
    and ``out_proj`` (their bytes in the parameter dtype), none backward;
    under a checkpoint the recompute gathers them again."""
    _, stats = layer_runs
    forwards = 2 if LAYER_CASES[tag].get("remat") else 1
    for s in stats:
        assert s[tag] == {"mamba calls": 3 * forwards,
                          "mamba bytes": forwards * s[f"{tag}/whole_bytes"]}, s[tag]


def test_mamba_meshes_that_do_not_divide_are_refused_others_taken():
    """``--mesh 1x3`` on the reduced mamba2: 3 divides ``in_proj``'s 1104
    columns and ``conv_w``'s 576 channels but not ``out_proj``'s 512 rows,
    and the JAX fallback replicates such a leaf (12(g)); with no attention
    the heads do not matter (a model axis of 4 divides every leaf of the
    reduced mamba2 but not its 2 KV heads).  ``--mesh 2x2`` is accepted,
    full and reduced."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    from repro_torch.launch.mesh import parse_mesh

    cfg = reduced(get_config(ARCH))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item 12\(g\)"):
        train.check_model_axis(cfg, train.make_optimizer(cfg), parse_mesh("1x3"))
    for c in (cfg, get_config(ARCH)):
        train.check_model_axis(c, train.make_optimizer(c), parse_mesh("2x2"))
    assert cfg.n_kv_heads % 4
    train.check_model_axis(cfg, train.make_optimizer(cfg), parse_mesh("1x4"))
