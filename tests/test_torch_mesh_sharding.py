"""The model axis's rules and gates against the JAX package, in this
process (no ranks but a one-rank gloo group for the round's refusals):

* ``param_specs`` against ``repro.launch.sharding_rules.param_specs`` for
  the ten archs, full and reduced (``jax.eval_shape`` of the JAX
  ``init_model``), on ``(data, model)`` meshes with model axes of 1, 2, 3,
  4, 16 and 32: the port's split dimension is the index of ``"model"`` in
  the JAX ``PartitionSpec`` (no FSDP axes, so nothing else appears), the
  divisibility fallback included; ``h_flat_specs`` and ``batch_specs`` the
  same way;
* ``parse_mesh`` against the JAX CLI's own ``--mesh`` handling
  (``repro.launch.train.main`` run until it builds its mesh and its state):
  the axes and sizes of 1-, 2- and 3-dim meshes, ``(node, data, model)``
  under ``--topology hierarchical`` and the node size the JAX CLI infers;
* ``resolve_bucketed``'s one structured warning and ``resolved_layout``;
* the refusals (``NotImplementedError`` naming ROADMAP.md queue 1 item 12)
  of everything the slices do not hold to the JAX trainer on a model mesh,
  and the MoE, frontend, Mamba-2 and hybrid archs accepted (full and
  reduced);
* the full-width MoE, frontend, Mamba-2 and hybrid states through
  ``gather_train_state`` /
  ``shard_train_state`` on ``meta`` (shapes and dtypes);
* shards: ``shard_tree`` / ``params_shard_from_jax`` cut the JAX global arrays as ``NamedSharding``
  lays them out.
"""

import re
import warnings
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config, list_archs as j_list_archs
from repro.configs import reduced as j_reduced
from repro.launch import sharding_rules as jrules
from repro.launch import train as jtrain
from repro.models import init_model as j_init_model
from repro_torch.configs import get_config, reduced
from repro_torch.core.participation import ParticipationSpec, parse_faults
from repro_torch.launch import train
from repro_torch.launch.mesh import MeshSpec, parse_mesh
from repro_torch.launch.sharding_rules import batch_specs, h_flat_specs, param_specs, shard_tree

ARCHS = tuple(j_list_archs())
MODELS = (1, 2, 3, 4, 16, 32)
DENSE = ("llama3.2-1b", "granite-8b", "nemotron-4-15b", "stablelm-3b")
MOE_AND_FRONTENDS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b", "internvl2-2b",
                     "musicgen-large")
MAMBA = ("mamba2-130m", "jamba-v0.1-52b")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _model_dim(spec):
    """The index of ``"model"`` in a JAX ``PartitionSpec`` (None if absent);
    no other axis may appear."""
    assert all(e in (None, "model") for e in spec), spec
    return next((i for i, e in enumerate(spec) if e == "model"), None)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_jax_rules(arch, size):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if size == "reduced":
        jcfg, cfg = j_reduced(jcfg), reduced(cfg)
    shapes = jax.eval_shape(lambda: j_init_model(jcfg, jax.random.PRNGKey(0)))
    flat = {p: tuple(a.shape) for p, a in _flat(shapes).items()}
    for m in MODELS:
        mesh = AbstractMesh((2, m), ("data", "model"))
        jspecs = jrules.param_specs(shapes, jcfg, mesh)
        want = {p: _model_dim(s) for p, s in _flat(jspecs).items()}
        got = param_specs(flat, cfg, m)
        assert got == want, (arch, m)
        jh = jtrain.h_flat_specs(jspecs)
        assert h_flat_specs(got) == {p: _model_dim(s) for p, s in _flat(jh).items()}
    if arch in DENSE and size == "full":
        # every matrix of a dense arch splits at M = 2; only the norms stay whole
        assert {p for p, s in param_specs(flat, cfg, 2).items() if s is None} == {
            p for p in flat if p.endswith("scale")}


@pytest.mark.parametrize("arch", ARCHS)
def test_undivided_is_what_the_jax_rules_split_then_leave_whole(arch):
    """``undivided`` (the gate's matrices the axis does not divide): the
    leaves the JAX rules split over a model axis of 1 but not over one of
    ``m``, the divisibility fallback; a leaf replicated by design (the
    router, a norm, a bias) is never among them."""
    from repro_torch.launch.sharding_rules import undivided

    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    shapes = jax.eval_shape(lambda: j_init_model(jcfg, jax.random.PRNGKey(0)))
    flat = {p: tuple(a.shape) for p, a in _flat(shapes).items()}

    def jax_split(m):
        specs = jrules.param_specs(shapes, jcfg, AbstractMesh((2, m), ("data", "model")))
        return {p for p, sp in _flat(specs).items() if _model_dim(sp) is not None}
    ruled = jax_split(1)
    for m in MODELS:
        assert set(undivided(flat, cfg, m)) == ruled - jax_split(m), (arch, m)


@pytest.mark.parametrize("mesh,batch", [("2x2", 4), ("2x2", 3), ("2x1x2", 4), ("2x1x2", 2),
                                        ("3x2x1", 12), ("4", 2)])
def test_batch_specs_match_the_jax_rules(mesh, batch):
    spec = parse_mesh(mesh)
    amesh = AbstractMesh(spec.dims, spec.axes)
    b = {"tokens": np.zeros((batch, 8), np.int32), "labels": np.zeros((batch, 8), np.int32)}
    want = {k: None if s[0] is None else 0 for k, s in jrules.batch_specs(b, amesh).items()}
    assert batch_specs(b, spec) == want


class _Built(Exception):
    pass


def _jax_cli_mesh(monkeypatch, argv):
    """The JAX CLI's mesh (axes and sizes) and its policy's node size: its
    ``main`` run until it builds the training state."""
    seen = {}

    def make_mesh(dims, axes):
        seen["mesh"] = (tuple(dims), tuple(axes))
        return AbstractMesh(tuple(dims), tuple(axes))

    def init_train_state(cfg, opt, mesh, key):
        seen["node_size"] = opt.policy.node_size
        raise _Built

    monkeypatch.setattr(jtrain, "make_mesh", make_mesh)
    monkeypatch.setattr(jtrain, "init_train_state", init_train_state)
    with pytest.raises(_Built):
        jtrain.main(["--arch", "llama3.2-1b", "--reduced", *argv])
    return seen


@pytest.mark.parametrize("argv", [["--mesh", "2x2"], ["--mesh", "4x1"], ["--mesh", "2x1x2"],
                                  ["--mesh", "4"], ["--mesh", "2x2x2"],
                                  ["--mesh", "2x2x1", "--topology", "hierarchical"],
                                  ["--mesh", "2x3x2", "--topology", "hierarchical"]])
def test_parse_mesh_matches_the_jax_cli(monkeypatch, argv):
    seen = _jax_cli_mesh(monkeypatch, argv)
    topology = argv[argv.index("--topology") + 1] if "--topology" in argv else None
    spec = parse_mesh(argv[1], topology)
    assert (spec.dims, spec.axes) == seen["mesh"]
    dims = dict(zip(spec.axes, spec.dims))
    assert spec.model == dims.get("model", 1)
    assert spec.n_workers * spec.model == spec.world
    if topology == "hierarchical":
        assert spec.node_size == seen["node_size"] == dims["data"]
    assert [spec.coords(r) for r in range(spec.world)] == [
        (w, m) for w in range(spec.n_workers) for m in range(spec.model)]


def test_parse_mesh_defaults_and_errors():
    assert parse_mesh(None) == MeshSpec(("data", "model"), (1, 1))
    assert parse_mesh("4x1").n_workers == 4 and parse_mesh("4x1").model == 1
    assert parse_mesh("2x3x2").n_workers == 6 and parse_mesh("2x3x2").node_size == 1
    for bad in ("2x0", "1x2x2x2", "x2"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


_WARNING = re.compile(r"\[reason=[\w-]+ inner_axes=\('model',\) resulting_layout=per-leaf "
                      r"topology=flat\]")


@pytest.mark.parametrize("policy", [None, "default"])
def test_resolve_bucketed_downgrades_on_a_model_axis(policy):
    """One structured warning in the JAX form on a live model axis, every
    group per leaf after it, both directions; a worker mesh keeps the
    layout; ``resolved_layout`` reports each."""
    cfg = reduced(get_config("llama3.2-1b"))
    opt = train.make_optimizer(cfg, policy=policy)
    if policy:
        opt.policy = opt.policy.with_down(method="diana")
    assert opt.policy.any_bucketed()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        down = train.resolve_bucketed(opt, parse_mesh("2x2"))
        same = train.resolve_bucketed(opt, parse_mesh("4x1"))
    assert len(caught) == 1 and caught[0].category is RuntimeWarning
    assert _WARNING.search(str(caught[0].message))
    assert not down.policy.any_bucketed() and same is opt
    assert down.policy == opt.policy.force_perleaf()
    assert train.resolved_layout(opt, parse_mesh("2x2")) == "per-leaf (downgraded)"
    assert train.resolved_layout(opt, parse_mesh("4x1")) == "bucketed"
    assert train.resolved_layout(down, parse_mesh("2x2")) == "per-leaf"


def _opt(cfg, **kw):
    return train.make_optimizer(cfg, **kw)


@pytest.mark.parametrize("case", ["expert-undivided", "mamba-undivided", "hybrid-dots", "tied",
                                  "vr", "down", "policy", "participation", "faults", "chunk",
                                  "hierarchical", "controller", "dots", "heads"])
def test_refusals_name_their_roadmap_item(case):
    cfg = reduced(get_config("llama3.2-1b"))
    mesh, faults, telemetry = parse_mesh("2x2"), None, False
    opt = None
    if case == "mamba-undivided":
        # 3 does not divide out_proj's 512 rows: the JAX fallback
        # replicates the leaf (12(g))
        cfg, mesh = reduced(get_config("mamba2-130m")), parse_mesh("1x3")
    elif case == "hybrid-dots":
        cfg = replace(reduced(get_config("jamba-v0.1-52b")), remat="dots")
    elif case == "expert-undivided":
        moe = reduced(get_config("phi3.5-moe-42b-a6.6b"))
        cfg = replace(moe, moe=replace(moe.moe, n_experts=3))
    elif case == "tied":
        cfg = replace(cfg, tie_embeddings=True)
    elif case == "vr":
        cfg = replace(cfg, vr=True, vr_p=0.5)
    elif case == "down":
        cfg = replace(cfg, comp_down_method="diana")
    elif case == "policy":
        opt = _opt(cfg, policy="default")
    elif case == "participation":
        opt = _opt(cfg, participation=ParticipationSpec(q=0.5))
    elif case == "faults":
        faults = parse_faults("checksum")
    elif case in ("chunk", "hierarchical"):
        opt = _opt(cfg)
        opt.policy = opt.policy.replace(
            **({"chunk_bytes": 1 << 16} if case == "chunk" else
               {"topology": "hierarchical", "node_size": 2}))
    elif case == "controller":
        telemetry = True
    elif case == "dots":
        cfg = replace(cfg, remat="dots")
    elif case == "heads":
        mesh = parse_mesh("1x3")
    opt = opt or _opt(cfg)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item 12\([a-g]\)"):
        train.check_model_axis(cfg, opt, mesh, faults, telemetry)
    # a worker mesh refuses none of them
    train.check_model_axis(cfg, opt, parse_mesh("2x1"), faults, telemetry)


@pytest.mark.parametrize("arch", DENSE)
def test_the_dense_slice_is_accepted(arch):
    for size in (get_config(arch), reduced(get_config(arch))):
        for mesh in ("2x2", "2x1x2"):
            train.check_model_axis(size, _opt(size), parse_mesh(mesh))


@pytest.mark.parametrize("arch", MOE_AND_FRONTENDS)
def test_the_moe_and_frontend_archs_are_accepted(arch):
    """Their router, norm scales and ``frontend_proj/b`` stay whole by
    design; granite-moe's curated grouped policy is still refused (12(e))."""
    for size in (get_config(arch), reduced(get_config(arch))):
        for mesh in ("2x2", "2x1x2"):
            train.check_model_axis(size, _opt(size), parse_mesh(mesh))
    if arch.startswith("granite-moe"):
        with pytest.raises(NotImplementedError, match=r"item 12\(e\)"):
            train.check_model_axis(get_config(arch), _opt(get_config(arch), policy="default"),
                                   parse_mesh("2x2"))


@pytest.mark.parametrize("arch", MAMBA)
def test_the_mamba_and_hybrid_archs_are_accepted(arch):
    """Full (model axes of 2 and 4) and reduced (2): every Mamba-2 leaf the
    rules split divides (jamba's packed ``in_proj`` of 16,544 columns and
    ``conv_w`` of 8,224 channels too); the SSD scalars, ``conv_b`` and
    ``norm_scale`` stay whole by design."""
    for size, meshes in ((get_config(arch), ("2x2", "2x1x2", "1x4")),
                         (reduced(get_config(arch)), ("2x2", "2x1x2"))):
        for mesh in meshes:
            train.check_model_axis(size, _opt(size), parse_mesh(mesh))


@pytest.mark.parametrize("arch", MOE_AND_FRONTENDS + MAMBA)
def test_full_state_shards_and_gathers_on_meta(arch, monkeypatch):
    """The full-width tree on ``meta``: ``gather_train_state`` (its
    collectives shaped, not run) gives the JAX trainer's global shapes and
    dtypes (parameters whole, ``h_worker`` ``(N, d)``, ``h_server``
    ``(d,)``), and ``shard_train_state`` gives each rank's shard shapes back;
    the 4-d stacked experts split on E (``expert``) or F (``ffn``), the
    Mamba-2 mixer's packed ``in_proj`` and ``conv_w`` on their columns and
    ``out_proj`` on its rows."""
    from repro_torch.convert import gather_train_state, shard_train_state
    from repro_torch.core import transport
    from repro_torch.launch.mesh import MeshGroups
    from repro_torch.models.sharding import ModelGroup
    from repro_torch.models.transformer import meta_params

    monkeypatch.setattr(transport, "all_gather_into_tensor", lambda out, src, **kw: None)
    cfg = get_config(arch)
    mesh = parse_mesh("2x2")
    full = meta_params(cfg)
    specs = param_specs(full, cfg, 2)
    opt = _opt(replace(cfg, comp_bucketed=False))
    for m in range(2):
        local = {p: torch.nn.Parameter(v) for p, v in shard_tree(full, specs, 2, m).items()}
        state = opt.init(local, 1)
        groups = MeshGroups(0, m, None, ModelGroup(None, 2, m))
        gp, gs = gather_train_state(local, state, cfg, mesh, groups)
        for p, v in full.items():
            d = v.numel()
            assert gp[p].shape == v.shape and gp[p].dtype == v.dtype, p
            assert gs.inner[p].shape == v.shape, p
            assert gs.diana.h_worker[p].shape == (2, d) and gs.diana.h_server[p].shape == (d,)
            assert gs.diana.h_server[p].dtype == cfg.h_dtype
        bp, bs = shard_train_state(gp, gs, cfg, mesh, 0, m)
        for p, v in local.items():
            assert bp[p].shape == v.shape and bp[p].dtype == v.dtype, p
            assert bs.diana.h_worker[p].shape == state.diana.h_worker[p].shape, p
        moe = next((i for i, sp in enumerate(cfg.pattern) if sp.mlp == "moe"), None)
        if moe is not None:
            w_in = f"blocks/layer{moe}/mlp/w_in"
            assert specs[w_in] == (1 if cfg.moe.partition == "expert" else 3)
            assert specs[f"blocks/layer{moe}/mlp/router"] is None
        if cfg.frontend != "none":
            assert specs["frontend_proj/w"] == 1 and specs["frontend_proj/b"] is None
        if cfg.has_mamba():
            mixer = "blocks/layer0/mixer/"
            assert [specs[mixer + k] for k in ("in_proj", "conv_w", "out_proj")] == [2, 2, 1]
            assert all(specs[mixer + k] is None
                       for k in ("conv_b", "dt_bias", "A_log", "D", "norm_scale"))


def test_in_turn_cli_refuses_a_model_axis(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(NotImplementedError, match="torchrun --nproc-per-node 4"):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x2",
                    "--steps", "1", "--batch", "4", "--seq", "16"])


def test_round_over_a_group_refuses_what_it_does_not_hold(tmp_path):
    """``aggregate_distributed(group=)`` takes a flat per-leaf config alone
    (a one-rank gloo group in this process)."""
    from repro_torch.core import prng
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.diana import aggregate_distributed, init_state

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        g = {"w": torch.ones(4, 4)}
        for cfg in (CompressionConfig(method="diana", bucketed=True),
                    CompressionConfig(method="diana", bucketed=False, vr=True, vr_p=0.5),
                    CompressionConfig(method="diana", bucketed=False, down_method="diana")):
            with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 12"):
                aggregate_distributed(g, init_state(g, cfg, 1), prng.PRNGKey(0), cfg,
                                      group=dist.group.WORLD)
        cfg = CompressionConfig(method="diana", bucketed=False, block_size=4)
        ghat, _ = aggregate_distributed(g, init_state(g, cfg, 1), prng.PRNGKey(0), cfg,
                                        group=dist.group.WORLD)
        assert ghat["w"].shape == (4, 4)
    finally:
        dist.destroy_process_group()


def test_shards_are_the_named_sharding_slices():
    """``shard_tree`` cuts each leaf into the model axis's contiguous, equal
    slices, each a copy of its own (one layer's experts split on E are a
    contiguous slice of the leaf: a view would keep the whole leaf alive),
    ``params_shard_from_jax`` the same from numpy, and concatenating the
    shards gives the leaf back."""
    from repro_torch.convert import params_shard_from_jax
    from repro_torch.models.transformer import init_model

    for cfg in (reduced(get_config("nemotron-4-15b")),
                replace(reduced(get_config("phi3.5-moe-42b-a6.6b")), n_layers=1)):
        full = init_model(cfg, "cpu", seed=2)
        specs = param_specs(full, cfg, 2)
        np_tree = {p: v.detach().numpy() for p, v in full.items()}
        for m in range(2):
            local = shard_tree(full, specs, 2, m)
            conv = params_shard_from_jax(np_tree, cfg, "cpu", 2, m)
            for p, v in local.items():
                want = list(full[p].shape)
                if specs[p] is not None:
                    want[specs[p]] //= 2
                assert list(v.shape) == want
                assert torch.equal(conv[p], v) and v.is_contiguous()
                if specs[p] is not None:    # its own storage: dropping the leaf frees it
                    assert v.untyped_storage().nbytes() == v.numel() * v.element_size(), p
        for p, s in specs.items():
            parts = [shard_tree({p: full[p]}, specs, 2, m)[p] for m in range(2)]
            whole = parts[0] if s is None else torch.cat(parts, dim=s)
            assert torch.equal(whole, full[p])


def test_model_group_is_seen_from_other_threads():
    """autograd runs a CUDA backward, and with it a checkpointed block's
    recomputation, on a device thread of its own: the model group must be
    the process's, not the calling thread's, or the recompute would skip
    the tensor-parallel collectives."""
    import threading

    from repro_torch.models.sharding import ModelGroup, current, model_parallel

    mp, seen = ModelGroup(None, 2, 1), []
    with model_parallel(mp):
        t = threading.Thread(target=lambda: seen.append(current()))
        t.start()
        t.join()
    assert seen == [mp] and current() is None
