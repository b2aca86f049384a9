"""Serving's placement rules and gates against the JAX package, in this
process (``meta`` shapes, ``AbstractMesh``; no ranks):

* ``serve_cache_shardings`` / ``cache_specs`` against
  ``repro.launch.serve.serve_cache_shardings`` for the ten archs (full
  configs) at ``decode_32k``, at ``long_500k`` where ``shape_applicable``
  allows it, and at a batch of 3 (which the data axes of 2 and 4 do not
  divide), on the meshes ``(2, 2)``, ``(4, 1)``, ``(1, 4)`` and ``2x1x2``
  (``pod``): per leaf the dimension over ``model`` and the one over the
  data axes are the positions of ``"model"`` and of the data axes in the
  JAX ``PartitionSpec``, the global shapes and the window the same;
* what a rank holds (``held_cache_specs``: the Mamba-2 caches whole over
  ``model``) and ``init_serve_caches``' local shapes;
* ``check_serve_mesh`` refuses each ROADMAP.md queue 1 item 12(g) case and
  names it, and accepts the ten reduced archs on ``(2, 2)``;
* a ``1x1`` mesh serves bitwise what no mesh serves (decode and prefill).
"""

import re
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config, list_archs as j_list_archs
from repro.configs import get_shape as j_get_shape
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import serve as jserve
from repro_torch.configs import ShapeConfig, get_config, get_shape, reduced, shape_applicable
from repro_torch.launch.mesh import parse_mesh
from repro_torch.launch.serve import (build_prefill, build_serve_step, check_serve_mesh,
                                      init_serve_caches, serve_cache_shardings)
from repro_torch.launch.sharding_rules import CacheSpec, held_cache_specs

ARCHS = tuple(j_list_archs())
MESHES = ("2x2", "4x1", "1x4", "2x1x2")
SHAPES = ("decode_32k", "long_500k", "odd")
ODD_BATCH = 3


def _shape(name, pkg):
    if name == "odd":
        return (JShapeConfig if pkg == "jax" else ShapeConfig)("odd", 4096, ODD_BATCH, "decode")
    return (j_get_shape if pkg == "jax" else get_shape)(name)


def _spec_of(spec, ndim):
    """``CacheSpec`` of a JAX ``PartitionSpec``: the positions of
    ``"model"`` and of the data axes (``"data"``, ``"pod"`` or both)."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    model = [i for i, e in enumerate(entries) if e == "model"]
    data = [i for i, e in enumerate(entries) if e not in (None, "model")]
    assert len(model) <= 1 and len(data) <= 1, spec
    for i in data:
        axes = entries[i] if isinstance(entries[i], tuple) else (entries[i],)
        assert set(axes) <= {"pod", "data"}, spec
    return CacheSpec(model[0] if model else None, data[0] if data else None)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_jax_rules(arch, mesh):
    spec = parse_mesh(mesh)
    amesh = AbstractMesh(spec.dims, spec.axes)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    seen = 0
    for name in SHAPES:
        shape = _shape(name, "torch")
        if not shape_applicable(cfg, shape)[0]:
            continue
        jsh, jcaches, jwin = jserve.serve_cache_shardings(jcfg, amesh, _shape(name, "jax"))
        specs, caches, window = serve_cache_shardings(cfg, spec, shape)
        assert window == jwin
        jleaves = jax.tree_util.tree_leaves(jcaches)
        jspecs = jax.tree_util.tree_leaves(jsh)
        mine = [s for c in specs for s in c]
        shapes = [tuple(t.shape) for c in caches for t in c]
        assert shapes == [tuple(x.shape) for x in jleaves], (name, shapes)
        assert mine == [_spec_of(s.spec, x.ndim) for s, x in zip(jspecs, jleaves)], name
        seen += 1
    assert seen >= 2


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b", "llama3.2-1b"])
def test_held_specs_and_local_shapes(arch):
    """A rank holds the JAX placement but the Mamba-2 caches whole over
    ``model``; ``init_serve_caches`` gives the global shapes cut by it."""
    mesh, cfg = parse_mesh("2x2"), get_config(arch)
    for name in ("decode_32k", "long_500k"):
        shape = get_shape(name)
        specs, caches, _ = serve_cache_shardings(cfg, mesh, shape)
        held = held_cache_specs(specs)
        local = init_serve_caches(cfg, shape, mesh, device="meta")
        for c, s, h, loc in zip(caches, specs, held, local):
            for field, t, sp, hp, lt in zip(c._fields, c, s, h, loc):
                assert hp == (sp._replace(model=None) if field in ("conv", "ssm") else sp)
                want = list(t.shape)
                if hp.model is not None:
                    want[hp.model] //= 2
                if hp.data is not None:
                    want[hp.data] //= 2
                assert tuple(lt.shape) == tuple(want) and lt.dtype == t.dtype, (field,)


def test_llama_long_500k_splits_the_ring_over_data():
    specs, caches, window = serve_cache_shardings(get_config("llama3.2-1b"), parse_mesh("2x2"),
                                                  get_shape("long_500k"))
    assert window == 8192 and tuple(caches[0].k.shape) == (16, 1, 8192, 8, 64)
    assert specs[0].k == CacheSpec(3, 2) and specs[0].pos == CacheSpec(None, None)


ITEM = "ROADMAP.md queue 1 item 12(g)"
REFUSALS = {
    "kv heads": ("llama3.2-1b", {}, "1x16", "query and KV heads"),
    "reduced kv heads": ("llama3.2-1b", "reduced", "1x4", "query and KV heads"),
    "tied embedding": ("llama3.2-1b", {"tie_embeddings": True}, "2x2", "tied embedding"),
    "moe ffn": ("granite-moe-3b-a800m", {}, "1x3", "MoE partition 'ffn'"),
    "moe expert": ("phi3.5-moe-42b-a6.6b", {}, "1x32", "MoE partition 'expert'"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_check_serve_mesh_refuses_and_names_the_item(case):
    arch, over, mesh, what = REFUSALS[case]
    cfg = reduced(get_config(arch)) if over == "reduced" else replace(get_config(arch), **over)
    with pytest.raises(NotImplementedError, match=re.escape(what) + ".*" + re.escape(ITEM)):
        check_serve_mesh(cfg, parse_mesh(mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_check_serve_mesh_accepts_the_reduced_archs(arch):
    check_serve_mesh(reduced(get_config(arch)), parse_mesh("2x2"))
    check_serve_mesh(reduced(get_config(arch)), parse_mesh("4x1"))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m", "granite-moe-3b-a800m"])
def test_a_1x1_mesh_is_bitwise_no_mesh(arch):
    from repro_torch.models.transformer import init_model

    cfg = reduced(get_config(arch))
    shape = ShapeConfig("decode", 16, 2, "decode")
    params = init_model(cfg, "cpu", seed=4)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 3)))
    runs = []
    for mesh in (None, parse_mesh("1x1")):
        caches = init_serve_caches(cfg, shape, mesh)
        step, logits = build_serve_step(cfg, shape, mesh, params=params), []
        for i in range(3):
            lg, caches = step(params, caches, toks[:, i:i + 1])
            logits.append(lg)
        pre = build_prefill(cfg, ShapeConfig("p", 3, 2, "prefill"), mesh)(params,
                                                                          {"tokens": toks})
        runs.append([*logits, pre, *(t for c in caches for t in c)])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)
