"""The port's ten architecture configs and parameter trees against the JAX
package's, without allocating a full-size model.

* Every config, full and ``reduced``, agrees field by field with the JAX
  one (dtypes compared by name; the JAX-only ``scan_unroll`` and
  ``comp_worker_axes`` are not ported), and so do the derived properties.
* ``param_shapes`` / ``param_dtypes`` equal ``jax.eval_shape(init_model)``
  path by path for all ten full configs (the f32 router and SSD scalars in
  bf16 models included).
* ``count_params``, ``count_active_params`` and ``model_flops_per_token``
  equal the JAX package's on the same trees (the port's on ``meta``
  tensors), exactly.
* The registry, ``input_shapes`` (the frontend prefix) and
  ``make_lm_batch`` (the stub embeddings) equal the JAX package's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config, list_archs as j_list_archs
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeConfig as JShape
from repro.configs.shapes import input_specs
from repro.data import make_lm_batch as j_make_lm_batch
from repro.models import init_model as j_init_model
from repro.models.transformer import (count_active_params as j_active,
                                      count_params as j_count,
                                      model_flops_per_token as j_flops)
from repro_torch.configs import (ASSIGNED_ARCHS, ShapeConfig, get_config, input_shapes,
                                 list_archs, reduced)
from repro_torch.core.tree import flatten_nested
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.models.transformer import (count_active_params, count_params, meta_params,
                                            model_flops_per_token, param_dtypes, param_shapes)

JAX_ONLY = {"scan_unroll", "comp_worker_axes"}
DERIVED = ("resolved_head_dim", "padded_vocab", "n_blocks")
METHODS = ("has_attention", "has_mamba", "supports_long_context")


def _norm(v):
    """Dtypes by name (``jnp.bfloat16`` / ``torch.bfloat16``), nested
    dataclasses as dicts."""
    if dataclasses.is_dataclass(v):
        return {f.name: _norm(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type) or hasattr(v, "dtype") and not isinstance(v, (int, float)):
        return np.dtype(v).name
    return v


def test_registry_is_the_jax_one():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert set(list_archs()) == set(ASSIGNED_ARCHS) <= set(j_list_archs())


@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", J_ARCHS)
def test_config_fields_agree(arch, red):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if red:
        jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
    jf = {f.name for f in dataclasses.fields(jcfg)} - JAX_ONLY
    tf = {f.name for f in dataclasses.fields(tcfg)}
    assert jf == tf
    for name in sorted(jf):
        assert _norm(getattr(tcfg, name)) == _norm(getattr(jcfg, name)), name
    for name in DERIVED:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for name in METHODS:
        assert getattr(tcfg, name)() == getattr(jcfg, name)(), name


@pytest.mark.parametrize("arch", J_ARCHS)
def test_param_tree_equals_jax_eval_shape(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    abstract = jax.eval_shape(lambda k: j_init_model(jcfg, k), jax.random.PRNGKey(0))
    jtree = flatten_nested(abstract)
    shapes, dtypes = param_shapes(tcfg), param_dtypes(tcfg)
    assert list(shapes) == list(dtypes)
    assert set(shapes) == set(jtree)
    for p, leaf in jtree.items():
        assert tuple(shapes[p]) == tuple(leaf.shape), p
        assert _norm(dtypes[p]) == np.dtype(leaf.dtype).name, p

    meta = meta_params(tcfg)
    n = count_params(meta)
    assert n == j_count(abstract)
    assert count_active_params(tcfg, meta) == j_active(jcfg, abstract)
    assert model_flops_per_token(tcfg, meta) == j_flops(jcfg, abstract)
    assert all(t.device.type == "meta" for t in meta.values())


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large", "llama3.2-1b"])
def test_input_shapes_and_batches_equal_jax(arch):
    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jshape, tshape = JShape("t", 48, 4, "train"), ShapeConfig("t", 48, 4, "train")
    specs = input_specs(jcfg, jshape)
    assert input_shapes(tcfg, tshape) == {k: tuple(v.shape) for k, v in specs.items()}
    for step in range(2):
        jb, tb = j_make_lm_batch(jcfg, jshape, step), make_lm_batch(tcfg, tshape, step)
        assert set(jb) == set(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k
