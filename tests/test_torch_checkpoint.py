"""The port's checkpoint (``repro_torch.checkpoint``) on the CPU: the JAX
package's own checkpoint tests (``tests/test_checkpoint.py``) ported to the
port's trees, and checkpoints that cross between the packages.

* Ported: the round trip (bf16, nesting, a Python ``int`` leaf), the latest
  step, a missing directory, a shape mismatch, a missing leaf with the VR
  and ``h_down`` hints, no temp litter, the DIANA state in both layouts with
  the VR slot and the downlink memory, and both restore hints.
* Across the packages, both directions, bit for bit: the parameters of an
  f32 and of a bf16 reduced arch (against ``params_from_jax``), adamw's
  state (against ``adam_state_from_jax``; its ``count`` a 0-dim int32 in
  the JAX package, a Python int in the port) and float8 leaves.  Where both
  packages write the same tree, their manifests are the same bytes; the
  restore hints give the JAX package's strings.

The DIANA states (flat and grouped, VR, ``h_down``, an elastic state
mid-churn, the optimizer's state) are in ``tests/test_torch_checkpoint_states.py``.
"""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import (controller_restore_hint as j_controller_hint,
                              participation_restore_hint as j_participation_hint,
                              restore_checkpoint as j_restore, save_checkpoint as j_save)
from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import BudgetController as JController, init_state as j_init_state
from repro.core import policy as JPol
from repro.core.compression import CompressionConfig as JCfg
from repro.core.participation import ChurnEvent as JChurn, ParticipationSpec as JSpec
from repro.models import init_model as j_init_model
from repro.optim.optimizers import adamw as j_adamw
from repro_torch.checkpoint import (controller_restore_hint, latest_step, load_metadata,
                                    participation_restore_hint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import adam_state_from_jax, params_from_jax, tensor_from_numpy
from repro_torch.core import policy as TPol
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.controller import BudgetController
from repro_torch.core.diana import init_state
from repro_torch.core.participation import ChurnEvent, ParticipationSpec
from repro_torch.models.transformer import init_model
from repro_torch.optim.optimizers import AdamState, adamw


def _bits(x) -> np.ndarray:
    """A tensor's or array's raw bytes as uint8 (any dtype, bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dim() == 0:
            x = x.reshape(1)
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(2, dtype=torch.bfloat16) * 1.5},
        "step": 7,
        "nested": [torch.zeros(2, 2), (torch.ones(3, dtype=torch.int8),)],
    }


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return f.read()


# ---------------------------------------------------------------- the port's own


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 42, tree)
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 42
    assert restored["step"] == 7 and type(restored["step"]) is int
    assert type(restored["nested"]) is list and type(restored["nested"][1]) is tuple
    for k in ("w", "b"):
        a, b = tree["params"][k], restored["params"][k]
        assert a.dtype == b.dtype and _same(a, b)
    assert _same(restored["nested"][1][0], tree["nested"][1][0])
    assert restored["nested"][1][0].dtype == torch.int8
    manifest = json.loads(_manifest(tmp_path))
    assert manifest["dtypes"] == {"nested/0": "float32", "nested/1/0": "int8",
                                  "params/b": "bfloat16", "params/w": "float32",
                                  "step": "int32"}


def test_latest_step(tmp_path):
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    save_checkpoint(str(tmp_path), 5, {"x": torch.zeros(2)})
    assert latest_step(str(tmp_path)) == 5


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(2)})


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(2)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(3)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"x": 3})       # an int leaf is 0-dim


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(2)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(2), "y": torch.zeros(1)})


def test_no_tmp_litter(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.npz", "manifest.json"]


def test_template_types_dtypes_and_parameters(tmp_path):
    """Restore returns the template's types: an ``nn.Parameter`` (its
    ``requires_grad`` kept) where the template has one, a leaf cast to the
    template's dtype as the JAX restore casts it (f32 -> bf16, round to
    nearest even), and a leaf that is no tensor or int is refused."""
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    save_checkpoint(str(tmp_path), 0, {"p": torch.from_numpy(x), "q": torch.from_numpy(x)})
    tmpl = {"p": torch.nn.Parameter(torch.zeros(64)),
            "q": torch.zeros(64, dtype=torch.bfloat16)}
    got, _ = restore_checkpoint(str(tmp_path), tmpl)
    assert isinstance(got["p"], torch.nn.Parameter) and got["p"].requires_grad
    assert not isinstance(got["q"], torch.nn.Parameter) and got["q"].dtype == torch.bfloat16
    want, _ = j_restore(str(tmp_path), {"p": jnp.zeros(64), "q": jnp.zeros(64, jnp.bfloat16)})
    assert _same(got["q"], want["q"]) and _same(got["p"], want["p"])
    with pytest.raises(TypeError, match="tensors or ints"):
        save_checkpoint(str(tmp_path), 1, {"x": 1.5})


def _diana_state(bucketed, vr, down=False):
    """A populated (non-zero) port DianaState in the requested layout."""
    params = {"w": torch.ones(6, 4, dtype=torch.bfloat16) * 0.5, "b": torch.zeros(10)}
    cfg = TCfg(method="diana", block_size=16, bucketed=bucketed, vr=vr,
               vr_p=0.25 if vr else None, down_method="diana" if down else None)
    st = init_state(params, cfg, 3)
    fill = lambda t: (torch.arange(t.numel(), dtype=torch.float32).reshape(t.shape)  # noqa: E731
                      .to(t.dtype) if isinstance(t, torch.Tensor)
                      else {k: fill(v) for k, v in t.items()})
    st = st._replace(h_worker=fill(st.h_worker), h_server=fill(st.h_server))
    if vr:
        st = st._replace(vr=st.vr._replace(mu=fill(st.vr.mu)))
    if down:
        st = st._replace(h_down=fill(st.h_down))
    return st


def _state_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and _same(a, b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_state_equal(a[k], b[k]) for k in a)
    return type(a) is type(b) and all(_state_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
@pytest.mark.parametrize("vr", [False, True], ids=["plain", "vr"])
def test_diana_state_roundtrip(tmp_path, bucketed, vr):
    st = _diana_state(bucketed, vr)
    save_checkpoint(str(tmp_path), 11, {"diana": st})
    restored, step = restore_checkpoint(str(tmp_path), {"diana": _diana_state(bucketed, vr)
                                                        ._replace(h_server=st.h_server)})
    assert step == 11 and _state_equal(restored["diana"], st)
    keys = json.loads(_manifest(tmp_path))["keys"]
    assert any("/vr/" in k for k in keys) == vr
    assert not any("h_down" in k.split("/") for k in keys)


def _jax_state(bucketed, vr, down=False):
    params = {"w": jnp.ones((6, 4), jnp.bfloat16) * 0.5, "b": jnp.zeros((10,))}
    return j_init_state(params, JCfg(method="diana", block_size=16, bucketed=bucketed, vr=vr,
                                     vr_p=0.25 if vr else None,
                                     down_method="diana" if down else None), 3)


def _hint(err):
    return str(err.value).split(" — ", 1)[1]


def test_pre_vr_checkpoint_into_vr_template_hints(tmp_path):
    """A vr=False checkpoint into a VR template: a KeyError naming the VR
    slot, with the JAX package's hint word for word."""
    save_checkpoint(str(tmp_path), 0, {"diana": _diana_state(True, False)})
    with pytest.raises(KeyError, match="vr") as mine:
        restore_checkpoint(str(tmp_path), {"diana": _diana_state(True, True)})
    jtmpl = {"diana": _jax_state(bucketed=True, vr=True)}
    with pytest.raises(KeyError) as theirs:
        j_restore(str(tmp_path), jtmpl)
    assert _hint(mine) == _hint(theirs)


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
def test_downlink_state_roundtrip(tmp_path, bucketed):
    st = _diana_state(bucketed, vr=False, down=True)
    save_checkpoint(str(tmp_path), 4, {"diana": st})
    restored, step = restore_checkpoint(str(tmp_path), {"diana": st})
    assert step == 4 and _state_equal(restored["diana"], st)
    assert any("h_down" in k.split("/") for k in json.loads(_manifest(tmp_path))["keys"])
    save_checkpoint(str(tmp_path), 5, {"diana": _diana_state(bucketed, False)})
    assert not any("h_down" in k.split("/") for k in json.loads(_manifest(tmp_path))["keys"])


def test_pre_downlink_checkpoint_into_downlink_template_hints(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"diana": _diana_state(True, False)})
    with pytest.raises(KeyError, match="h_down") as mine:
        restore_checkpoint(str(tmp_path), {"diana": _diana_state(True, False, down=True)})
    with pytest.raises(KeyError) as theirs:
        j_restore(str(tmp_path), {"diana": _jax_state(True, False, down=True)})
    assert _hint(mine) == _hint(theirs)


def _policies(**part):
    """The same flat policy in both packages, with an elastic spec or none."""
    churn = part.pop("churn", ())
    js = JSpec(churn=tuple(JChurn(*c) for c in churn), **part) if part else None
    ts = ParticipationSpec(churn=tuple(ChurnEvent(*c) for c in churn), **part) if part else None
    return (JPol.as_policy(JCfg(method="diana", block_size=16, participation=js)),
            TPol.as_policy(TCfg(method="diana", block_size=16, participation=ts)))


def test_participation_restore_hint_matches_jax(tmp_path):
    """Same spec: no hint; a changed or dropped spec: the JAX package's
    hint; a save without policy metadata into a trivial template: none."""
    spec = dict(q=0.5, dropout=0.2, min_workers=2, churn=((1, 2, "leave"), (3, 2, "join")))
    jpol, tpol = _policies(**spec)
    save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(2)},
                    metadata={"policy": tpol.to_json_dict()})
    assert participation_restore_hint(str(tmp_path), tpol) is None
    assert j_participation_hint(str(tmp_path), jpol) is None
    for other in (dict(q=0.25), {}):
        jo, to = _policies(**other)
        hint = participation_restore_hint(str(tmp_path), to)
        assert hint is not None and hint == j_participation_hint(str(tmp_path), jo)
    assert "0.25" in participation_restore_hint(str(tmp_path), _policies(q=0.25)[1])
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    assert participation_restore_hint(str(tmp_path), _policies()[1]) is None


def test_controller_restore_hint_matches_jax(tmp_path):
    """Every branch of the hint, against the JAX package's strings."""
    jpol, tpol = _policies()
    live = (JController(base=jpol, budget_bits_per_dim=1.0, interval=7),
            BudgetController(base=tpol, budget_bits_per_dim=1.0, interval=7))
    other = (JController(base=jpol, budget_bits_per_dim=2.0),
             BudgetController(base=tpol, budget_bits_per_dim=2.0))
    d = str(tmp_path)
    save_checkpoint(d, 0, {"x": torch.zeros(2)})
    assert controller_restore_hint(d, None) is None is j_controller_hint(d, None)
    assert controller_restore_hint(d, live[1]) == j_controller_hint(d, live[0]) is not None
    save_checkpoint(d, 1, {"x": torch.zeros(2)},
                    metadata={"controller": {"budget_bits_per_dim": 1.0, "step": 5}})
    assert controller_restore_hint(d, None) == j_controller_hint(d, None) is not None
    assert controller_restore_hint(d, live[1]) is None is j_controller_hint(d, live[0])
    assert controller_restore_hint(d, other[1]) == j_controller_hint(d, other[0]) is not None
    assert load_metadata(d) == {"controller": {"budget_bits_per_dim": 1.0, "step": 5}}


# ------------------------------------------------------------ across the packages


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("arch,dtype", [("llama3.2-1b", None),
                                        ("granite-moe-3b-a800m", "bfloat16")],
                         ids=["llama-f32", "granite-moe-bf16"])
def test_params_cross_package(tmp_path, arch, dtype):
    """A JAX-written parameter checkpoint restores in the port (into a
    template of another seed) as ``params_from_jax`` of the same tree; the
    port's checkpoint of those parameters restores in the JAX package with
    the original bits; the two manifests are the same bytes.  The bf16
    model keeps its f32 leaves (the MoE router)."""
    over = {} if dtype is None else dict(param_dtype=getattr(jnp, dtype),
                                         compute_dtype=getattr(jnp, dtype))
    jcfg = replace(j_reduced(j_get_config(arch)), **over)
    tcfg = replace(reduced(get_config(arch)), **({} if dtype is None else dict(
        param_dtype=getattr(torch, dtype), compute_dtype=getattr(torch, dtype))))
    jparams = j_init_model(jcfg, jax.random.PRNGKey(0))
    meta = {"policy": {"rules": [{"pattern": ".*", "method": "diana"}], "bucketed": True}}
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_save(j_dir, 3, {"params": jparams}, metadata=meta)
    want = params_from_jax(_np_tree(jparams), tcfg, "cpu")
    tmpl = init_model(tcfg, "cpu", seed=5)
    assert not all(_same(tmpl[p], want[p]) for p in want)
    got, step = restore_checkpoint(j_dir, {"params": tmpl})
    assert step == 3 and sorted(got["params"]) == sorted(want)
    for p, w in want.items():
        g = got["params"][p]
        assert isinstance(g, torch.nn.Parameter) and g.dtype == w.dtype and _same(g, w), p
    if dtype is not None:
        assert {str(want[p].dtype) for p in want} == {"torch.bfloat16", "torch.float32"}
    save_checkpoint(t_dir, 3, {"params": want}, metadata=meta)
    assert _manifest(t_dir) == _manifest(j_dir)
    back, step = j_restore(t_dir, {"params": j_init_model(jcfg, jax.random.PRNGKey(9))})
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and _same(a, b)


def test_adamw_state_cross_package(tmp_path):
    """adamw's ``AdamState`` after two updates: ``count`` (a 0-dim int32 in
    the JAX package) restores as the port's Python int and back."""
    rng = np.random.default_rng(1)
    jparams = {"a": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)},
               "b": jnp.asarray(rng.standard_normal(5), jnp.float32)}
    opt = j_adamw()
    st = opt.init(jparams)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), jparams)
        _, st = opt.update(grads, st, jparams, 1e-3)
    assert int(st.count) == 2
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_save(j_dir, 2, {"opt": st})
    want = adam_state_from_jax(_np_tree(st), "cpu")
    tmpl = adamw().init({"a/w": torch.zeros(4, 3), "b": torch.zeros(5)})
    got, _ = restore_checkpoint(j_dir, {"opt": tmpl})
    got = got["opt"]
    assert isinstance(got, AdamState) and got.count == 2 and type(got.count) is int
    for field in ("mu", "nu"):
        assert all(_same(getattr(got, field)[p], getattr(want, field)[p])
                   for p in getattr(want, field))
    save_checkpoint(t_dir, 2, {"opt": want})
    assert _manifest(t_dir) == _manifest(j_dir)
    back, _ = j_restore(t_dir, {"opt": opt.init(jparams)})
    assert back["opt"].count.dtype == jnp.int32 and int(back["opt"].count) == 2
    for a, b in zip(jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and _same(a, b)


def test_float8_leaves_cross_package(tmp_path):
    """float8_e4m3fn and float8_e5m2 leaves ride as their uint8 bits, their
    names in the manifest, both ways."""
    rng = np.random.default_rng(2)
    jtree = {"e4": jnp.asarray(rng.standard_normal(7) * 4, jnp.float8_e4m3fn),
             "e5": jnp.asarray(rng.standard_normal((2, 3)) * 100, jnp.float8_e5m2),
             "n": jnp.asarray(3, jnp.int32)}
    ttree = {"e4": tensor_from_numpy(np.asarray(jtree["e4"]).view(np.int8), "cpu")
             .view(torch.float8_e4m3fn),
             "e5": tensor_from_numpy(np.asarray(jtree["e5"]).view(np.int8), "cpu")
             .view(torch.float8_e5m2),
             "n": 3}
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_save(j_dir, 1, jtree)
    save_checkpoint(t_dir, 1, ttree)
    assert _manifest(t_dir) == _manifest(j_dir)
    assert json.loads(_manifest(t_dir))["dtypes"] == {"e4": "float8_e4m3fn",
                                                      "e5": "float8_e5m2", "n": "int32"}
    tmpl = {"e4": torch.zeros(7, dtype=torch.float8_e4m3fn),
            "e5": torch.zeros(2, 3, dtype=torch.float8_e5m2), "n": 0}
    got, _ = restore_checkpoint(j_dir, tmpl)
    assert got["n"] == 3 and all(got[k].dtype == tmpl[k].dtype and _same(got[k], ttree[k])
                                 for k in ("e4", "e5"))
    back, _ = j_restore(t_dir, jax.tree_util.tree_map(jnp.zeros_like, jtree))
    for k in jtree:
        assert back[k].dtype == jtree[k].dtype and _same(back[k], jtree[k])
