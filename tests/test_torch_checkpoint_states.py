"""DIANA states through the checkpoint, across the packages, bit for bit in
both directions, and with the same manifest bytes:

* a flat (bucketed) and a grouped reference state, each with the VR slot
  and a downlink memory (``h_down``), restored in the port as
  ``state_from_jax`` of the same tree, and back;
* the optimizer's ``DianaOptState`` (its ``step`` a 0-dim int32 in the JAX
  package, a Python int in the port), the inner momentum and the DIANA
  state, both ways;
* the JAX package's elastic state saved mid-churn
  (``tests/test_checkpoint.py::test_elastic_state_roundtrip_mid_churn``:
  worker 2 left at step 1, rejoins at step 3), restored in the port and
  continued one step by the port's ``reference_step`` with the same bits
  as the jitted JAX round continuing from the state it saved.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_metadata as j_load_metadata
from repro.checkpoint import restore_checkpoint as j_restore, save_checkpoint as j_save
from repro.core import policy as JPol
from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import reference_init as j_ref_init, reference_step as j_ref_step
from repro.core.participation import ChurnEvent as JChurn, ParticipationSpec as JSpec
from repro.optim.diana_optimizer import DianaOptimizer as JOptimizer
from repro.optim.optimizers import momentum as j_momentum
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.convert import state_from_jax, tensor_from_numpy
from repro_torch.core import policy as TPol
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import ReferenceState, reference_init, reference_step
from repro_torch.core.participation import ChurnEvent, ParticipationSpec
from repro_torch.core.tree import flatten_nested
from repro_torch.optim.diana_optimizer import DianaOptimizer, DianaOptState
from repro_torch.optim.optimizers import momentum

N = 3
GROUPED = ("^b$=identity,^e$=topk_ef:k=8:layout=perleaf/diana:block=16,"
           "*=diana:block=16/topk_ef:k=8")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def _params():
    """A bf16 and two f32 leaves, as JAX arrays and as the port's tensors."""
    rng = np.random.default_rng(0)
    jp = {"w": jnp.asarray(rng.standard_normal((6, 8)), jnp.bfloat16),
          "e": jnp.asarray(rng.standard_normal((5, 4)), jnp.float32),
          "b": jnp.asarray(rng.standard_normal(10), jnp.float32)}
    return jp, {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}


def _fill(tree, seed):
    """Every leaf replaced by seeded normals in its own dtype and shape."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), tree)


def _specs(grouped):
    common = dict(bucketed=True, vr=True, vr_p=0.5)
    if grouped:
        return (JPol.CompressionPolicy(rules=JPol.parse_rules(GROUPED), **common),
                TPol.CompressionPolicy(rules=TPol.parse_rules(GROUPED), **common))
    flat = dict(method="diana", block_size=16, down_method="diana", **common)
    return JCfg(**flat), TCfg(**flat)


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return f.read()


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _same_files(a, b):
    """Two checkpoint directories hold the same manifest and arrays."""
    assert _manifest(a) == _manifest(b)
    name = json.loads(_manifest(a))["file"]
    x, y = _npz(os.path.join(a, name)), _npz(os.path.join(b, name))
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and _same(x[k], y[k]), k


def _leaves_equal(a, b):
    """The port's state trees (tensors, dicts, lists, NamedTuples) equal."""
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and _same(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, int):
        assert a == b and type(b) is int
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
def test_reference_state_cross_package(tmp_path, grouped):
    jspec, tspec = _specs(grouped)
    jp, tp = _params()
    jstate = _fill(j_ref_init(jp, jspec, N), 1)
    assert jstate.vr is not None and jstate.h_down is not None
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_save(j_dir, 7, {"ref": jstate})
    want = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    got, step = restore_checkpoint(j_dir, {"ref": reference_init(tp, tspec, N)})
    assert step == 7 and isinstance(got["ref"], ReferenceState)
    _leaves_equal(got["ref"], want)
    if grouped:
        assert isinstance(got["ref"].h_worker["g01_topk_ef"], list)
    save_checkpoint(t_dir, 7, {"ref": want})
    _same_files(j_dir, t_dir)
    back, _ = j_restore(t_dir, {"ref": j_ref_init(jp, jspec, N)})
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and _same(a, b)


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
def test_optimizer_state_cross_package(tmp_path, grouped):
    """``{"params", "opt_state"}`` as the trainer holds them: a JAX-written
    ``opt_state/step`` restores as the port's int and back."""
    jspec, tspec = _specs(grouped)
    jp, tp = _params()
    jopt = JOptimizer(policy=JPol.as_policy(jspec), inner=j_momentum())
    topt = DianaOptimizer(policy=tspec, inner=momentum())
    jst = _fill(jopt.init(jp, N), 2)._replace(step=jnp.asarray(3, jnp.int32))
    jtree = {"params": _fill(jp, 3), "opt_state": jst}
    j_dir, t_dir, r_dir = (str(tmp_path / d) for d in ("jax", "torch", "resaved"))
    meta = {"policy": TPol.as_policy(tspec).to_json_dict()}
    j_save(j_dir, 3, jtree, metadata=meta)
    tmpl = {"params": {k: torch.nn.Parameter(v.clone()) for k, v in tp.items()},
            "opt_state": topt.init(tp, N)}
    got, _ = restore_checkpoint(j_dir, tmpl)
    st = got["opt_state"]
    assert isinstance(st, DianaOptState) and st.step == 3 and type(st.step) is int
    assert isinstance(got["params"]["w"], torch.nn.Parameter)
    save_checkpoint(r_dir, 3, got, metadata=meta)
    _same_files(j_dir, r_dir)
    # the port's own tree, converted leaf by leaf, writes the same files
    conv = lambda t: {k: tensor_from_numpy(np.asarray(v), "cpu")  # noqa: E731
                      for k, v in flatten_nested(jax.tree_util.tree_map(np.asarray, t)).items()}
    jd = jax.tree_util.tree_map(np.asarray, jst.diana)
    dstate = state_from_jax(
        ReferenceState(h_worker=jd.h_worker, h_server=jd.h_server, v=None, vr=jd.vr,
                       h_down=jd.h_down), "cpu")
    mine = {"params": conv(jtree["params"]),
            "opt_state": DianaOptState(step=3, inner=conv(jst.inner),
                                       diana=topt.init(tp, N).diana._replace(
                                           h_worker=dstate.h_worker, h_server=dstate.h_server,
                                           vr=dstate.vr, h_down=dstate.h_down))}
    _leaves_equal(got["opt_state"], mine["opt_state"])
    save_checkpoint(t_dir, 3, mine, metadata=meta)
    _same_files(j_dir, t_dir)
    back, _ = j_restore(t_dir, {"params": jp, "opt_state": jopt.init(jp, N)})
    assert back["opt_state"].step.dtype == jnp.int32 and int(back["opt_state"].step) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and _same(a, b)
    assert (JPol.CompressionPolicy.from_json_dict(j_load_metadata(t_dir)["policy"])
            == JPol.as_policy(jspec))


@pytest.mark.parametrize("seed", [3, 0])
def test_elastic_state_mid_churn_continues_bitwise(tmp_path, seed):
    """The JAX test's elastic run (q 0.5, dropout 0.2, min_workers 2, worker
    2 leaves at step 1 and rejoins at step 3), two jitted JAX rounds, saved
    with its policy; the port restores it as ``state_from_jax``, reads the
    spec back from the metadata, and its ``reference_step`` continues step
    2 with the jitted JAX round's bits.  Under the JAX test's key
    (``PRNGKey(3)``) steps 0-2 are all degraded (fewer than 2 participants),
    so the memories stay zero; under ``PRNGKey(0)`` workers 0, 2 and 3
    advance at step 0 and the others after worker 2's leave, whose non-zero
    row stays frozen across the save and the continued step."""
    churn = ((1, 2, "leave"), (3, 2, "join"))
    kw = dict(q=0.5, dropout=0.2, min_workers=2)
    jspec = JSpec(churn=tuple(JChurn(*c) for c in churn), **kw)
    tspec = ParticipationSpec(churn=tuple(ChurnEvent(*c) for c in churn), **kw)
    jcfg = JCfg(method="diana", block_size=16, bucketed=True, participation=jspec)
    tcfg = TCfg(method="diana", block_size=16, bucketed=True, participation=tspec)
    jparams = {"w": jnp.ones((6, 4)) * 0.5, "b": jnp.zeros((10,))}
    tparams = {"w": torch.ones(6, 4) * 0.5, "b": torch.zeros(10)}
    jgrads = jax.tree_util.tree_map(lambda p: jnp.ones((4,) + p.shape) * 0.25, jparams)
    tgrads = {k: torch.ones((4, *v.shape)) * 0.25 for k, v in tparams.items()}
    jround = jax.jit(lambda g, s, k, t: j_ref_step(g, s, k, jcfg, step=t), static_argnums=3)
    key = jax.random.PRNGKey(seed)
    state = j_ref_init(jparams, jcfg, 4)
    for t in range(2):
        _, state = jround(jgrads, state, jax.random.fold_in(key, t), t)
    j_save(str(tmp_path), 2, {"diana": state},
           metadata={"policy": JPol.as_policy(jcfg).to_json_dict()})
    got, step = restore_checkpoint(str(tmp_path), {"diana": reference_init(tparams, tcfg, 4)})
    want = state_from_jax(jax.tree_util.tree_map(np.asarray, state), "cpu")
    assert step == 2
    _leaves_equal(got["diana"], want)
    advanced = (got["diana"].h_worker != 0).any(dim=1).tolist()
    assert advanced == ([False] * 4 if seed == 3 else [True] * 4)
    pol = TPol.CompressionPolicy.from_json_dict(j_load_metadata(str(tmp_path))["policy"])
    assert pol.participation == tspec
    jv, jnew = jround(jgrads, state, jax.random.fold_in(key, 2), 2)
    tv, tnew = reference_step(tgrads, got["diana"], prng.fold_in(prng.PRNGKey(seed), 2), tcfg,
                              step=2)
    for p in tv:
        assert _same(tv[p], jv[p]), p
    _leaves_equal(tnew, state_from_jax(jax.tree_util.tree_map(np.asarray, jnew), "cpu"))
    if seed == 0:   # a step with participants; the departed worker's row frozen
        assert any(bool(v.abs().sum() > 0) for v in tv.values())
        assert _same(tnew.h_worker[2], got["diana"].h_worker[2])
