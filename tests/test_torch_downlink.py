"""The compressed downlink (bidirectional DIANA) in the port against the JAX
package's jitted ``reference_step``, on the same numpy-seeded inputs
(``tests/test_downlink.py``'s contracts):

* each of the five operators as ``down_method`` (the uplink ``diana``),
  in both layouts, over two steps: ``v``, ``h_worker``, ``h_server`` and
  ``h_down`` bit for bit;
* the mixed pairings (a bucketed uplink with a per-leaf downlink, and the
  reverse) bit for bit, and equal to the pure per-leaf run;
* the identity downlink is an exact no-op; the downlink's fold moves no
  uplink draw; the downlink compresses the f32 ``ghat`` before the cast to
  bf16 gradients' dtype (``aggregate_distributed`` in a one-rank gloo group
  against the JAX reference fed the same values in f32).

Inputs on the 1/64 grid, as in ``tests/test_torch_vr.py`` (identity's mean
exact, natural's decoded powers of two inside the range where the JAX
package's CPU ``exp2`` is exact).
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import (DOWN_FOLD, aggregate_distributed, bucket_layout,
                                    init_state, reference_init as t_init,
                                    reference_step as t_step)

N = 4
KEY_SEED = 7
OPERATORS = [("diana", dict(block_size=16)), ("natural", {}), ("randk", dict(k=8)),
             ("topk_ef", dict(k=8)), ("none", {})]
SHAPES = {"b": (9,), "w": (12, 5)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape, scale=64):
    return (np.round(rng.standard_normal(shape) * scale) / scale).astype(np.float32)


def _fixture(seed=1):
    rng = np.random.default_rng(seed)
    params = {p: _grid(rng, s) for p, s in SHAPES.items()}
    grads = [{p: _grid(rng, (N, *s)) for p, s in SHAPES.items()} for _ in range(3)]
    return params, grads


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), (what, float(np.abs(a - b).max()))


def _same_tree(t, j, what):
    if isinstance(j, dict):
        assert set(t) == set(j), what
        for p in j:
            _same(t[p].numpy(), j[p], f"{what}/{p}")
    else:
        _same(t.numpy(), j, what)


def _key(s):
    return (jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), s),
            prng.fold_in(prng.PRNGKey(KEY_SEED), s))


def _run_port(tcfg, steps=2):
    params, grads = _fixture()
    ts = t_init({p: torch.from_numpy(v) for p, v in params.items()}, tcfg, N)
    out = []
    for s in range(steps):
        tv, ts = t_step({p: torch.from_numpy(v) for p, v in grads[s].items()}, ts, _key(s)[1],
                        tcfg)
        out.append((tv, ts))
    return out


def _run_both(jcfg, tcfg, steps=2):
    params, grads = _fixture()
    js = j_init({p: jnp.asarray(v) for p, v in params.items()}, jcfg, N)
    jstep = jax.jit(lambda g, s, k: j_step(g, s, k, jcfg))
    out = []
    for s, (tv, ts) in enumerate(_run_port(tcfg, steps)):
        jv, js = jstep({p: jnp.asarray(v) for p, v in grads[s].items()}, js, _key(s)[0])
        out.append((jv, js, tv, ts))
    return out


def _configs(down, kw, bucketed=False, down_bucketed=None):
    common = dict(method="diana", p=math.inf, block_size=16, k=8, bucketed=bucketed,
                  down_method=down, down_k=kw.get("k"), down_bucketed=down_bucketed)
    return JCfg(use_kernel=False, **common), TCfg(**common)


def _assert_equal(jv, js, tv, ts):
    _same_tree(tv, jv, "v")
    _same_tree(ts.h_worker, js.h_worker, "h_worker")
    _same_tree(ts.h_server, js.h_server, "h_server")
    _same_tree(ts.h_down, js.h_down, "h_down")


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
@pytest.mark.parametrize("down,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_downlink_reference_step_bitwise_jax(down, kw, bucketed):
    for step in _run_both(*_configs(down, kw, bucketed)):
        _assert_equal(*step)


@pytest.mark.parametrize("up_bucketed,down_bucketed", [(True, False), (False, True)],
                         ids=["bucketed-up/perleaf-down", "perleaf-up/bucketed-down"])
def test_mixed_layout_pairings_bitwise(up_bucketed, down_bucketed):
    """The downlink makes its own layout decision: the mixed pairings equal
    the JAX package's bit for bit, and the pure per-leaf run's ``v``."""
    mixed = _run_both(*_configs("diana", {}, up_bucketed, down_bucketed))
    pure = _run_port(_configs("diana", {})[1])
    for (jv, js, tv, ts), (pv, _) in zip(mixed, pure):
        _assert_equal(jv, js, tv, ts)
        for p in pv:
            assert torch.equal(tv[p], pv[p]), p


@pytest.mark.parametrize("down,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_port_downlink_bucketed_equals_perleaf(down, kw):
    """Inside the port: the downlink's two layouts give the same ``v``, and
    the per-leaf ``h_down`` rows lie in the bucketed ``h_down`` at the
    downlink layout's offsets."""
    jcfg, tcfg = _configs(down, kw)
    pl = _run_port(tcfg)
    bk = _run_port(replace(tcfg, bucketed=True))
    params, _ = _fixture()
    lay = bucket_layout(replace(tcfg.down_config(), bucketed=True),
                        {p: torch.from_numpy(v) for p, v in params.items()})
    for (vp, sp), (vb, sb) in zip(pl, bk):
        for p in vp:
            assert torch.equal(vp[p], vb[p]), p
        for p, off, size in zip(lay.paths, lay.offsets, lay.sizes):
            assert torch.equal(sb.h_down[off:off + size], sp.h_down[p]), p


def test_identity_downlink_is_exact_noop():
    """``down_method='none'`` adds an inert ``h_down`` and moves no bit of
    the trajectory; without a downlink the state has no ``h_down``."""
    base = TCfg(method="diana", p=math.inf, block_size=16)
    plain = _run_port(base, steps=3)
    ident = _run_port(replace(base, down_method="none"), steps=3)
    for (v0, s0), (v1, s1) in zip(plain, ident):
        assert s0.h_down is None and s0.vr is None
        for p in v0:
            assert torch.equal(v0[p], v1[p])
        assert all(not bool(h.any()) for h in s1.h_down.values())


def test_downlink_fold_does_not_perturb_uplink_draws():
    """With a downlink ``ghat`` changes (it is compressed), but the uplink
    memories, a function of the uplink draws alone, stay the same bits."""
    base = TCfg(method="diana", p=math.inf, block_size=16)
    for (_, s0), (_, s1) in zip(_run_port(base), _run_port(replace(base, down_method="diana"))):
        for p in s0.h_worker:
            assert torch.equal(s0.h_worker[p], s1.h_worker[p])
            assert torch.equal(s0.h_server[p], s1.h_server[p])


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
def test_bf16_gradients_downlink_matches_f32_reference_bitwise(world_of_one, bucketed):
    """bf16 local gradients through ``aggregate_distributed`` (one rank):
    the downlink compresses the f32 ``ghat`` and the cast to bf16 comes
    after it, so ``h_down`` equals the JAX reference fed the same values in
    f32 bit for bit, and ``ghat`` is its ``v`` rounded to bf16."""
    rng = np.random.default_rng(3)
    g32 = {p: (_grid(rng, s, scale=8) / 4) for p, s in SHAPES.items()}   # exact in bf16
    jcfg, tcfg = _configs("diana", {}, bucketed)
    jkey, tkey = _key(0)
    params = {p: jnp.zeros(s, jnp.float32) for p, s in SHAPES.items()}
    jv, js = jax.jit(lambda g, s, k: j_step(g, s, k, jcfg))(
        {p: jnp.asarray(v)[None] for p, v in g32.items()}, j_init(params, jcfg, 1), jkey)
    g16 = {p: torch.from_numpy(v).to(torch.bfloat16) for p, v in g32.items()}
    state = init_state({p: torch.zeros(s) for p, s in SHAPES.items()}, tcfg, 1)
    ghat, new = aggregate_distributed(g16, state, prng.fold_in(tkey, 0), tcfg,
                                      down_key=prng.fold_in(tkey, DOWN_FOLD))
    _same_tree(new.h_down, js.h_down, "h_down")
    for p, v in jv.items():
        assert ghat[p].dtype == torch.bfloat16
        assert torch.equal(ghat[p], torch.from_numpy(np.array(v)).to(torch.bfloat16)), p
    with pytest.raises(ValueError, match="down_key"):
        aggregate_distributed(g16, state, prng.fold_in(tkey, 0), tcfg)
