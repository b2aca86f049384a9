"""VR-DIANA in the port against the JAX package, on the same numpy-seeded
inputs.

* ``prng.uniform``, ``bernoulli`` and ``randint`` are ``jax.random``'s bit
  for bit, at the convex harness's shapes and ranges (the VR coins and the
  minibatch indices of ``run_logreg_stochastic``).
* ``reference_step`` with ``vr=True``, ``vr_p=0.5`` and ``PRNGKey(5)``
  (coins that mix refresh and keep) equals the jitted JAX ``reference_step``
  bit for bit over two steps, for all five operators in both layouts:
  ``v``, ``h_worker``, ``h_server`` and the refreshed (snapshot, mu) rows.
  The inputs lie on the 1/64 grid (``tests/test_convergence_laws.py``'s
  fixture, drawn with numpy): every partial sum of a few of them is exact,
  so identity's mean is too, and natural compression's decoded powers of
  two stay within 2^-12 .. 2^12, where the JAX package's CPU ``exp2`` is
  exact (``tests/test_torch_natural.py`` holds the rest of its range).
* VR does not move a compression draw, and the ``VarianceReducer`` facade
  is the free functions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vr as jvr
from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro_torch.core import prng, vr as tvr
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import reference_init as t_init, reference_step as t_step

N = 4
KEY_SEED = 5  # PRNGKey(5): the vr_p = 0.5 coins mix refresh and keep
OPERATORS = [("diana", dict(block_size=16)), ("natural", {}), ("randk", dict(k=8)),
             ("topk_ef", dict(k=8)), ("none", {})]
SHAPES = {"b": (9,), "w": (12, 5)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test process (the suite runs several pytest
    workers on one CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape, scale=64):
    return (np.round(rng.standard_normal(shape) * scale) / scale).astype(np.float32)


def vr_fixture(seed=0, n=N):
    """params, then stacked grads, snapshots, mu, grads at the snapshots and
    mu candidates, and a second step's grads."""
    rng = np.random.default_rng(seed)
    params = {p: _grid(rng, s) for p, s in SHAPES.items()}
    stacked = [{p: _grid(rng, (n, *s)) for p, s in SHAPES.items()} for _ in range(6)]
    return params, stacked


def _t(tree):
    return {p: torch.from_numpy(np.array(v)) for p, v in tree.items()}


def _j(tree):
    return {p: jnp.asarray(v) for p, v in tree.items()}


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), (what, float(np.abs(a - b).max()))


def _same_tree(t, j, what):
    if isinstance(j, dict):
        for p in j:
            _same(t[p].numpy(), j[p], f"{what}/{p}")
    else:
        _same(t.numpy(), j, what)


def _run_both(method, kw, bucketed, steps=2, force=False, zero_cv=False):
    """Two VR steps of both references from the same state; returns the
    per-step (JAX v, state, port v, state)."""
    params, (grads, snap, mu, g_snap, mu_cand, grads2) = vr_fixture()
    if zero_cv:
        g_snap = mu = {p: np.zeros_like(v) for p, v in grads.items()}
    jcfg = JCfg(method=method, p=math.inf, vr=True, vr_p=0.5, bucketed=bucketed,
                use_kernel=False, **kw)
    tcfg = TCfg(method=method, p=math.inf, vr=True, vr_p=0.5, bucketed=bucketed, **kw)
    js = j_init(_j(params), jcfg, N)
    js = js._replace(vr=js.vr._replace(snapshot=_j(snap), mu=_j(mu)))
    ts = t_init(_t(params), tcfg, N)
    ts = ts._replace(vr=tvr.VRState(snapshot=_t(snap), mu=_t(mu)))
    jstep = jax.jit(lambda g, s, k, a, b, x: j_step(g, s, k, jcfg, vr_aux=(a, b), params=x,
                                                    vr_force_refresh=force))
    out = []
    for s, g in enumerate((grads, grads2)[:steps]):
        jk = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), s)
        tk = prng.fold_in(prng.PRNGKey(KEY_SEED), s)
        jv, js = jstep(_j(g), js, jk, _j(g_snap), _j(mu_cand), _j(params))
        tv, ts = t_step(_t(g), ts, tk, tcfg, vr_aux=(_t(g_snap), _t(mu_cand)),
                        params=_t(params), vr_force_refresh=force)
        out.append((jv, js, tv, ts))
    return out


def _assert_vr_step_equal(jv, js, tv, ts):
    _same_tree(tv, jv, "v")
    _same_tree(ts.h_worker, js.h_worker, "h_worker")
    _same_tree(ts.h_server, js.h_server, "h_server")
    _same_tree(ts.vr.snapshot, js.vr.snapshot, "snapshot")
    _same_tree(ts.vr.mu, js.vr.mu, "mu")


# ------------------------------------------------------------------ draws

KEYS = [(0, 0), (5, 3), (12345, 0x534A), (2**31 - 1, 7)]


@pytest.mark.parametrize("seed,fold", KEYS)
@pytest.mark.parametrize("shape", [(), (4,), (10, 1), (4, 8)])
def test_uniform_bitwise(seed, fold, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    tk = prng.fold_in(prng.PRNGKey(seed), fold)
    _same(prng.uniform(tk, shape).numpy(), jax.random.uniform(jk, shape), shape)


@pytest.mark.parametrize("seed,fold", KEYS)
@pytest.mark.parametrize("p", [0.5, 1 / 32, 1 / 812, 1 / 3, 1.0])
def test_bernoulli_bitwise(seed, fold, p):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    tk = prng.fold_in(prng.PRNGKey(seed), fold)
    for shape in ((), (N,), (3, 5)):
        _same(prng.bernoulli(tk, p, shape).numpy(), jax.random.bernoulli(jk, p, shape),
              (p, shape))


@pytest.mark.parametrize("seed,fold", KEYS)
@pytest.mark.parametrize("shape,lo,hi", [((4, 1), 0, 32), ((10, 1), 0, 812), ((4, 3), 0, 32),
                                         ((3, 5), -7, 100), ((6,), 0, 70000),
                                         ((5,), 0, 2**31 - 1), ((2,), 5, 5)])
def test_randint_bitwise(seed, fold, shape, lo, hi):
    """``jax.random.randint``'s int32 draws, including spans above 2^16
    (the multiplier's square wraps) and an empty range (always ``minval``)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    tk = prng.fold_in(prng.PRNGKey(seed), fold)
    got = prng.randint(tk, shape, lo, hi).numpy()
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    assert np.array_equal(got, want.astype(np.int64)), (got, want)


def test_coins_bitwise():
    """``vr_coin`` / ``reference_coins`` are the JAX package's coins, and
    ``PRNGKey(5)``'s coins at p = 0.5 mix refresh and keep."""
    for s in range(3):
        jk = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), s)
        tk = prng.fold_in(prng.PRNGKey(KEY_SEED), s)
        want = np.asarray(jvr.reference_coins(jk, 0.5, N))
        assert np.array_equal(tvr.reference_coins(tk, 0.5, N).numpy(), want)
        for w in range(N):
            assert tvr.vr_coin(prng.fold_in(tk, w), 0.5) == bool(want[w])
    first = tvr.reference_coins(prng.fold_in(prng.PRNGKey(KEY_SEED), 0), 0.5, N)
    assert 0 < int(first.sum()) < N


# ------------------------------------------------------- reference_step


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
@pytest.mark.parametrize("method,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_vr_reference_step_bitwise_jax(method, kw, bucketed):
    for jv, js, tv, ts in _run_both(method, kw, bucketed):
        _assert_vr_step_equal(jv, js, tv, ts)


def test_vr_force_refresh_bitwise_jax():
    """``vr_force_refresh`` refreshes every row (the trainer's step 0)."""
    for jv, js, tv, ts in _run_both("diana", dict(block_size=16), True, steps=1, force=True):
        _assert_vr_step_equal(jv, js, tv, ts)
        params = vr_fixture()[0]
        for p, x in params.items():
            assert all(torch.equal(ts.vr.snapshot[p][w], torch.from_numpy(x)) for w in range(N))


@pytest.mark.parametrize("method,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_vr_port_bucketed_equals_perleaf(method, kw):
    """Inside the port: the VR composition precedes the layout, so both
    layouts give the same v and (snapshot, mu), bit for bit."""
    pl = _run_both(method, kw, False)
    bk = _run_both(method, kw, True)
    for (_, _, tvp, tsp), (_, _, tvb, tsb) in zip(pl, bk):
        for p in tvp:
            assert torch.equal(tvp[p], tvb[p])
            assert torch.equal(tsp.vr.mu[p], tsb.vr.mu[p])
            assert torch.equal(tsp.vr.snapshot[p], tsb.vr.snapshot[p])


def test_vr_does_not_perturb_compression_draws():
    """A VR run whose control variate is the identity (g_snap = mu = 0) moves
    the memories exactly as the plain DIANA run on the same grads: VR_FOLD
    is folded into no compression key."""
    params, (grads, *_rest) = vr_fixture()
    cfg = TCfg(method="diana", p=math.inf, block_size=16)
    key = prng.fold_in(prng.PRNGKey(KEY_SEED), 0)   # _run_both's first step key
    v0, s0 = t_step(_t(grads), t_init(_t(params), cfg, N), key, cfg)
    (_, _, v1, s1), = _run_both("diana", dict(block_size=16), False, steps=1, zero_cv=True)
    for p in v0:
        assert torch.equal(v0[p], v1[p])
        assert torch.equal(s0.h_worker[p], s1.h_worker[p])
        assert torch.equal(s0.h_server[p], s1.h_server[p])


def test_variance_reducer_facade():
    """The facade is the free functions: the same coins (JAX's), control
    variates and refreshes, the paper's 1/m default, p in (0, 1]."""
    red = tvr.VarianceReducer.for_finite_sum(32)
    assert red.p == pytest.approx(1 / 32)
    with pytest.raises(ValueError):
        tvr.VarianceReducer(0.0)
    assert tvr.resolve_vr_p(0.25, 32) == 0.25
    red = tvr.VarianceReducer(0.5)
    key = prng.PRNGKey(KEY_SEED)
    coins = red.coins(key, N)
    assert np.array_equal(coins.numpy(),
                          np.asarray(jvr.reference_coins(jax.random.PRNGKey(KEY_SEED), 0.5, N)))
    assert red.coin(prng.fold_in(key, 2)) == tvr.vr_coin(prng.fold_in(key, 2), 0.5)
    params, (grads, snap, mu, g_snap, mu_cand, _) = vr_fixture()
    jk = _j(grads), _j(g_snap), _j(mu)
    cv = red.control_variate(_t(grads), _t(g_snap), _t(mu))
    _same_tree(cv, jvr.control_variate(*jk), "control_variate")
    state = red.init(_t(params), N, mu=_t(mu))
    jstate = jvr.init_vr(_j(params), N, mu=_j(mu))
    _same_tree(state.snapshot, jstate.snapshot, "init snapshot")
    new = red.refresh(state, coins, _t(params), _t(mu_cand))
    jnew = jvr.refresh(jstate, jnp.asarray(coins.numpy()), _j(params), _j(mu_cand))
    _same_tree(new.mu, jnew.mu, "refresh mu")
    _same_tree(new.snapshot, jnew.snapshot, "refresh snapshot")
    # no coin set: the state comes back as it is
    assert red.refresh(state, torch.zeros(N, dtype=torch.bool), _t(params), _t(mu_cand)) is state


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
def test_state_from_jax_carries_vr_and_h_down(bucketed):
    """A JAX ReferenceState with the VR slot and a downlink memory, converted
    after one step (``convert.state_from_jax``) and stepped by the port,
    equals the JAX package's next step bit for bit."""
    from repro_torch.convert import state_from_jax

    params, (grads, snap, mu, g_snap, mu_cand, grads2) = vr_fixture(seed=2)
    common = dict(method="diana", p=math.inf, block_size=16, vr=True, vr_p=0.5,
                  bucketed=bucketed, down_method="diana")
    jcfg, tcfg = JCfg(use_kernel=False, **common), TCfg(**common)
    jstep = jax.jit(lambda g, s, k, a, b, x: j_step(g, s, k, jcfg, vr_aux=(a, b), params=x))
    js = j_init(_j(params), jcfg, N)
    js = js._replace(vr=js.vr._replace(snapshot=_j(snap), mu=_j(mu)))
    aux = (_j(g_snap), _j(mu_cand), _j(params))
    _, js = jstep(_j(grads), js, jax.random.PRNGKey(1), *aux)
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    jv, js = jstep(_j(grads2), js, jax.random.PRNGKey(2), *aux)
    tv, ts = t_step(_t(grads2), ts, prng.PRNGKey(2), tcfg, vr_aux=(_t(g_snap), _t(mu_cand)),
                    params=_t(params))
    _assert_vr_step_equal(jv, js, tv, ts)
    _same_tree(ts.h_down, js.h_down, "h_down")
