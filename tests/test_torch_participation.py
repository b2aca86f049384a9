"""Elastic participation and the checksummed wire in the port
(``repro_torch.core.participation`` and the wire checksum of
``repro_torch.core.bucket``) against the JAX package.

* The spec's validation, ``is_trivial`` and JSON (the JAX dict, both ways,
  also on a policy); ``parse_faults``.
* ``participation_mask``, ``presence``, ``reinit_rows``, ``direction_scale``
  and the step context bit for bit the JAX functions for n = 1-8, several
  keys and steps, both rescale rules, with and without a deadline; the
  deadline's Exp(1) latencies within 1 ulp (torch's ``log1p`` and XLA's may
  differ in the last place), and the masks equal on those keys.
* The checksum words and the wire bytes bit for bit the JAX package's; the
  position rule past 2^32 against pure Python; every single-bit flip
  caught; ``apply_faults`` (corrupt / drop / delay) bit for bit;
  ``policy_bits_per_dim``'s checksum term.
* The port's elastic ``reference_step`` under faults: a corrupted wire
  equals its worker's churn leave, an empty plan is a bitwise no-op, a drop
  or a delay excludes for exactly its steps, and the faults need the flat
  bucketed layout.  ``tests/test_torch_elastic_reference.py`` holds the
  elastic ``reference_step`` to the jitted JAX one, on these inputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucket as JB
from repro.core import participation as JP
from repro.core import policy as JPol
from repro_torch.core import bucket as TB
from repro_torch.core import participation as TP
from repro_torch.core import policy as TPol
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import reference_init as t_init, reference_step as t_step

N = 4
STEPS = 4
OPERATORS = [("diana", dict(block_size=16)), ("natural", {}), ("randk", dict(k=8)),
             ("topk_ef", dict(k=8)), ("none", {})]
SHAPES = {"b": (9,), "w": (12, 5)}
CHURN = ((1, 3, "leave"), (3, 3, "join"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape, scale=64):
    return (np.round(rng.standard_normal(shape) * scale) / scale).astype(np.float32)


def _inputs(seed=0):
    """params, per-step stacked grads, VR's snapshots / mu and per-step
    snapshot gradients and mu candidates, on the 1/64 grid."""
    rng = np.random.default_rng(seed)
    params = {p: _grid(rng, s) for p, s in SHAPES.items()}
    stacked = lambda: {p: _grid(rng, (N, *s)) for p, s in SHAPES.items()}  # noqa: E731
    return dict(params=params, grads=[stacked() for _ in range(STEPS)], snap=stacked(),
                mu=stacked(), gsnap=[stacked() for _ in range(STEPS)],
                mucand=[stacked() for _ in range(STEPS)])


def _t(tree):
    return {p: torch.from_numpy(np.array(v)) for p, v in tree.items()}


def _j(tree):
    return {p: jnp.asarray(v) for p, v in tree.items()}


def _same(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, float(np.abs(a.astype(np.float64) - b).max()))


def _same_state(t, j, what):
    if isinstance(j, dict):
        assert sorted(t) == sorted(j), (what, sorted(t), sorted(j))
        for k in j:
            _same_state(t[k], j[k], f"{what}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), what
        for i, (a, b) in enumerate(zip(t, j)):
            _same_state(a, b, f"{what}[{i}]")
    else:
        _same(t, j, what)


def _specs(**kw):
    """The same spec in both packages."""
    churn = kw.pop("churn", ())
    return (JP.ParticipationSpec(churn=tuple(JP.ChurnEvent(*c) for c in churn), **kw),
            TP.ParticipationSpec(churn=tuple(TP.ChurnEvent(*c) for c in churn), **kw))


def _plans(*events):
    return (JP.FaultPlan(tuple(JP.FaultEvent(**e) for e in events)),
            TP.FaultPlan(tuple(TP.FaultEvent(**e) for e in events)))


def _keys(seed, s):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), s),
            prng.fold_in(prng.PRNGKey(seed), s))


# ------------------------------------------------------------------ the spec


def test_spec_validation_json_and_triviality():
    for kw in (dict(q=0.0), dict(q=1.5), dict(dropout=1.0), dict(dropout=-0.1),
               dict(deadline=0.0), dict(min_workers=0), dict(rescale="mean")):
        with pytest.raises(ValueError):
            JP.ParticipationSpec(**kw)
        with pytest.raises(ValueError):
            TP.ParticipationSpec(**kw)
    for bad in (dict(step=0, worker=0, kind="pause"), dict(step=-1, worker=0, kind="leave")):
        with pytest.raises(ValueError):
            TP.ChurnEvent(**bad)
    for kw in (dict(), dict(q=0.5), dict(dropout=0.25, min_workers=3, rescale="expected"),
               dict(q=0.75, deadline=1.5, churn=((4, 2, "join"), (1, 2, "leave"))),
               dict(churn=((0, 1, "leave"),))):
        js, ts = _specs(**kw)
        assert ts.is_trivial == js.is_trivial
        assert ts.to_json_dict() == js.to_json_dict()
        assert TP.ParticipationSpec.from_json_dict(js.to_json_dict()) == ts
        assert JP.ParticipationSpec.from_json_dict(ts.to_json_dict()) == js
        assert TP.expected_rate(ts) == JP.expected_rate(js)
        # on a policy's JSON document (the JAX-only worker_axes aside)
        jpol = JPol.CompressionPolicy(bucketed=True, participation=js)
        tpol = TPol.CompressionPolicy(bucketed=True, participation=ts)
        jd = jpol.to_json_dict()
        jd.pop("worker_axes")
        assert tpol.to_json_dict() == jd
        assert TPol.CompressionPolicy.from_json(jpol.to_json()).participation == ts
        assert tpol.flat_config().participation == ts
        flat = tpol.flat_config()
        assert TPol.CompressionPolicy.uniform(flat).flat_config() == flat
    with pytest.raises(TypeError, match="participation"):
        TCfg(participation=object())
    with pytest.raises(TypeError, match="participation"):
        TPol.CompressionPolicy(participation=object())
    assert TCfg(down_method="diana", participation=_specs(q=0.5)[1]).down_config() \
        .participation is None


def test_parse_faults_as_jax():
    for text in (None, "", "checksum", "corrupt:step=3,worker=1,byte=7;drop:step=5,worker=2",
                 "delay:step=6,worker=0,delay=2", "corrupt:step=0,worker=3,bits=0x10;",
                 " drop:step=1,worker=1 ; corrupt:step=2,worker=0,byte=0x1f "):
        jp, tp = JP.parse_faults(text), TP.parse_faults(text)
        if jp is None:
            assert tp is None
            continue
        assert [vars(e) for e in tp.events] == [vars(e) for e in jp.events]
    for bad in ("explode:step=1,worker=0", "corrupt:step=1,worker=0,bits=0",
                "delay:step=1,worker=0,delay=0"):
        with pytest.raises(ValueError):
            JP.parse_faults(bad)
        with pytest.raises(ValueError):
            TP.parse_faults(bad)


# ------------------------------------------------------------------ the masks

RULES = [dict(q=0.5), dict(q=0.7, dropout=0.2, churn=CHURN, min_workers=2),
         dict(q=0.6, rescale="expected"), dict(q=0.9, dropout=0.1, deadline=1.25),
         dict(dropout=0.3, deadline=0.5, churn=((0, 0, "leave"), (2, 0, "join")),
              rescale="expected", min_workers=3)]


@pytest.mark.parametrize("rule", range(len(RULES)))
def test_masks_and_scales_bitwise_jax(rule):
    js, ts = _specs(**RULES[rule])
    for seed in (0, 12345):
        for s in range(STEPS):
            jk, tk = _keys(seed, s)
            jpk, tpk = jax.random.fold_in(jk, JP.PART_FOLD), prng.fold_in(tk, TP.PART_FOLD)
            for n in (1, 2, 3, 4, 5, 8):
                jc, tc = JP.step_ctx(js, jpk, n, s), TP.step_ctx(ts, tpk, n, s)
                _same(tc.mask, jc.mask, ("mask", seed, s, n))
                _same(TP.participation_mask(ts, tpk, n, s), jc.mask, ("mask", seed, s, n))
                _same(tc.reinit, jc.reinit, ("reinit", s, n))
                _same(TP.presence(ts, s, n), JP.presence(js, s, n), ("presence", s, n))
                assert tc.ok == bool(jc.ok)
                _same(tc.dir_scale, jc.dir_scale, ("scale", seed, s, n))
                own = TP.step_ctx(ts, tpk, n, s, worker_index=n - 1)
                assert own.m_own == bool(jc.mask[n - 1]) and own.widx == n - 1
            _same(TP.direction_scale(ts, tc.mask, False),
                  JP.direction_scale(js, jc.mask, jnp.asarray(False)), "degraded scale")
            if js.deadline is not None:
                for i in range(8):
                    jl = jax.random.exponential(
                        jax.random.split(jax.random.fold_in(jpk, i), 3)[2])
                    tl = TP.latency(tpk, i)
                    assert abs(int(tl.view(torch.int32)) - int(np.asarray(jl).view(np.int32))) \
                        <= 1, (seed, s, i, float(tl), float(jl))


def test_exponential_within_one_ulp():
    for seed in range(20):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for shape in ((), (64,)):
            a = prng.exponential(tk, shape).numpy().view(np.int32).astype(np.int64)
            b = np.asarray(jax.random.exponential(jk, shape)).view(np.int32).astype(np.int64)
            assert np.abs(a - b).max() <= 1


# -------------------------------------------------------------- the checksum


def _py_words(data: bytes, pos0=0):
    s1 = sum(data) & 0xFFFFFFFF
    s2 = sum(b * ((pos0 + j) & 0xFFFFFFFF) for j, b in enumerate(data, 1)) & 0xFFFFFFFF
    return s1, s2


def test_checksum_bitwise_jax():
    rng = np.random.default_rng(1)
    for shape in ((1,), (7,), (3, 1000), (2, 4, 333), (5000,)):
        b = rng.integers(0, 256, shape, dtype=np.uint8)
        want = np.asarray(JB._checksum_words(jnp.asarray(b)))
        for chunk in (1, 7, 64, 1 << 24):
            got = TB.checksum_words(torch.from_numpy(b), chunk=chunk)
            got = np.array(got if len(shape) > 1 else [got]).reshape(want.shape)
            assert (got == want).all(), (shape, chunk)
        if len(shape) == 2:
            jw = np.asarray(JB.add_checksum(jnp.asarray(b)))
            tw = TB.add_checksum(torch.from_numpy(b))
            _same(tw, jw, ("wire", shape))
            assert len(jw) == b.size + TB.CHECKSUM_BYTES == b.size + JB.CHECKSUM_BYTES
            flat, ok = TB.verify_checksum(torch.stack([tw, tw]))
            assert ok.tolist() == [True, True] and flat.shape == (2, b.size)


def test_checksum_positions_wrap_past_2_32():
    """A wire past 2^32 bytes wraps its positions: the rule on a short buffer
    whose positions start just below 2^32, against pure Python."""
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 3000, dtype=np.uint8)
    for pos0 in (0, 2**32 - 1000, 2**32 - 1, 2**33 + 5):
        for chunk in (64, 1000, 1 << 24):
            got = TB.checksum_words(torch.from_numpy(data), chunk=chunk, pos0=pos0)
            assert got == _py_words(data.tobytes(), pos0), (pos0, chunk)


def test_single_bit_flip_caught():
    rng = np.random.default_rng(3)
    wire = TB.add_checksum(torch.from_numpy(rng.integers(0, 256, (8, 16), dtype=np.uint8)))
    for pos in (0, 1, 63, 127, wire.numel() - 8, wire.numel() - 1):
        for bit in range(8):
            w = wire.clone()
            w[pos] ^= 1 << bit
            assert not bool(TB.verify_checksum(w)[1]), (pos, bit)
    assert bool(TB.verify_checksum(wire)[1])


def test_apply_faults_bitwise_jax():
    rng = np.random.default_rng(4)
    wire = rng.integers(0, 256, 200 + TB.CHECKSUM_BYTES, dtype=np.uint8)
    jplan, tplan = _plans(dict(step=1, worker=2, kind="corrupt", byte=7),
                          dict(step=1, worker=2, kind="corrupt", byte=207, bits=0x21),
                          dict(step=2, worker=0, kind="drop"),
                          dict(step=3, worker=1, kind="delay", delay=2),
                          dict(step=3, worker=2, kind="corrupt", byte=7, bits=0x0F))
    for step in range(6):
        for w in range(4):
            want = np.asarray(JP.apply_faults(jnp.asarray(wire), jplan, step, w))
            got = TP.apply_faults(torch.from_numpy(wire.copy()), tplan, step, w)
            _same(got, want, (step, w))
    assert TB.checksum_tail_bits_per_dim(TB.BucketLayout.for_tree({"a": torch.zeros(64)})) \
        == JB.checksum_tail_bits_per_dim(JB.BucketLayout.for_tree({"a": jnp.zeros(64)}))


# ------------------------------------------------------------------- faults

POLICY = "^b$=identity,*=diana:block=16/topk_ef:k=8"
SPEC = dict(q=0.7, dropout=0.2, churn=CHURN, min_workers=2)


@pytest.mark.parametrize("method,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_corrupt_equals_churn_leave(method, kw):
    """A corrupted wire is its worker's leave: step 0 with a corrupt on
    worker 1 equals step 0 with worker 1 gone (ghat, h_server, the other
    rows); the rows of the fault run are the leave run's, worker 1's
    frozen."""
    _, tplan = _plans(dict(step=0, worker=1, kind="corrupt"))
    d = _inputs()
    g = _t(d["grads"][0])
    key = _keys(5, 0)[1]
    cfg = TCfg(method=method, p=math.inf, bucketed=True, **kw)
    leave = TCfg(method=method, p=math.inf, bucketed=True,
                 participation=TP.ParticipationSpec(churn=(TP.ChurnEvent(0, 1, "leave"),)),
                 **kw)
    vf, sf = t_step(g, t_init(_t(d["params"]), cfg, N), key, cfg, step=0, faults=tplan)
    vc, sc = t_step(g, t_init(_t(d["params"]), leave, N), key, leave, step=0)
    for p in vf:
        assert torch.equal(vf[p], vc[p]), p
    assert torch.equal(sf.h_server, sc.h_server) and torch.equal(sf.h_worker, sc.h_worker)
    assert not sf.h_worker[1].any()


@pytest.mark.parametrize("method,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_empty_plan_is_a_bitwise_noop(method, kw):
    """The checksum alone (``--faults checksum``) changes nothing: two
    rounds equal the plain round's bit for bit (n = 4, so the masked
    tail's ``total * 1/4`` is the plain mean)."""
    d = _inputs()
    cfg = TCfg(method=method, p=math.inf, bucketed=True, **kw)
    s0 = s1 = t_init(_t(d["params"]), cfg, N)
    for s in range(2):
        key = _keys(5, s)[1]
        v0, s0 = t_step(_t(d["grads"][s]), s0, key, cfg)
        v1, s1 = t_step(_t(d["grads"][s]), s1, key, cfg, step=s, faults=TP.FaultPlan())
        for p in v0:
            assert torch.equal(v0[p], v1[p]), (s, p)
        assert torch.equal(s0.h_worker, s1.h_worker) and torch.equal(s0.h_server, s1.h_server)


def test_drop_and_delay_exclude_for_their_steps():
    """A delay of worker 2 over steps 1-2: perturbing its gradient inside
    that window leaves the whole 4-step trajectory unchanged (its row is
    frozen and its payload excluded); outside the window it is not."""
    _, tplan = _plans(dict(step=1, worker=2, kind="delay", delay=2),
                      dict(step=3, worker=0, kind="drop"))
    d = _inputs()
    cfg = TCfg(method="diana", p=math.inf, bucketed=True, block_size=16)
    sa = sb = t_init(_t(d["params"]), cfg, N)
    for t in range(STEPS):
        ga = _t(d["grads"][t])
        gb = dict(ga)
        if t in (1, 2):
            gb["w"] = gb["w"].clone()
            gb["w"][2] += 1000.0
        if t == 3:
            gb["w"] = gb["w"].clone()
            gb["w"][0] -= 1000.0
        key = _keys(5, t)[1]
        va, sa = t_step(ga, sa, key, cfg, step=t, faults=tplan)
        vb, sb = t_step(gb, sb, key, cfg, step=t, faults=tplan)
        for p in va:
            assert torch.equal(va[p], vb[p]), (t, p)
        assert torch.equal(sa.h_worker, sb.h_worker) and torch.equal(sa.h_server, sb.h_server)


def test_faults_need_the_flat_bucketed_layout():
    d = _inputs()
    g, key = _t(d["grads"][0]), _keys(5, 0)[1]
    perleaf = TCfg(method="diana", bucketed=False, block_size=16)
    with pytest.raises(ValueError, match="bucketed"):
        t_step(g, t_init(_t(d["params"]), perleaf, N), key, perleaf, step=0,
               faults=TP.FaultPlan())
    pol = TPol.CompressionPolicy(rules=TPol.parse_rules(POLICY), bucketed=True)
    with pytest.raises(ValueError, match="bucketed"):
        t_step(g, t_init(_t(d["params"]), pol, N), key, pol, step=0, faults=TP.FaultPlan())
    churn = TCfg(method="diana", bucketed=True, block_size=16,
                 participation=TP.ParticipationSpec(churn=(TP.ChurnEvent(1, 0, "leave"),)))
    with pytest.raises(ValueError, match="step"):
        t_step(g, t_init(_t(d["params"]), churn, N), key, churn)


def test_policy_bits_per_dim_checksum_term():
    tree_j = {p: jnp.zeros(s) for p, s in SHAPES.items()}
    tree_t = {p: torch.zeros(s) for p, s in SHAPES.items()}
    for bucketed in (True, False):
        jpol = JPol.CompressionPolicy(rules=JPol.parse_rules(POLICY), bucketed=bucketed)
        tpol = TPol.CompressionPolicy(rules=TPol.parse_rules(POLICY), bucketed=bucketed)
        for checksum in (False, True):
            assert TPol.policy_bits_per_dim(tpol, tree_t, checksum=checksum) == \
                JPol.policy_bits_per_dim(jpol, tree_j, checksum=checksum)
