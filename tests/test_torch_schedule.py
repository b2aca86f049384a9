"""The chunked and hierarchical wire schedule of the port
(``repro_torch.core.bucket.ChunkedSchedule``, the schedule's rounds in
``repro_torch.core.diana.reference_step``) against the JAX package.

* ``ChunkedSchedule``'s bounds, chunk offsets and sizes, the rebased chunk
  layouts and the key slices equal the JAX package's over a seeded sweep of
  leaf sizes, alignments and chunk sizes that do not divide the buffer,
  ``chunk_bytes`` 0 and larger than the buffer; ``split`` gives views.
* ``checksum_tail_bits_per_dim`` and ``policy_bits_per_dim(checksum=True)``
  count one tail per chunk, as the JAX package's.
* The chunked ``reference_step`` (``chunk_bytes`` 300: at least three uneven
  whole-leaf chunks for every operator's alignment, the JAX suite's tree)
  bit for bit the jitted JAX round, all five operators on the 1/64 grid:
  plain; with VR and the operator as its own downlink (the chunked
  broadcast); under participation with a fault plan (a corrupt in the
  middle of a chunk, a drop); under a grouped policy.  Inside the port the
  chunked round equals the monolithic one, and a corrupt in the middle of a
  chunk equals its worker's churn leave.
* Hierarchical: ``node_size`` 1 equals the flat round; ``node_size`` 2 at
  n = 4 is bitwise the jitted JAX round, chunked and not, all five
  operators, node rows duplicated; ``node_size`` 3 at n = 6 is bitwise too:
  the jitted reference divides the node sum as ``acc * f32(1/3)`` (XLA's
  rewrite of a division by a constant), and so does the port
  (``diana._node_scale``; with IEEE ``acc / 3`` the step-0 ``v`` was already
  1 ulp off); the gates refuse what the JAX package refuses.
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucket as JB
from repro.core import policy as JPol
from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro.core.vr import VRState as JVRState
from repro_torch.core import bucket as TB
from repro_torch.core import policy as TPol
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import (_chunk_payloads, bucket_layout, reference_init as t_init,
                                    reference_step as t_step)
from repro_torch.core.participation import ChurnEvent, FaultEvent, FaultPlan, ParticipationSpec
from repro_torch.core.vr import VRState
from test_torch_participation import SPEC, _j, _one_torch_thread, _plans, _same_state, _specs, _t

__all__ = ["_one_torch_thread"]   # the autouse fixture, imported to apply here

N = 4
CHUNK = 300
SHAPES = {"emb": (24, 16), "w1": (20, 13), "b1": (160,), "w2": (9, 31), "b2": (70,), "s": ()}
OPERATORS = [("diana", dict(block_size=16)), ("natural", {}), ("randk", dict(k=9)),
             ("topk_ef", dict(k=9)), ("none", {})]
OP_IDS = [m for m, _ in OPERATORS]
POLICY = "^b1$=identity,w.*=diana:block=16/topk_ef:k=8,*=randk:k=9"


def _grid(rng, shape, scale=64):
    return (np.round(rng.standard_normal(shape) * scale) / scale).astype(np.float32)


def _inputs(n=N, steps=2, seed=0):
    rng = np.random.default_rng(seed)
    stacked = lambda: {p: _grid(rng, (n, *s)) for p, s in SHAPES.items()}  # noqa: E731
    return dict(params={p: _grid(rng, s) for p, s in SHAPES.items()},
                grads=[stacked() for _ in range(steps)], snap=stacked(), mu=stacked(),
                gsnap=[stacked() for _ in range(steps)], mucand=[stacked() for _ in range(steps)])


def _keys(seed, s):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), s),
            prng.fold_in(prng.PRNGKey(seed), s))


def _run(jcfg, tcfg, *, n=N, steps=2, seed=3, vr=False, faults=(None, None), jax_side=True):
    """``steps`` rounds of the jitted JAX reference (when ``jax_side``) and
    the port's from zero memories; per step ``(JAX v, state, port v,
    state)``."""
    d = _inputs(n, steps)
    ts = t_init(_t(d["params"]), tcfg, n)
    js = j_init(_j(d["params"]), jcfg, n) if jax_side else None
    if vr:
        ts = ts._replace(vr=VRState(snapshot=_t(d["snap"]), mu=_t(d["mu"])))
        if jax_side:
            js = js._replace(vr=JVRState(snapshot=_j(d["snap"]), mu=_j(d["mu"])))
    jf, tf = faults
    elastic = tcfg.participation is not None or tf is not None

    def jfn(g, s, k, st, aux):
        kw = {} if aux is None else dict(vr_aux=aux, params=_j(d["params"]))
        if elastic:
            kw.update(step=st, faults=jf)
        return j_step(g, s, k, jcfg, **kw)
    jstep = jax.jit(jfn)
    out = []
    for s in range(steps):
        jk, tk = _keys(seed, s)
        taux = None if not vr else (_t(d["gsnap"][s]), _t(d["mucand"][s]))
        kw = {} if taux is None else dict(vr_aux=taux, params=_t(d["params"]))
        if elastic:
            kw.update(step=s, faults=tf)
        tv, ts = t_step(_t(d["grads"][s]), ts, tk, tcfg, **kw)
        jv = None
        if jax_side:
            jaux = None if not vr else (_j(d["gsnap"][s]), _j(d["mucand"][s]))
            jv, js = jstep(_j(d["grads"][s]), js, jk, s, jaux)
        out.append((jv, js, tv, ts))
    return out


def _assert_steps(out, names=("h_worker", "h_server")):
    for s, (jv, js, tv, ts) in enumerate(out):
        _same_state(tv, dict(jv), f"step {s} v")
        for name in names:
            _same_state(getattr(ts, name), getattr(js, name), f"step {s} {name}")


def _cfgs(method, kw, spec=None, **extra):
    """The same bucketed config in both packages; ``spec`` (keywords of a
    ``ParticipationSpec``) gives each its own participation."""
    js, ts = _specs(**spec) if spec is not None else (None, None)
    return (JCfg(method=method, p=math.inf, use_kernel=False, bucketed=True, participation=js,
                 **extra, **kw),
            TCfg(method=method, p=math.inf, bucketed=True, participation=ts, **extra, **kw))


def _layouts(align, sizes):
    tree = {f"l{i:02d}": s for i, s in enumerate(sizes)}
    jl = JB.BucketLayout.for_tree({k: jax.ShapeDtypeStruct((s,), jnp.float32)
                                   for k, s in tree.items()}, align=align)
    tl = TB.BucketLayout.for_tree({k: torch.empty(s, device="meta") for k, s in tree.items()},
                                  align=align)
    return jl, tl


# ----------------------------------------------------------- the schedule


@pytest.mark.parametrize("seed", range(4))
def test_chunked_schedule_equals_jax(seed):
    """Bounds, offsets, sizes, rebased sub-layouts and key slices, over
    random leaf sizes and alignments; chunk sizes that do not divide the
    buffer, 0, and more than the buffer."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        sizes = [int(s) for s in rng.integers(1, 300, size=int(rng.integers(1, 12)))]
        align = int(rng.choice([1, 4, 16, 64]))
        jl, tl = _layouts(align, sizes)
        total = 4 * tl.padded_size
        for cb in (0, -1, int(rng.integers(1, total)), int(rng.integers(1, 64)), total,
                   total + 1000):
            js, ts = JB.ChunkedSchedule.for_layout(jl, cb), TB.ChunkedSchedule.for_layout(tl, cb)
            assert ts.bounds == js.bounds and ts.n_chunks == js.n_chunks, (sizes, cb)
            assert ts.chunk_offsets == js.chunk_offsets and ts.chunk_sizes == js.chunk_sizes
            for a, b in zip(ts.chunk_layouts, js.chunk_layouts):
                assert (a.sizes, a.padded_sizes, a.offsets, a.align) == (
                    b.sizes, b.padded_sizes, b.offsets, b.align)
            if cb <= 0 or cb >= total + 1000:
                assert ts.n_chunks == 1
            jkeys = jax.random.split(jax.random.PRNGKey(seed), tl.n_leaves)
            tkeys = prng.split(prng.PRNGKey(seed), tl.n_leaves)
            for c in range(ts.n_chunks):
                assert np.array_equal(ts.chunk_keys(tkeys, c).numpy(),
                                      np.asarray(js.chunk_keys(jkeys, c)).astype(np.int64))
            # split: views of the buffer, not copies, covering it in order
            flat = torch.arange(tl.padded_size, dtype=torch.float32)
            views = ts.split(flat)
            assert torch.equal(torch.cat(views), flat)
            for v, off in zip(views, ts.chunk_offsets):
                assert v.data_ptr() == flat.data_ptr() + 4 * off
            stacked = torch.zeros(3, tl.padded_size)
            ts.split(stacked)[-1].fill_(1.0)
            assert stacked[:, ts.chunk_offsets[-1]:].eq(1.0).all()


def test_checksum_tail_and_policy_bits_count_each_chunk():
    """One 8-byte tail per chunk in both packages' accounting."""
    jtree = {p: jnp.zeros(s) for p, s in SHAPES.items()}
    ttree = {p: torch.zeros(s) for p, s in SHAPES.items()}
    for method, kw in OPERATORS:
        jcfg, tcfg = _cfgs(method, kw)
        jl, tl = JB.BucketLayout.for_tree(jtree, jcfg.make().bucket_align()), bucket_layout(
            tcfg, ttree)
        for cb in (0, 100, CHUNK, 1 << 20):
            assert TB.checksum_tail_bits_per_dim(tl, cb) == JB.checksum_tail_bits_per_dim(jl, cb)
    for cb in (0, CHUNK):
        jpol = JPol.CompressionPolicy(rules=JPol.parse_rules(POLICY), bucketed=True,
                                      chunk_bytes=cb)
        tpol = TPol.CompressionPolicy(rules=TPol.parse_rules(POLICY), bucketed=True,
                                      chunk_bytes=cb)
        for armed in (False, True):
            assert TPol.policy_bits_per_dim(tpol, ttree, checksum=armed) == \
                JPol.policy_bits_per_dim(jpol, jtree, checksum=armed)
    # more chunks, more tails
    tpol = TPol.CompressionPolicy(rules=TPol.parse_rules(POLICY), bucketed=True)
    assert TPol.policy_bits_per_dim(tpol.replace(chunk_bytes=CHUNK), ttree, checksum=True) > \
        TPol.policy_bits_per_dim(tpol, ttree, checksum=True)


# ------------------------------------------------------ chunked rounds


@pytest.mark.parametrize("method,kw", OPERATORS, ids=OP_IDS)
def test_chunked_reference_step_bitwise_jax(method, kw):
    """Three or more uneven chunks; v and both memories over two steps,
    and the port's monolithic round gives the same bits."""
    jcfg, tcfg = _cfgs(method, kw, chunk_bytes=CHUNK)
    lay = bucket_layout(tcfg, {p: torch.zeros(s) for p, s in SHAPES.items()})
    sched = TB.ChunkedSchedule.for_layout(lay, CHUNK)
    assert sched.n_chunks >= 3 and len(set(sched.chunk_sizes)) > 1
    out = _run(jcfg, tcfg)
    _assert_steps(out)
    mono = _run(None, replace(tcfg, chunk_bytes=0), jax_side=False)
    for (_, _, tv, ts), (_, _, mv, ms) in zip(out, mono):
        for name, a, b in (("v", tv, mv), ("h_worker", ts.h_worker, ms.h_worker),
                           ("h_server", ts.h_server, ms.h_server)):
            _same_state(a, b.numpy() if isinstance(b, torch.Tensor)
                        else {k: x.numpy() for k, x in b.items()}, f"chunked vs mono {name}")


@pytest.mark.parametrize("method,kw", OPERATORS, ids=OP_IDS)
def test_chunked_vr_downlink_bitwise_jax(method, kw):
    """VR (vr_p 0.5) and the operator as its own chunked downlink."""
    jcfg, tcfg = _cfgs(method, kw, chunk_bytes=CHUNK, vr=True, vr_p=0.5, down_method=method,
                       down_k=kw.get("k"))
    out = _run(jcfg, tcfg, vr=True)
    _assert_steps(out, ("h_worker", "h_server", "h_down"))
    for s, (_, js, _, ts) in enumerate(out):
        _same_state(ts.vr.snapshot, dict(js.vr.snapshot), f"step {s} snapshot")
        _same_state(ts.vr.mu, dict(js.vr.mu), f"step {s} mu")


def _mid_chunk_byte(tcfg, c=1):
    """A body byte in the middle of chunk ``c``'s wire."""
    lay = bucket_layout(tcfg, {p: torch.zeros(s) for p, s in SHAPES.items()})
    sched = TB.ChunkedSchedule.for_layout(lay, tcfg.chunk_bytes)
    pays = _chunk_payloads(tcfg, sched, torch.zeros(lay.padded_size), prng.PRNGKey(0))
    sizes = [TB.fuse_payload(p).numel() for p in pays]
    return sum(sizes[:c]) + sizes[c] // 2


@pytest.mark.parametrize("method,kw", OPERATORS, ids=OP_IDS)
def test_chunked_participation_faults_bitwise_jax(method, kw):
    """Sampling, dropout, a churn leave and join, ``min_workers`` 2, and a
    fault plan: a corrupt in the middle of the second chunk of worker 0 at
    step 0 and a drop of worker 2 at step 2; four steps from PRNGKey(5)
    (masks 1111, a degraded step, then 1110 and 1011)."""
    jcfg, tcfg = _cfgs(method, kw, spec=SPEC, chunk_bytes=CHUNK)
    plans = _plans(dict(step=0, worker=0, kind="corrupt", byte=_mid_chunk_byte(tcfg)),
                   dict(step=2, worker=2, kind="drop"))
    _assert_steps(_run(jcfg, tcfg, steps=4, seed=5, faults=plans))


def test_chunked_grouped_policy_bitwise_jax():
    """A grouped policy with ``chunk_bytes``: identity, ternary with a top-k
    EF downlink, and rand-k groups, each bucketed group chunked, under
    participation (four steps from PRNGKey(5))."""
    js_, ts_ = _specs(**SPEC)
    jpol = JPol.CompressionPolicy(rules=JPol.parse_rules(POLICY), bucketed=True,
                                  chunk_bytes=CHUNK, participation=js_)
    tpol = TPol.CompressionPolicy(rules=TPol.parse_rules(POLICY), bucketed=True,
                                  chunk_bytes=CHUNK, participation=ts_)
    assert tpol.rule_config(1).chunk_bytes == CHUNK
    assert tpol.rule_down_config(1).chunk_bytes == CHUNK
    _assert_steps(_run(jpol, tpol, steps=4, seed=5), ("h_worker", "h_server", "h_down"))


def test_corrupt_mid_chunk_equals_churn_leave():
    """A corrupt in the middle of the second chunk of worker 1 excludes the
    worker whole: the round equals worker 1's churn leave bit for bit, and
    equals the monolithic wire's fault round (the same body byte)."""
    _, tcfg = _cfgs("diana", dict(block_size=16), chunk_bytes=CHUNK)
    plan = FaultPlan(events=(FaultEvent(step=0, worker=1, kind="corrupt",
                                        byte=_mid_chunk_byte(tcfg)),))
    d = _inputs(steps=1)
    grads, key = _t(d["grads"][0]), prng.PRNGKey(0)
    params = _t(d["params"])
    v_f, s_f = t_step(grads, t_init(params, tcfg, N), key, tcfg, step=0, faults=plan)
    churn = replace(tcfg, participation=ParticipationSpec(churn=(ChurnEvent(0, 1, "leave"),)))
    v_c, s_c = t_step(grads, t_init(params, churn, N), key, churn, step=0)
    mono = replace(tcfg, chunk_bytes=0)
    v_m, s_m = t_step(grads, t_init(params, mono, N), key, mono, step=0, faults=plan)
    for v in (v_c, v_m):
        assert all(torch.equal(v_f[p], v[p]) for p in SHAPES)
    for s in (s_c, s_m):
        assert torch.equal(s_f.h_server, s.h_server) and torch.equal(s_f.h_worker, s.h_worker)
    assert not s_f.h_worker[1].any() and s_f.h_worker[0].any()


# -------------------------------------------------------- hierarchical


def test_hierarchical_node_size_one_is_flat():
    for method, kw in OPERATORS[:1] + OPERATORS[2:3]:
        _, flat = _cfgs(method, kw)
        hier = replace(flat, topology="hierarchical", node_size=1)
        a = _run(None, flat, jax_side=False)
        b = _run(None, hier, jax_side=False)
        for (_, _, va, sa), (_, _, vb, sb) in zip(a, b):
            assert all(torch.equal(va[p], vb[p]) for p in SHAPES)
            assert torch.equal(sa.h_worker, sb.h_worker)
            assert torch.equal(sa.h_server, sb.h_server)


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["mono", "chunked"])
@pytest.mark.parametrize("method,kw", OPERATORS, ids=OP_IDS)
def test_hierarchical_node_size_two_bitwise_jax(method, kw, chunk):
    """n = 4 in two nodes: v and the memories bit for bit; each node's two
    rows are the same bits."""
    jcfg, tcfg = _cfgs(method, kw, chunk_bytes=chunk, topology="hierarchical", node_size=2)
    out = _run(jcfg, tcfg)
    _assert_steps(out)
    hw = out[-1][3].h_worker
    assert torch.equal(hw[0], hw[1]) and torch.equal(hw[2], hw[3])


def test_hierarchical_node_size_three_at_six_workers():
    """n = 6 in two nodes of three: the node mean's ``/ 3`` is the jitted
    reference's ``acc * f32(1/3)`` in the port too, so the round is bitwise
    (diana and natural)."""
    for method, kw in (OPERATORS[0], OPERATORS[1]):
        jcfg, tcfg = _cfgs(method, kw, topology="hierarchical", node_size=3)
        _assert_steps(_run(jcfg, tcfg, n=6))


def test_hierarchical_gates_match_jax():
    """The two-level round refuses what the JAX package refuses: a grouped
    policy (NotImplementedError in both), participation, faults, VR and a
    node size that does not divide n (the JAX package asserts; the port
    raises ValueError), and the per-leaf layout (ValueError in both)."""
    d = _inputs(steps=1)
    jp, tp = _j(d["params"]), _t(d["params"])
    jg, tg = _j(d["grads"][0]), _t(d["grads"][0])
    jk, tk = _keys(0, 0)
    base = dict(topology="hierarchical", node_size=2)
    with pytest.raises(ValueError):
        JCfg(method="diana", **base)
    with pytest.raises(ValueError):
        TCfg(method="diana", **base)
    jpol = JPol.CompressionPolicy(rules=JPol.parse_rules(POLICY), bucketed=True, **base)
    tpol = TPol.CompressionPolicy(rules=TPol.parse_rules(POLICY), bucketed=True, **base)
    with pytest.raises(NotImplementedError):
        j_step(jg, j_init(jp, jpol, N), jk, jpol)
    with pytest.raises(NotImplementedError):
        t_step(tg, t_init(tp, tpol, N), tk, tpol)
    cases = [(dict(spec=dict(q=0.5)), None), (dict(vr=True, vr_p=0.5), "vr"),
             (dict(node_size=3), None), ({}, "faults")]
    for extra, kind in cases:
        jcfg, tcfg = _cfgs("diana", dict(block_size=16), **{**base, **extra})
        jkw, tkw = {}, {}
        if kind == "vr":
            jkw = dict(vr_aux=(jg, jg), params=jp)
            tkw = dict(vr_aux=(tg, tg), params=tp)
        if kind == "faults":
            jplan, tplan = _plans(dict(step=0, worker=0, kind="drop"))
            jkw, tkw = dict(faults=jplan, step=0), dict(faults=tplan, step=0)
        if tcfg.participation is not None:
            jkw.setdefault("step", 0)
            tkw.setdefault("step", 0)
        with pytest.raises(AssertionError):
            j_step(jg, j_init(jp, jcfg, N), jk, jcfg, **jkw)
        with pytest.raises(ValueError):
            t_step(tg, t_init(tp, tcfg, N), tk, tcfg, **tkw)
