"""The elastic ``reference_step`` of the port
(``repro_torch.core.diana``) bit for bit the jitted JAX ``reference_step``,
on the inputs and specs of ``tests/test_torch_participation.py`` (the 1/64
grid, n = 4, four steps):

* all five operators, per leaf and bucketed, under sampling + dropout + a
  churn leave and join + ``min_workers`` = 2 (``PRNGKey(5)``: all four, a
  degraded step, then three of four twice, the rejoined worker among them):
  ``v``, ``h_worker`` and ``h_server``;
* with VR (coins gated on the scheduled mask) and each operator as its own
  downlink (``PRNGKey(8)``: all four, a degraded step, two of four twice,
  the rejoined worker's row reset and held): also ``h_down`` and the
  (snapshot, mu) rows;
* under a grouped policy (identity on ``b``, ternary with a top-k EF
  downlink on ``w``): one mask for both groups, identity summed from the
  masked rows;
* with a fault plan (corrupt, drop, delay) on the flat bucketed layout.

The direction ``h + total * scale`` is one FMA, as the jitted reference
rounds it (``Compressor.scaled_direction``), so three participants are
bitwise too.  Under a top-k EF uplink and a downlink, the jitted reference
also contracts the uplink's ``total * scale`` into the downlink's input
(``ghat + h_down``, or ``ghat - h_down`` for the alpha rule) across the two
rounds; the port's downlink encodes ``compress_input_scaled`` (one FMA) for
that uplink, so a top-k EF uplink under a top-k EF (or rand-k) downlink at
three participants is bitwise too (``PRNGKey(5)``: three of four at steps 2
and 3), with and without VR.
"""

import math

import jax
import pytest

from repro.core import policy as JPol
from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro.core.vr import VRState as JVRState
from repro_torch.core import participation as TP
from repro_torch.core import policy as TPol
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import reference_init as t_init, reference_step as t_step
from repro_torch.core.vr import VRState
from test_torch_participation import (CHURN, N, OPERATORS, POLICY, SPEC, STEPS, _inputs, _j,
                                      _keys, _one_torch_thread, _plans, _same_state, _specs,
                                      _t)

__all__ = ["_one_torch_thread"]   # the autouse fixture, imported to apply here


def _configs(method, kw, bucketed, spec_kw, vr=False, down=False):
    js, ts = _specs(**spec_kw)
    extra = dict(bucketed=bucketed, vr=vr, vr_p=0.5 if vr else None)
    if down:
        extra.update(down_method=method, down_k=kw.get("k"))
    return (JCfg(method=method, p=math.inf, use_kernel=False, participation=js, **extra, **kw),
            TCfg(method=method, p=math.inf, participation=ts, **extra, **kw))


def _run(jcfg, tcfg, seed, vr=False, faults=(None, None), steps=STEPS, data=None):
    """``steps`` rounds of both references from zero memories (VR from the
    given snapshots); returns the per-step (JAX v, state, port v, state)."""
    d = data or _inputs()
    js, ts = j_init(_j(d["params"]), jcfg, N), t_init(_t(d["params"]), tcfg, N)
    if vr:
        js = js._replace(vr=JVRState(snapshot=_j(d["snap"]), mu=_j(d["mu"])))
        ts = ts._replace(vr=VRState(snapshot=_t(d["snap"]), mu=_t(d["mu"])))
    jf, tf = faults

    def jfn(g, s, k, st, aux):
        kw = {} if aux is None else dict(vr_aux=aux, params=_j(d["params"]))
        return j_step(g, s, k, jcfg, step=st, faults=jf, **kw)
    jstep = jax.jit(jfn)
    out = []
    for s in range(steps):
        jk, tk = _keys(seed, s)
        jaux = taux = None
        if vr:
            jaux = (_j(d["gsnap"][s]), _j(d["mucand"][s]))
            taux = (_t(d["gsnap"][s]), _t(d["mucand"][s]))
        jv, js = jstep(_j(d["grads"][s]), js, jk, s, jaux)
        tv, ts = t_step(_t(d["grads"][s]), ts, tk, tcfg, step=s, faults=tf,
                        **({} if taux is None else dict(vr_aux=taux, params=_t(d["params"]))))
        out.append((jv, js, tv, ts))
    return out


def _assert_steps(out, names=("h_worker", "h_server")):
    for s, (jv, js, tv, ts) in enumerate(out):
        _same_state(tv, dict(jv), f"step {s} v")
        for name in names:
            _same_state(getattr(ts, name), getattr(js, name), f"step {s} {name}")


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
@pytest.mark.parametrize("method,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_elastic_reference_step_bitwise_jax(method, kw, bucketed):
    """PRNGKey(5): masks 1111, then (worker 3 gone) a degraded 0100, then
    1110 and 1011 (worker 3 rejoined at step 3 with a fresh row)."""
    out = _run(*_configs(method, kw, bucketed, SPEC), seed=5)
    _assert_steps(out)
    masks = [TP.step_ctx(TP.ParticipationSpec(**{**SPEC, "churn": tuple(
        TP.ChurnEvent(*c) for c in CHURN)}), prng.fold_in(_keys(5, s)[1], TP.PART_FOLD), N,
        s) for s in range(STEPS)]
    assert [(m.mask.tolist(), m.ok) for m in masks] == [
        ([True] * 4, True), ([False, True, False, False], False),
        ([True, True, True, False], True), ([True, False, True, True], True)]
    # the degraded step: ghat zero, every memory as after step 0
    _, js0, _, ts0 = out[0]
    _, _, tv1, ts1 = out[1]
    assert all(not v.any() for v in tv1.values())
    _same_state(ts1.h_server, ts0.h_server.numpy() if bucketed
                else {p: v.numpy() for p, v in ts0.h_server.items()}, "frozen h_server")


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
@pytest.mark.parametrize("method,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_elastic_vr_downlink_bitwise_jax(method, kw, bucketed):
    """VR (vr_p 0.5, coins gated on the scheduled mask) and the operator as
    its own downlink, PRNGKey(8): masks 1111, a degraded 0010, 0110, 1010
    (worker 3 rejoins at step 3 outside the mask: its row reset and held)."""
    out = _run(*_configs(method, kw, bucketed, SPEC, vr=True, down=True), seed=8, vr=True)
    _assert_steps(out, ("h_worker", "h_server", "h_down"))
    for s, (_, js, _, ts) in enumerate(out):
        _same_state(ts.vr.snapshot, dict(js.vr.snapshot), f"step {s} snapshot")
        _same_state(ts.vr.mu, dict(js.vr.mu), f"step {s} mu")
    ts3 = out[3][3]
    rows = [ts3.h_worker] if bucketed else list(ts3.h_worker.values())
    assert all(not r[3].any() for r in rows), "the rejoined row is not reset"


def test_elastic_grouped_policy_bitwise_jax():
    """A grouped policy (identity on ``b``, ternary on ``w`` with a top-k EF
    downlink): the one mask serves both groups; identity is summed from the
    masked rows."""
    js_, ts_ = _specs(**SPEC)
    jpol = JPol.CompressionPolicy(rules=JPol.parse_rules(POLICY), bucketed=True,
                                  participation=js_)
    tpol = TPol.CompressionPolicy(rules=TPol.parse_rules(POLICY), bucketed=True,
                                  participation=ts_)
    out = _run(jpol, tpol, seed=8)
    _assert_steps(out, ("h_worker", "h_server", "h_down"))


@pytest.mark.parametrize("method,kw", OPERATORS, ids=[m for m, _ in OPERATORS])
def test_faults_bitwise_jax(method, kw):
    """Flat bucketed, no participation beyond the checksum: a corrupt on
    worker 1 at step 0 (byte 0, where each operator's first field starts),
    a corrupt deep in worker 2's wire at step 1 with a drop of worker 0,
    and a delay of worker 3 over steps 2-3."""
    jplan, tplan = _plans(dict(step=0, worker=1, kind="corrupt"),
                          dict(step=1, worker=2, kind="corrupt", byte=123, bits=0x41),
                          dict(step=1, worker=0, kind="drop"),
                          dict(step=2, worker=3, kind="delay", delay=2))
    jcfg = JCfg(method=method, p=math.inf, bucketed=True, use_kernel=False, **kw)
    tcfg = TCfg(method=method, p=math.inf, bucketed=True, **kw)
    _assert_steps(_run(jcfg, tcfg, seed=5, faults=(jplan, tplan)))




@pytest.mark.parametrize("down,bucketed,vr", [
    ("topk_ef", False, False), ("topk_ef", True, False), ("topk_ef", False, True),
    ("topk_ef", True, True), ("randk", False, False), ("randk", True, False)],
    ids=["topk_ef-perleaf", "topk_ef-bucketed", "topk_ef-perleaf-vr", "topk_ef-bucketed-vr",
         "randk-perleaf", "randk-bucketed"])
def test_topk_ef_uplink_under_downlink_three_participants_bitwise(down, bucketed, vr):
    """A top-k EF uplink under a top-k EF or rand-k downlink, PRNGKey(5):
    masks 1111, a degraded step, then 1110 and 1011, so the direction's
    scale is 4/3 on two steps.  The downlink's input is the one-FMA
    ``fma(scale, total, +-h_down)`` of the jitted reference: v, every
    memory and (with VR) the (snapshot, mu) rows bit for bit."""
    js_, ts_ = _specs(**SPEC)
    extra = dict(bucketed=bucketed, vr=vr, vr_p=0.5 if vr else None, down_method=down,
                 down_k=8)
    jcfg = JCfg(method="topk_ef", p=math.inf, k=8, use_kernel=False, participation=js_, **extra)
    tcfg = TCfg(method="topk_ef", p=math.inf, k=8, participation=ts_, **extra)
    out = _run(jcfg, tcfg, seed=5, vr=vr)
    _assert_steps(out, ("h_worker", "h_server", "h_down"))
    if vr:
        for s, (_, js, _, ts) in enumerate(out):
            _same_state(ts.vr.snapshot, dict(js.vr.snapshot), f"step {s} snapshot")
            _same_state(ts.vr.mu, dict(js.vr.mu), f"step {s} mu")


@pytest.mark.parametrize("down", ["topk_ef", "randk"])
@pytest.mark.parametrize("layout", ["bucketed", "perleaf"])
def test_grouped_topk_ef_uplink_under_downlink_three_participants_bitwise(down, layout):
    """The same composition inside a grouped policy (identity on ``b``, a
    top-k EF group with a top-k EF or rand-k down rule on ``w``, the group
    bucketed or per leaf), PRNGKey(5): the group's round defers the scale
    4/3 to its downlink as the flat round does.  v and every group's
    memories bit for bit."""
    js_, ts_ = _specs(**SPEC)
    rules = f"^b$=identity,*=topk_ef:k=8:layout={layout}/{down}:k=8"
    jpol = JPol.CompressionPolicy(rules=JPol.parse_rules(rules), bucketed=True,
                                  participation=js_)
    tpol = TPol.CompressionPolicy(rules=TPol.parse_rules(rules), bucketed=True,
                                  participation=ts_)
    out = _run(jpol, tpol, seed=5)
    _assert_steps(out, ("h_worker", "h_server", "h_down"))
