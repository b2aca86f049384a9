"""Compression policies in the port (``repro_torch.core.policy`` and the
grouped rounds of ``repro_torch.core.diana``) against the JAX package.

* A mixed policy on ``{"b": (8,), "emb": (32, 8), "norm": (16,), "w1":
  (16, 16), "w2": (16, 16)}``: an identity group (``b``, ``norm``,
  bucketed), a per-leaf top-k EF group (``emb``, k = 16) with a per-leaf
  ternary downlink, and a bucketed ternary group (``w1``, ``w2``, B = 16)
  with a top-k EF downlink (k = 8).  Inputs on the 1/64 grid
  (``tests/test_torch_vr.py``), n = 4 workers, two rounds.
  - ``reference_step`` bit for bit the jitted JAX ``reference_step`` with
    the same policy: ``v`` (= ghat), every group's ``h_worker``,
    ``h_server`` and ``h_down``; and with VR on the policy (the snapshots
    and mu too).
  - ``aggregate_distributed`` on 4 gloo ranks against ``aggregate_shardmap``
    in a ``(4, 1)`` host mesh (a JAX subprocess, as in
    ``tests/test_torch_distributed.py``): bit for bit, except the identity
    group's ghat, which both take from an all-reduce (``pmean`` in JAX) and
    which is held within two summation orders, 2(n-1) eps of the summed
    magnitudes; one collective per group.
* The policy objects on llama3.2-1b's tree (full and reduced): paths, the
  partition (group names, rules, leaf order), ``parse_rules``, the JSON
  document both ways, ``size_adaptive``, ``grouped_bucket_layout`` and
  ``policy_bits_per_dim`` equal the JAX package's.
* The uniform law (a one-rule policy is the flat config, draw for draw),
  ``state_from_jax`` on a grouped state, and the fields of the chunked
  schedule refused.
"""

import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import policy as JP
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro.core.vr import VRState as JVRState
from repro.models import init_model as j_init_model
from repro_torch.configs import get_config, reduced
from repro_torch.convert import state_from_jax
from repro_torch.core import policy as TP
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import (DOWN_FOLD, aggregate_distributed, init_state,
                                    reference_init as t_init, reference_step as t_step,
                                    worker_key)
from repro_torch.core.vr import VRState
from repro_torch.models.transformer import param_shapes

ROOT = Path(__file__).resolve().parents[1]
N = 4
ROUNDS = 2
KEY_SEED = 7
F32_EPS = 2.0 ** -23
SHAPES = {"b": (8,), "emb": (32, 8), "norm": (16,), "w1": (16, 16), "w2": (16, 16)}
POLICY = ("^norm$|^b$=identity,^emb$=topk_ef:k=16:layout=perleaf/diana:block=16,"
          "*=diana:block=16/topk_ef:k=8")
GROUPS = ["g00_identity", "g01_topk_ef", "g02_ternary"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape, scale=64):
    return (np.round(rng.standard_normal(shape) * scale) / scale).astype(np.float32)


def _inputs(seed=3):
    """Parameters, per-round stacked gradients, and VR's snapshots, mu and
    per-round snapshot gradients and mu candidates, on the 1/64 grid."""
    rng = np.random.default_rng(seed)
    data = {}
    for p, s in SHAPES.items():
        data[f"params/{p}"] = _grid(rng, s)
        data[f"snap/{p}"], data[f"mu/{p}"] = _grid(rng, (N, *s)), _grid(rng, (N, *s))
        for r in range(ROUNDS):
            for name in ("g", "gsnap", "mucand"):
                data[f"{name}/{p}{r}"] = _grid(rng, (N, *s))
    return data


def _tree(data, name, r=None, to=np.asarray):
    return {p: to(data[f"{name}/{p}" + ("" if r is None else str(r))]) for p in SHAPES}


def _policies(vr=False):
    kw = dict(bucketed=True, vr=vr, vr_p=0.5 if vr else None)
    return (JP.CompressionPolicy(rules=JP.parse_rules(POLICY), **kw),
            TP.CompressionPolicy(rules=TP.parse_rules(POLICY), **kw))


def _keys(r):
    return (jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), r),
            prng.fold_in(prng.PRNGKey(KEY_SEED), r))


def _same(t, j, what):
    a, b = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, float(np.abs(a - b).max()))


def _same_state(t, j, what):
    """A state slot: a tensor, a list (a per-leaf group), or a dict of them."""
    if isinstance(j, dict):
        assert sorted(t) == sorted(j), (what, sorted(t), sorted(j))
        for k in j:
            _same_state(t[k], j[k], f"{what}/{k}")
    elif isinstance(j, (list, tuple)):
        assert isinstance(t, list) and len(t) == len(j), what
        for i, (a, b) in enumerate(zip(t, j)):
            _same_state(a, b, f"{what}[{i}]")
    else:
        _same(t, j, what)


# ------------------------------------------------------------ reference_step


@pytest.mark.parametrize("vr", [False, True], ids=["plain", "vr"])
def test_mixed_policy_reference_step_bitwise_jax(vr):
    """The grouped reference round, two rounds from zero memories (VR from
    the given snapshots and mu): v, h_worker, h_server, h_down (and VR's
    rows) bit for bit the jitted JAX round."""
    data = _inputs()
    jpol, tpol = _policies(vr)
    jparams, tparams = _tree(data, "params", to=jnp.asarray), _tree(data, "params",
                                                                     to=torch.from_numpy)
    js, ts = j_init(jparams, jpol, N), t_init(tparams, tpol, N)
    if vr:
        js = js._replace(vr=JVRState(snapshot=_tree(data, "snap", to=jnp.asarray),
                                     mu=_tree(data, "mu", to=jnp.asarray)))
        ts = ts._replace(vr=VRState(snapshot=_tree(data, "snap", to=torch.from_numpy),
                                    mu=_tree(data, "mu", to=torch.from_numpy)))

    def jfn(g, s, k, aux):
        return j_step(g, s, k, jpol, **({} if aux is None else
                                        dict(vr_aux=aux, params=jparams)))
    jstep = jax.jit(jfn)
    for r in range(ROUNDS):
        jk, tk = _keys(r)
        jaux = taux = None
        if vr:
            jaux = (_tree(data, "gsnap", r, jnp.asarray), _tree(data, "mucand", r, jnp.asarray))
            taux = (_tree(data, "gsnap", r, torch.from_numpy),
                    _tree(data, "mucand", r, torch.from_numpy))
        jv, js = jstep(_tree(data, "g", r, jnp.asarray), js, jk, jaux)
        tv, ts = t_step(_tree(data, "g", r, torch.from_numpy), ts, tk, tpol,
                        **({} if not vr else dict(vr_aux=taux, params=tparams)))
        assert sorted(ts.h_worker) == GROUPS and sorted(ts.h_down) == GROUPS[1:]
        assert isinstance(ts.h_worker["g01_topk_ef"], list)
        assert isinstance(ts.h_down["g01_topk_ef"], list)
        _same_state(tv, dict(jv), f"round {r} v")
        for name in ("h_worker", "h_server", "h_down"):
            _same_state(getattr(ts, name), getattr(js, name), f"round {r} {name}")
        if vr:
            _same_state(ts.vr.snapshot, dict(js.vr.snapshot), f"round {r} snapshot")
            _same_state(ts.vr.mu, dict(js.vr.mu), f"round {r} mu")


@pytest.mark.parametrize("bucketed", [False, True], ids=["perleaf", "bucketed"])
@pytest.mark.parametrize("method,kw", [("diana", dict(block_size=16)), ("topk_ef", dict(k=8)),
                                       ("randk", dict(k=8))])
def test_uniform_policy_is_the_flat_config(method, kw, bucketed):
    """``uniform(cfg).flat_config() == cfg``, and a uniform policy's state
    and rounds are the flat config's bit for bit (no group fold), with a
    downlink too."""
    cfg = TCfg(method=method, bucketed=bucketed, down_method="diana", **kw)
    pol = TP.CompressionPolicy.uniform(cfg)
    assert pol.is_uniform and pol.flat_config() == cfg
    data = _inputs()
    params = _tree(data, "params", to=torch.from_numpy)
    s_cfg, s_pol = t_init(params, cfg, N), t_init(params, pol, N)
    for r in range(ROUNDS):
        g = _tree(data, "g", r, torch.from_numpy)
        v1, s_cfg = t_step(g, s_cfg, _keys(r)[1], cfg)
        v2, s_pol = t_step(g, s_pol, _keys(r)[1], pol)
        _same_state(v2, {p: x.numpy() for p, x in v1.items()}, "v")
        for name in ("h_worker", "h_server", "h_down"):
            a, b = getattr(s_pol, name), getattr(s_cfg, name)
            _same_state(a, {k: x.numpy() for k, x in b.items()} if isinstance(b, dict)
                        else b.numpy(), name)


def test_state_from_jax_carries_grouped_states():
    """A grouped JAX ``ReferenceState`` (dicts by group, lists for per-leaf
    groups, h_down per group) comes across bit for bit, in the port's
    layout, and steps on to the same round as the JAX one."""
    data = _inputs()
    jpol, tpol = _policies()
    jparams = _tree(data, "params", to=jnp.asarray)
    js = j_init(jparams, jpol, N)
    _, js = jax.jit(lambda g, s, k: j_step(g, s, k, jpol))(_tree(data, "g", 0, jnp.asarray),
                                                          js, _keys(0)[0])
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    layout = t_init(_tree(data, "params", to=torch.from_numpy), tpol, N)
    for name in ("h_worker", "h_server", "h_down"):
        got, want = getattr(ts, name), getattr(layout, name)
        assert sorted(got) == sorted(want), name
        for g in want:
            assert type(got[g]) is type(want[g]), (name, g)
        _same_state(got, getattr(js, name), name)
    jv, js = jax.jit(lambda g, s, k: j_step(g, s, k, jpol))(_tree(data, "g", 1, jnp.asarray),
                                                           js, _keys(1)[0])
    tv, ts = t_step(_tree(data, "g", 1, torch.from_numpy), ts, _keys(1)[1], tpol)
    _same_state(tv, dict(jv), "v")
    _same_state(ts.h_worker, js.h_worker, "h_worker")


def test_later_slice_fields_refused():
    """The wire schedule's fields (``chunk_bytes``, ``topology``,
    ``node_size``) are accepted and round-trip through JSON as the JAX
    policy's do (the JAX-only ``worker_axes`` aside); invalid values raise
    the JAX package's ``ValueError``.  A participation that is not a
    ``ParticipationSpec`` raises TypeError, as anything but a config or a
    policy does in ``as_policy``."""
    with pytest.raises(TypeError, match="participation"):
        TP.CompressionPolicy(participation=object())
    rules = [{"pattern": ".*", "method": "diana"}]
    for kw in (dict(chunk_bytes=256), dict(topology="hierarchical", node_size=2),
               dict(chunk_bytes=1 << 20, topology="hierarchical", node_size=4), dict()):
        tpol = TP.CompressionPolicy(bucketed=True, **kw)
        jpol = JP.CompressionPolicy(bucketed=True, **kw)
        tdoc, jdoc = tpol.to_json_dict(), jpol.to_json_dict()
        jdoc.pop("worker_axes")
        assert tdoc == jdoc
        assert TP.CompressionPolicy.from_json_dict(jpol.to_json_dict()) == tpol
        assert JP.CompressionPolicy.from_json_dict(tdoc) == jpol
        for f in ("chunk_bytes", "topology", "node_size"):
            assert getattr(tpol.flat_config(), f) == getattr(jpol.flat_config(), f)
    for field, value in (("chunk_bytes", -1), ("topology", "ring"), ("node_size", 0)):
        for cls in (TP.CompressionPolicy, JP.CompressionPolicy):
            with pytest.raises(ValueError, match=field):
                cls(**{field: value})
            with pytest.raises(ValueError, match=field):
                cls.from_json_dict({"rules": rules, field: value})
    with pytest.raises(TypeError):
        TP.as_policy(object())


# ------------------------------------------------- policy objects vs the JAX package


def _llama_trees(full):
    """The JAX package's llama3.2-1b parameter tree (shapes only) and the
    port's, as meta tensors."""
    jcfg, tcfg = j_get_config("llama3.2-1b"), get_config("llama3.2-1b")
    if not full:
        jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
    jtree = jax.eval_shape(lambda k: j_init_model(jcfg, k), jax.ShapeDtypeStruct((2,), "uint32"))
    ttree = {p: torch.empty(s, device="meta") for p, s in param_shapes(tcfg).items()}
    return jcfg, tcfg, jtree, ttree


def _doc(pol):
    """A policy's JSON document without the JAX-only ``worker_axes``."""
    d = pol.to_json_dict()
    d.pop("worker_axes", None)
    return d


CURATED = ("scale$|bias=identity,^embed$|^lm_head$=topk_ef:k=256,*=diana")
INLINE = ("mixer/w[qk]=natural:layout=perleaf/randk:k=32,mlp=diana:block=1024:p=2,"
          "embed=randk:k=128:alpha=0.25,*=topk_ef:k=64/diana:block=64:layout=bucketed")


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("rules", [CURATED, INLINE], ids=["curated", "inline"])
def test_policy_objects_equal_jax_on_llama(full, rules):
    jcfg, tcfg, jtree, ttree = _llama_trees(full)
    assert tcfg.comp_policy == jcfg.comp_policy == CURATED
    assert TP.tree_paths(ttree) == JP.tree_paths(jtree)
    for bucketed in (True, False):
        jpol = JP.CompressionPolicy(rules=JP.parse_rules(rules), bucketed=bucketed)
        tpol = TP.CompressionPolicy(rules=TP.parse_rules(rules), bucketed=bucketed)
        assert _doc(tpol) == _doc(jpol)
        # the JSON both ways
        assert _doc(TP.CompressionPolicy.from_json(jpol.to_json())) == _doc(jpol)
        assert JP.CompressionPolicy.from_json(tpol.to_json()) == jpol
        jpart, tpart = JP.partition_for(jpol, jtree), TP.partition_for(tpol, ttree)
        assert tpart.group_names == jpart.group_names
        assert tpart.rule_ids == jpart.rule_ids
        assert tpart.group_leaf_ids == jpart.group_leaf_ids
        for tc, jc in zip(tpart.configs + tpart.down_configs,
                          jpart.configs + jpart.down_configs):
            assert (tc is None) == (jc is None)
            if tc is not None:
                for f in ("method", "p", "block_size", "alpha", "k", "bucketed"):
                    assert getattr(tc, f) == getattr(jc, f), f
        split = tpart.split(ttree)
        assert [list(g) for g in split] == [list(p) for p in tpart.group_paths]
        merged = tpart.merge(split)
        assert list(merged) == list(TP.tree_paths(ttree))
        assert all(merged[p] is ttree[p] for p in ttree)
        jlay, tlay = JP.grouped_bucket_layout(jpol, jtree), TP.grouped_bucket_layout(tpol, ttree)
        assert (tlay.names, tlay.rule_ids) == (jlay.names, jlay.rule_ids)
        assert [l.sizes for l in tlay.layouts] == [l.sizes for l in jlay.layouts]
        assert [l.padded_sizes for l in tlay.layouts] == [l.padded_sizes for l in jlay.layouts]
        assert TP.policy_bits_per_dim(tpol, ttree) == JP.policy_bits_per_dim(jpol, jtree)
        assert tpol.is_uniform == jpol.is_uniform and tpol.any_bucketed() == jpol.any_bucketed()
        assert _doc(tpol.force_perleaf()) == _doc(jpol.force_perleaf())
        assert _doc(tpol.with_down("natural", 7)) == _doc(jpol.with_down("natural", 7))
        specs = [TP.ChannelSpec("randk", k=9)] + [None] * (len(tpol.rules) - 1)
        jspecs = [JP.ChannelSpec("randk", k=9)] + [None] * (len(jpol.rules) - 1)
        assert _doc(tpol.with_rule_specs(specs)) == _doc(jpol.with_rule_specs(jspecs))
    jsa = JP.CompressionPolicy.size_adaptive(jtree, threshold_dims=1 << 16, bucketed=True)
    tsa = TP.CompressionPolicy.size_adaptive(ttree, threshold_dims=1 << 16, bucketed=True)
    assert _doc(tsa) == _doc(jsa)
    assert TP.partition_for(tsa, ttree).group_names == JP.partition_for(jsa, jtree).group_names
    assert TP.policy_bits_per_dim(tsa, ttree) == JP.policy_bits_per_dim(jsa, jtree)


def test_curated_policy_groups_at_full_width():
    """llama3.2-1b's curated policy at 8 layers: the three groups the card
    runs, their sizes, and the wire cost (32 bits over the scales, 512
    top-k entries, ternary's 2 + 32/2048 over the rest)."""
    tcfg = replace(get_config("llama3.2-1b"), n_layers=8)
    ttree = {p: torch.empty(s, device="meta") for p, s in param_shapes(tcfg).items()}
    pol = TP.load_policy(tcfg.comp_policy, bucketed=True)
    lay = TP.grouped_bucket_layout(pol, ttree)
    assert lay.names == ("g00_identity", "g01_topk_ef", "g02_ternary")
    assert [l.size for l in lay.layouts] == [34816, 536870912, 486539264]
    topk_bits = (32 + 32) * 256 * 2
    want = (32.0 * 34816 + topk_bits + (2 + 32 / 2048) * 486539264) / lay.size
    assert TP.policy_bits_per_dim(pol, lay) == pytest.approx(want, rel=1e-12)


def test_parse_rules_and_load_policy(tmp_path):
    """The inline syntax's errors, and the JSON file surface, as the JAX
    package's."""
    for bad in ("", "nonsense", "a=diana:k", "a=diana:zz=3", "a=unknown_method"):
        with pytest.raises((ValueError, KeyError)):
            TP.parse_rules(bad)
        with pytest.raises((ValueError, KeyError)):
            JP.parse_rules(bad)
    jpol = JP.CompressionPolicy(rules=JP.parse_rules(INLINE), bucketed=True, vr=True,
                                vr_p=0.25)
    path = tmp_path / "policy.json"
    path.write_text(jpol.to_json())
    tpol = TP.load_policy(str(path), bucketed=False)
    assert _doc(tpol) == _doc(jpol) and tpol.bucketed and tpol.vr_p == 0.25
    with pytest.raises(FileNotFoundError):
        TP.load_policy(str(tmp_path / "missing.json"))
    assert TP.load_policy(TCfg(method="natural")).flat_config() == TCfg(method="natural")


# ---------------------------------------------- aggregate_distributed on 4 gloo ranks

JAX_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import CompressionPolicy, DianaState, aggregate_shardmap, init_state, parse_rules
from repro.core.diana import DOWN_FOLD
from repro.launch.mesh import make_mesh

data = np.load(sys.argv[1])
n, shapes = 4, %(shapes)r
pol = CompressionPolicy(rules=parse_rules(%(policy)r), bucketed=True)
mesh = make_mesh((n, 1), ("data", "model"))
params = {p: jnp.asarray(data["params/" + p]) for p in shapes}
tmap = jax.tree_util.tree_map
state = init_state(params, pol, n)

def body(gs, h_w, h_s, h_d, k):
    g_local = tmap(lambda g: g[0], gs)
    wkey = jax.random.fold_in(k, jax.lax.axis_index("data"))
    ghat, new = aggregate_shardmap(g_local, DianaState(h_w, h_s, None, h_d), wkey, pol,
                                   axis_names=("data",), n_workers=n,
                                   down_key=jax.random.fold_in(k, DOWN_FOLD))
    return ghat, new.h_worker, new.h_server, new.h_down

hd = tmap(lambda _: P(), state.h_down)
fn = jax.jit(shard_map(body, mesh=mesh,
    in_specs=(tmap(lambda _: P("data"), params), tmap(lambda _: P("data"), state.h_worker),
              tmap(lambda _: P(), state.h_server), hd, P()),
    out_specs=(tmap(lambda _: P(), params), tmap(lambda _: P("data"), state.h_worker),
               tmap(lambda _: P(), state.h_server), hd),
    axis_names={"data"}, check_vma=False))
out = {}

def save(prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            save(f"{prefix}/{k}", v)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            save(f"{prefix}/{i}", v)
    else:
        out[prefix] = np.asarray(t)

hw, hs, hdown = state.h_worker, state.h_server, state.h_down
for r in range(%(rounds)d):
    g = {p: jnp.asarray(data[f"g/{p}{r}"]) for p in shapes}
    ghat, hw, hs, hdown = fn(g, hw, hs, hdown, jax.random.fold_in(jax.random.PRNGKey(%(seed)d), r))
    for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs), ("hd", hdown)):
        save(f"{r}/{name}", t)
np.savez(sys.argv[2], **out)
"""


def _save(out, prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            _save(out, f"{prefix}/{k}", v)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            _save(out, f"{prefix}/{i}", v)
    else:
        out[prefix] = t.numpy()


class _Count:
    """Counts the collectives the round calls."""

    def __enter__(self):
        self.calls, self._orig = [], {}
        for name in ("all_gather_into_tensor", "all_reduce"):
            self._orig[name] = orig = getattr(dist, name)

            def wrapped(*a, _name=name, _orig=orig, **kw):
                self.calls.append(_name)
                return _orig(*a, **kw)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(dist, name, orig)


def _rank_main(rank, tmp, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, N), rank=rank, world_size=N)
    tmp = Path(tmp)
    data = np.load(tmp / "inputs.npz")
    _, tpol = _policies()
    state = init_state(_tree(data, "params", to=torch.from_numpy), tpol, 1)
    out, calls = {}, []
    for r in range(ROUNDS):
        g = {p: torch.from_numpy(data[f"g/{p}{r}"][rank].copy()) for p in SHAPES}
        kr = _keys(r)[1]
        with _Count() as c:
            ghat, state = aggregate_distributed(g, state, worker_key(kr, rank), tpol,
                                                down_key=prng.fold_in(kr, DOWN_FOLD))
        calls.append(c.calls)
        for name, t in (("ghat", ghat), ("hw", state.h_worker), ("hs", state.h_server),
                        ("hd", state.h_down)):
            _save(out, f"{r}/{name}", t)
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(calls))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("policy_dist")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT % dict(shapes=SHAPES, policy=POLICY, rounds=ROUNDS, seed=KEY_SEED)
    jproc = subprocess.Popen([sys.executable, "-c", script, str(tmp / "inputs.npz"),
                              str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        ctx = mp.start_processes(_rank_main, args=(str(tmp), str(tmp / "store")), nprocs=N,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError("the gloo ranks did not finish in 300 s")
    finally:
        jout, jerr = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, f"stdout:\n{jout}\nstderr:\n{jerr[-3000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
    calls = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N)]
    return dict(np.load(tmp / "jax.npz")), ranks, calls


def test_mixed_policy_distributed_bitwise_aggregate_shardmap(dist_runs):
    """Every rank's ghat, h_server and h_down, and its h_worker rows, equal
    the JAX package's grouped ``aggregate_shardmap`` bit for bit over two
    rounds, the identity group's ghat excepted (next test)."""
    jax_out, ranks, _ = dist_runs
    ident = {"b", "norm"}
    for r in range(ROUNDS):
        keys = [k for k in jax_out if k.startswith(f"{r}/")]
        assert any("/hd/" in k for k in keys) and any("/hw/g01_topk_ef/0" in k for k in keys)
        for k in keys:
            if k.split("/")[1] == "ghat" and k.split("/")[2] in ident:
                continue
            for rank in range(N):
                got = ranks[rank][k]
                want = jax_out[k][rank:rank + 1] if k.split("/")[1] == "hw" else jax_out[k]
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (k, rank)


def test_mixed_policy_identity_group_is_the_all_reduce_mean(dist_runs):
    """The identity group's ghat: gloo's all-reduce and XLA's ``pmean`` each
    sum in their own order, so ghat agrees within 2(n-1) eps of the summed
    magnitudes (two summation orders), the same on every rank."""
    jax_out, ranks, _ = dist_runs
    data = _inputs()
    for r in range(ROUNDS):
        for p in ("b", "norm"):
            k = f"{r}/ghat/{p}"
            mag = np.abs(data[f"g/{p}{r}"].astype(np.float64)).mean(axis=0)
            d = np.abs(ranks[0][k].astype(np.float64) - jax_out[k])
            assert np.all(d <= 2 * (N - 1) * F32_EPS * mag), (k, float(d.max()))
            for rank in range(1, N):
                assert ranks[rank][k].tobytes() == ranks[0][k].tobytes()


def test_mixed_policy_collectives_per_group(dist_runs):
    """One all-reduce for the identity group, one per field for the
    per-leaf top-k leaf (indices, values) and ONE fused all-gather for the
    bucketed ternary group, in group order."""
    _, _, calls = dist_runs
    want = ["all_reduce"] + ["all_gather_into_tensor"] * 3
    for c in calls:
        assert c == [want] * ROUNDS, c
