"""The per-leaf and grouped (policy) trainers, and the optimizer's
regularizer, on the CPU.

* ``--per-leaf-agg``: the in-turn trainer in the per-leaf layout against
  the bucketed one (the reference's own law, ``tests/test_bucket.py:164``),
  4 workers, 2 steps, every operator: parameters, ``h_worker`` and
  ``h_server`` bit for bit (each leaf's memory against its stretch of the
  bucket).
* ``--comp-policy``: the grouped in-turn trainer against the port's
  ``reference_step`` with the same policy on the same gradients, bit for
  bit (that round is held to the JAX package's in
  ``tests/test_torch_policy.py``): the curated llama3.2-1b policy, and a
  policy with a per-leaf group and a downlink on each group.  A world of
  one (a one-rank gloo group in this process) is the in-turn trainer at
  n = 1 bit for bit, with VR and the downlinks.
* ``DianaOptimizer``: the ``l1`` / ``l2`` prox and ``refresh_snapshot``
  bit for bit the JAX optimizer's, eager, over three steps.
* The CLI: ``--per-leaf-agg``, ``--comp-policy default``,
  ``size-adaptive``, inline rules and a ``.json`` file each train.

The model is reduced llama3.2-1b narrowed to d_model 128, so that the plain
versions of the encodes keep the file inside a minute; torch runs one
thread.
"""

import contextlib
import io
import math
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import policy as JP
from repro.core.compression import CompressionConfig as JCfg
from repro.core.prox import l1 as j_l1, l2 as j_l2
from repro.optim.diana_optimizer import DianaOptimizer as JOptimizer
from repro.optim.optimizers import constant_schedule as j_constant, momentum as j_momentum
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import policy as TP
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import bucket_layout, reference_init, reference_step
from repro_torch.core.prox import l1 as t_l1, l2 as t_l2
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import train
from repro_torch.models.transformer import init_model, train_loss
from repro_torch.optim.diana_optimizer import DianaOptimizer
from repro_torch.optim.optimizers import constant_schedule, momentum

N = 4
SHAPE = ShapeConfig("t", 16, 4, "train")
METHODS = ("diana", "natural", "randk", "topk_ef", "none")
MIXED = ("scale$=identity,^embed$|^lm_head$=topk_ef:k=256:layout=perleaf/diana:block=256,"
         "*=diana/topk_ef:k=64")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**over):
    return replace(reduced(get_config("llama3.2-1b")), d_model=128, n_heads=4, n_kv_heads=2,
                   head_dim=32, d_ff=256, **over)


def _batch(cfg, s, shape=SHAPE):
    return {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, shape, s).items()}


def _train(cfg, opt, n, step_fn, steps=2, seed=1, shape=SHAPE):
    params = init_model(cfg, "cpu", seed=seed)
    state, losses = opt.init(params, n), []
    for s in range(steps):
        params, state, met = step_fn(params, state, _batch(cfg, s, shape),
                                     prng.fold_in(prng.PRNGKey(0), s))
        losses.append(met["loss"])
    return losses, params, state


@pytest.mark.parametrize("method", METHODS)
def test_perleaf_trainer_bitwise_bucketed(method):
    cfg = _config(compression=method, comp_k=512)
    runs = {}
    for bucketed in (True, False):
        c = replace(cfg, comp_bucketed=bucketed)
        opt = train.make_optimizer(c, lr=3e-4)
        assert opt.compression.bucketed == bucketed
        runs[bucketed] = _train(c, opt, N, train.build_train_step(c, opt, N, "cpu"))
    (b_loss, b_params, b_state), (l_loss, l_params, l_state) = runs[True], runs[False]
    assert all(torch.equal(a, b) for a, b in zip(b_loss, l_loss))
    assert all(torch.equal(b_params[p], l_params[p]) for p in b_params)
    hw, hs = l_state.diana.h_worker, l_state.diana.h_server
    assert isinstance(hw, dict) and hw["embed"].shape == (N, b_params["embed"].numel())
    lay = bucket_layout(TCfg(method=method, k=512, bucketed=True), b_params)
    for p, off, size in zip(lay.paths, lay.offsets, lay.sizes):
        assert torch.equal(b_state.diana.h_worker[:, off:off + size], hw[p]), p
        assert torch.equal(b_state.diana.h_server[off:off + size], hs[p]), p


def _per_worker_grads(cfg, params, batch):
    paths = sorted(params)
    rows = batch["tokens"].shape[0] // N
    per_worker = [torch.autograd.grad(
        train_loss(params, {k: v[w * rows:(w + 1) * rows] for k, v in batch.items()}, cfg),
        [params[p] for p in paths]) for w in range(N)]
    return {p: torch.stack([g[i] for g in per_worker]) for i, p in enumerate(paths)}


def _same_state(a, b):
    if b is None:
        return a is None
    if isinstance(b, dict):
        return sorted(a) == sorted(b) and all(_same_state(a[k], b[k]) for k in b)
    if isinstance(b, list):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("policy", ["default", MIXED], ids=["curated", "mixed"])
def test_grouped_trainer_equals_reference_step(policy):
    """The grouped in-turn round leaves the memories (and ``h_down``) of the
    port's ``reference_step`` with the same policy on the same gradients,
    and its ghat, bit for bit over 2 steps."""
    cfg = _config()
    params = init_model(cfg, "cpu", seed=1)
    opt = train.make_optimizer(cfg, lr=3e-4, policy=policy)
    assert not opt.policy.is_uniform
    state = opt.init(params, N)
    step_fn = train.build_train_step(cfg, opt, N, "cpu")
    ref = reference_init({p: v.detach() for p, v in params.items()}, opt.policy, N)
    for s in range(2):
        batch = _batch(cfg, s)
        key = prng.fold_in(prng.PRNGKey(0), s)
        ghat, ref = reference_step(_per_worker_grads(cfg, params, batch), ref, key, opt.policy)
        params, state, met = step_fn(params, state, batch, key)
        for name in ("h_worker", "h_server", "h_down"):
            assert _same_state(getattr(state.diana, name), getattr(ref, name)), name
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in ghat.values()))
        assert torch.equal(met["ghat_norm"], norm)
    assert sorted(state.diana.h_worker) == ["g00_identity", "g01_topk_ef", "g02_ternary"]


@pytest.fixture(scope="module")
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("policy,vr", [("default", False), (MIXED, True)],
                         ids=["curated", "mixed-vr"])
def test_world_of_one_grouped_bitwise_in_turn(world_of_one, policy, vr):
    """At world 1 the distributed grouped trainer (the identity group's
    all-reduce of one term, the per-group downlinks, VR's forced refresh
    and coins) is the in-turn trainer at n = 1 bit for bit."""
    cfg = _config(**(dict(vr=True, vr_p=0.5) if vr else {}))
    opt = train.make_optimizer(cfg, lr=3e-4, policy=policy)
    assert opt.policy.vr == vr
    shape = ShapeConfig("t", 16, 2, "train")
    t_loss, t_params, t_state = _train(cfg, opt, 1, train.build_train_step(cfg, opt, 1, "cpu"),
                                       shape=shape)
    d_loss, d_params, d_state = _train(cfg, opt, 1, train.build_distributed_step(cfg, opt),
                                       shape=shape)
    assert all(torch.equal(a, b) for a, b in zip(d_loss, t_loss))
    assert all(torch.equal(d_params[p], t_params[p]) for p in t_params)
    for name in ("h_worker", "h_server", "h_down"):
        assert _same_state(getattr(d_state.diana, name), getattr(t_state.diana, name)), name
    if vr:
        assert _same_state(d_state.diana.vr.snapshot, t_state.diana.vr.snapshot)
        assert _same_state(d_state.diana.vr.mu, t_state.diana.vr.mu)


# ------------------------------------------------------------------ optimizer


@pytest.mark.parametrize("reg", ["l1", "l2"])
def test_optimizer_prox_bitwise_jax(reg):
    """``apply_direction`` with a regularizer: momentum, the write-back and
    ``prox_{lr R}`` with lr the schedule's f32 value, bit for bit the JAX
    optimizer's (eager), three steps, on f32 parameters."""
    lam, lr = 0.37, 0.1
    j_reg, t_reg = {"l1": (j_l1(lam), t_l1(lam)), "l2": (j_l2(lam), t_l2(lam))}[reg]
    rng = np.random.default_rng(5)
    x0 = {"a": rng.standard_normal((7, 5)).astype(np.float32),
          "b": rng.standard_normal((11,)).astype(np.float32)}
    x0["a"][0, :3] = 0.0
    jopt = JOptimizer(JCfg(), j_momentum(0.9), schedule=j_constant(lr), regularizer=j_reg)
    topt = DianaOptimizer(TCfg(), momentum(0.9), schedule=constant_schedule(lr),
                          regularizer=t_reg)
    jparams = {p: jnp.asarray(v) for p, v in x0.items()}
    tparams = {p: torch.nn.Parameter(torch.from_numpy(v.copy())) for p, v in x0.items()}
    js, ts = jopt.init(jparams, 1), topt.init(tparams, 1)
    for s in range(3):
        ghat = {p: rng.standard_normal(v.shape).astype(np.float32) for p, v in x0.items()}
        jparams, js = jopt.apply_direction(jparams, {p: jnp.asarray(g) for p, g in ghat.items()},
                                           js, js.diana)
        ts = topt.apply_direction(tparams, {p: torch.from_numpy(g) for p, g in ghat.items()},
                                  ts, ts.diana)
        for p in x0:
            got, want = tparams[p].detach().numpy(), np.asarray(jparams[p])
            assert got.tobytes() == want.tobytes(), (reg, s, p, float(np.abs(got - want).max()))
    assert ts.step == 3 and int(js.step) == 3


def test_optimizer_refresh_snapshot_bitwise_jax():
    """``refresh_snapshot`` moves every worker's snapshot to the parameters
    and its mu to the given rows, as the JAX optimizer's does; it needs a
    VR policy, and both surfaces (``compression=`` / ``policy=``) are
    exclusive."""
    rng = np.random.default_rng(6)
    shapes = {"a": (4, 3), "b": (5,)}
    x = {p: rng.standard_normal(s).astype(np.float32) for p, s in shapes.items()}
    mu = {p: rng.standard_normal((3, *s)).astype(np.float32) for p, s in shapes.items()}
    jpol = JP.CompressionPolicy(vr=True, vr_p=0.5)
    tpol = TP.CompressionPolicy(vr=True, vr_p=0.5)
    jopt, topt = JOptimizer(policy=jpol, inner=j_momentum()), DianaOptimizer(policy=tpol)
    js = jopt.init({p: jnp.zeros(s) for p, s in shapes.items()}, 3)
    ts = topt.init({p: torch.zeros(s) for p, s in shapes.items()}, 3)
    js = jopt.refresh_snapshot(js, {p: jnp.asarray(v) for p, v in x.items()},
                               {p: jnp.asarray(v) for p, v in mu.items()})
    ts = topt.refresh_snapshot(ts, {p: torch.from_numpy(v) for p, v in x.items()},
                               {p: torch.from_numpy(v) for p, v in mu.items()})
    for p in shapes:
        for got, want in ((ts.diana.vr.snapshot[p], js.diana.vr.snapshot[p]),
                          (ts.diana.vr.mu[p], js.diana.vr.mu[p])):
            assert got.numpy().tobytes() == np.asarray(want).tobytes(), p
    with pytest.raises(ValueError, match="vr"):
        DianaOptimizer(TCfg()).refresh_snapshot(
            DianaOptimizer(TCfg()).init({"a": torch.zeros(2)}, 1), {}, {})
    with pytest.raises(ValueError, match="not both"):
        DianaOptimizer(TCfg(), policy=tpol)


# ------------------------------------------------------------------------ CLI


def _cli(tmp_path, *flags):
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x1",
            "--steps", "1", "--batch", "2", "--seq", "16", *flags]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    lines = [l for l in buf.getvalue().splitlines() if l.startswith("step")]
    assert len(lines) == 1 and math.isfinite(float(lines[0].split()[3])), buf.getvalue()


@pytest.mark.parametrize("flags", [
    ("--per-leaf-agg",),
    ("--per-leaf-agg", "--compression", "topk_ef", "--comp-k", "64", "--down-method", "diana"),
    ("--comp-policy", "default"),
    ("--comp-policy", "default", "--per-leaf-agg", "--vr"),
    ("--comp-policy", "size-adaptive"),
    ("--comp-policy", "norm=identity,mixer=natural/randk:k=16,*=diana:block=256"),
    ("--comp-policy", "policy.json"),
], ids=["per-leaf", "per-leaf-topk-down", "policy-default", "policy-perleaf-vr",
        "size-adaptive", "inline", "json"])
def test_cli_trains(tmp_path, monkeypatch, flags):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if "policy.json" in flags:
        pol = TP.CompressionPolicy(rules=TP.parse_rules(MIXED), bucketed=True)
        (tmp_path / "policy.json").write_text(pol.to_json())
        flags = tuple(str(tmp_path / f) if f == "policy.json" else f for f in flags)
    _cli(tmp_path, *flags)


def test_resolve_policy_arg_surfaces(tmp_path):
    """``resolve_policy_arg``: the curated default (with the model-wide
    layout), size-adaptive over the model's own tree, and a model without a
    curated policy refused."""
    cfg = _config()
    pol = train.resolve_policy_arg(cfg, "default")
    assert [r.pattern for r in pol.rules] == ["scale$|bias", "^embed$|^lm_head$", ".*"]
    assert pol.bucketed and pol.rules[1].spec.k == 256
    per_leaf = train.resolve_policy_arg(replace(cfg, comp_bucketed=False), "default")
    assert not per_leaf.bucketed
    sa = train.resolve_policy_arg(cfg, "size-adaptive")
    assert [r.name for r in sa.rules] == ["small", "bulk"] and sa.rules[1].spec.method == "diana"
    with pytest.raises(ValueError, match="no default"):
        train.resolve_policy_arg(replace(cfg, comp_policy=None), "default")
