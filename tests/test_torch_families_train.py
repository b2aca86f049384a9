"""The in-turn trainer (``build_train_step``, 4 workers, 2 steps) on the new
model families and the optimizer tail, held to the JAX package's pieces on
the CPU:

* reduced ``granite-moe-3b-a800m`` with ``--comp-policy default --inner
  adamw``: its curated policy's four groups (identity on the router and the
  norm scales, top-k EF on ``embed`` / ``lm_head``, natural on the experts,
  ternary on attention);
* reduced ``nemotron-4-15b`` (squared ReLU) with its DIANA memories in bf16
  (``h_dtype``), flat ``diana``, momentum.

Each step is compared from the port's own state and on the port's own
per-worker gradients (``train_loss`` on each worker's rows), so the round
and the optimizer can be held bit for bit:

* the memories against the jitted JAX ``reference_step`` with the JAX
  policy (or flat config) fed the same gradients, state and key.  The JAX
  reference keeps f32 memories; the JAX distributed round reads an
  ``h_dtype`` memory in f32 and rounds the result back
  (``repro/core/diana.py:660-663``), so the bf16 state enters widened and
  the JAX result is rounded to bf16.  Bitwise for the identity, top-k EF
  and ternary groups; the natural group within the JAX package's CPU
  ``exp2`` error (``EXP2_RTOL`` of the memory's largest magnitude: a decode
  carries it, and a sum over workers can cancel, as
  ``tests/test_torch_distributed.py`` holds natural decodes);
* the parameters and the inner state against eager JAX ``adamw`` /
  ``momentum`` applied to the port's ``ghat`` (its ``reference_step``,
  bitwise the trainer's round) and ``(p + u)`` written back: bitwise;
* the step-0 loss against JAX ``value_and_grad(train_loss)`` with the same
  (JAX-initialised) weights, at rtol 1e-5.

The bf16 round must feed the server rule an f32 memory (the apply kernels'
contract, which the card enforces): the apply ops are wrapped to check it.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import policy as JP
from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import ReferenceState as JRef, reference_step as j_step
from repro.models import init_model as j_init_model, train_loss as j_train_loss
from repro.optim import optimizers as JO
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.core.diana import ReferenceState, reference_step
from repro_torch.core.tree import flatten_nested
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models.transformer import train_loss

N, STEPS, LR = 4, 2, 3e-4
SHAPE = ShapeConfig("t", 32, 8, "train")
EXP2_RTOL = 4.1e-6
NATURAL = "g02_natural"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_apply(monkeypatch):
    """Every call of an apply op (the server rule fused into the decode)
    records the dtype of the memory it was given."""
    seen = []
    for name in ("unpack_reduce_apply_op", "nat_decode_sum_apply_op"):
        orig = getattr(ops, name)

        def wrapped(*a, _orig=orig, **kw):
            h = a[2] if len(a) > 2 else (a[1] if len(a) == 2 else kw["h"])
            seen.append(h.dtype)
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)
    return seen


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _j(t):
    return jnp.asarray(_np(t))


def _per_worker_grads(cfg, params, batch):
    paths = sorted(params)
    rows = batch["tokens"].shape[0] // N
    per_worker = [torch.autograd.grad(
        train_loss(params, {k: v[w * rows:(w + 1) * rows] for k, v in batch.items()}, cfg),
        [params[p] for p in paths]) for w in range(N)]
    return {p: torch.stack([g[i] for g in per_worker]) for i, p in enumerate(paths)}


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_clone(v) for v in x)
    if hasattr(x, "_fields"):
        return type(x)(*[_clone(v) for v in x])
    return x


def _jtree(x):
    """A port state slot (tensor or dict of tensors) as f32 JAX arrays."""
    if isinstance(x, dict):
        return {k: _jtree(v) for k, v in x.items()}
    return _j(x)


def _check_memory(got, want, name, natural):
    """``got`` (port, in its dtype) against the JAX f32 result rounded to
    the port's dtype: bitwise, or for the natural group within EXP2_RTOL of
    the magnitudes."""
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        want_t = torch.from_numpy(want.astype(np.float32)).to(torch.bfloat16)
        assert torch.equal(got, want_t), name
        return
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, name
    if natural:   # the decodes' exp2 error, of the memory's largest magnitude
        room = EXP2_RTOL * np.abs(want).max()
        assert np.abs(g - want).max() <= room, (name, float(np.abs(g - want).max()), room)
    else:
        assert g.tobytes() == want.tobytes(), (name, float(np.abs(g - want).max()))


def _run(arch, policy, inner, f32_apply):
    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jparams = j_init_model(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    opt = train.make_optimizer(tcfg, lr=LR, inner=inner, policy=policy)
    state = opt.init(params, N)
    step_fn = train.build_train_step(tcfg, opt, N, "cpu")
    if policy is None:
        jspec = JCfg(method=tcfg.compression, p=jcfg.comp_p, block_size=jcfg.comp_block,
                     k=jcfg.comp_k, bucketed=True, use_kernel=False)
    else:
        jspec = JP.load_policy(jcfg.comp_policy, bucketed=True)
    jagg = jax.jit(lambda g, s, k: j_step(g, s, k, jspec))
    jinner = JO.adamw() if inner == "adamw" else JO.momentum(0.9)
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(tcfg, SHAPE, s).items()}
        key = prng.fold_in(prng.PRNGKey(0), s)
        jkey = jax.random.fold_in(jax.random.PRNGKey(0), s)
        grads = _per_worker_grads(tcfg, params, batch)
        before_p, before = _clone(params), _clone(state)
        params, state, met = step_fn(params, state, batch, key)
        if s == 0:
            rows = SHAPE.global_batch // N
            jloss = jax.jit(lambda p, b: j_train_loss(p, b, jcfg))
            jl = [float(jloss(jparams, {k: jnp.asarray(v[w * rows:(w + 1) * rows])
                                        for k, v in make_lm_batch(tcfg, SHAPE, 0).items()}))
                  for w in range(N)]
            np.testing.assert_allclose(float(met["loss"]), np.mean(jl), rtol=1e-5)
        # the round: JAX reference_step from the port's state, on its gradients
        d = before.diana
        jstate = JRef(h_worker=_jtree(d.h_worker), h_server=_jtree(d.h_server),
                      v=jax.tree_util.tree_map(jnp.zeros_like, {p: _j(g[0]) for p, g in
                                                                 grads.items()}))
        _, js = jagg({p: _j(g) for p, g in grads.items()}, jstate, jkey)
        for name in ("h_worker", "h_server"):
            got, want = getattr(state.diana, name), getattr(js, name)
            if isinstance(got, dict):
                assert sorted(got) == sorted(want), name
                for gname in got:
                    _check_memory(got[gname], want[gname], f"{name}/{gname} step {s}",
                                  gname == NATURAL)
            else:
                _check_memory(got, want, f"{name} step {s}", False)
        # the optimizer: eager JAX on the port's ghat, bitwise
        ref = ReferenceState(h_worker=_clone(d.h_worker), h_server=_clone(d.h_server),
                             v={p: torch.zeros_like(g[0]) for p, g in grads.items()})
        ghat, _ = reference_step(grads, ref, key, opt.policy)
        lr = jnp.float32(LR)
        jin = before.inner
        if inner == "adamw":
            jin = JO.AdamState(mu=_jtree(jin.mu), nu=_jtree(jin.nu),
                               count=jnp.asarray(jin.count, jnp.int32))
        else:
            jin = _jtree(jin)
        ups, jin = jinner.update({p: _j(g) for p, g in ghat.items()}, jin,
                                 {p: _j(v) for p, v in before_p.items()}, lr)
        for p in params:
            want = (_j(before_p[p]) + ups[p]).astype(jnp.float32)
            assert np.asarray(want).tobytes() == _np(params[p]).tobytes(), (p, s)
        inner_state = state.inner if inner != "adamw" else {"mu": state.inner.mu,
                                                            "nu": state.inner.nu}
        jin_d = jin if inner != "adamw" else {"mu": jin.mu, "nu": jin.nu}
        for k, v in flatten_nested(inner_state).items():
            assert np.asarray(flatten_nested(jin_d)[k]).tobytes() == _np(v).tobytes(), (k, s)
    assert f32_apply and all(dt == torch.float32 for dt in f32_apply), set(f32_apply)
    return state


def test_granite_moe_curated_policy_adamw_in_turn(f32_apply):
    state = _run("granite-moe-3b-a800m", "default", "adamw", f32_apply)
    assert sorted(state.diana.h_worker) == ["g00_identity", "g01_topk_ef", NATURAL,
                                            "g03_ternary"]
    assert state.inner.count == STEPS


def test_nemotron_bf16_memories_in_turn(f32_apply):
    """The bf16-memory config: the held memories stay bf16 and the server
    rule reads them in f32 (this fails where the in-turn round hands the
    held bf16 ``h_server`` to ``unpack_reduce_apply``)."""
    state = _run("nemotron-4-15b", None, "momentum", f32_apply)
    assert state.diana.h_worker.dtype == state.diana.h_server.dtype == torch.bfloat16
    assert state.diana.h_server.abs().sum() > 0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-130m"])
def test_curated_policies_partition_like_jax(arch):
    """The curated policies of the MoE and the SSM configs put the same
    leaves into the same groups as the JAX ``PolicyPartition`` on the JAX
    tree, full and reduced."""
    from repro_torch.core import policy as TP
    from repro_torch.models.transformer import meta_params
    for red in (False, True):
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        if red:
            jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
        jtree = jax.eval_shape(lambda k: j_init_model(jcfg, k), jax.random.PRNGKey(0))
        ttree = meta_params(tcfg)
        jpol = JP.load_policy(jcfg.comp_policy, bucketed=True)
        tpol = TP.load_policy(tcfg.comp_policy, bucketed=True)
        jpart, tpart = JP.partition_for(jpol, jtree), TP.partition_for(tpol, ttree)
        assert tpart.group_names == jpart.group_names
        assert tpart.group_leaf_ids == jpart.group_leaf_ids
        assert tpart.rule_ids == jpart.rule_ids
        jlay, tlay = JP.grouped_bucket_layout(jpol, jtree), TP.grouped_bucket_layout(tpol, ttree)
        assert [l.sizes for l in tlay.layouts] == [l.sizes for l in jlay.layouts]
        assert TP.policy_bits_per_dim(tpol, ttree) == JP.policy_bits_per_dim(jpol, jtree)


def test_cli_runs_the_new_families(capsys):
    """``--arch granite-moe-3b-a800m --comp-policy default --inner adamw``
    and a frontend model on the CPU."""
    train.main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu", "--mesh",
                "4x1", "--steps", "2", "--batch", "8", "--seq", "32", "--comp-policy",
                "default", "--inner", "adamw"])
    train.main(["--arch", "internvl2-2b", "--reduced", "--device", "cpu", "--mesh", "2x1",
                "--steps", "1", "--batch", "2", "--seq", "48"])
    out = capsys.readouterr().out
    assert out.count("step    0 loss") == 2 and "step    1 loss" in out
