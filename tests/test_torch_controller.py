"""Telemetry and the bit-budget controller of the port
(``repro_torch.core.telemetry``, ``repro_torch.core.controller``) against
the JAX package's, on ``reduced(llama3.2-1b)``'s tree and its curated policy.

* ``measure``: the per-group ``m2`` / ``var`` within 2e-6 relative of the
  JAX package's (f32 sums of the same terms in another order: torch's
  ``sum`` and ``dot`` against XLA's reductions), for a flat config and the
  grouped policy; ``telemetry=True`` on ``reference_step`` is a pure
  observer (the same bits) and gives ``measure`` of the served direction.
* ``ema_update`` / ``ema_read`` bit for bit the JAX package's eager calls,
  degraded samples included.
* ``spec_omega``, ``default_lattice`` and ``allocate`` (exhaustive, and
  greedy with the exhaustive limit lowered in both packages) equal the JAX
  package's.
* ``maybe_reallocate`` over the same sample sequence (warmup 2, interval 3,
  hysteresis 0.1, frozen degraded samples, energies that swap) switches at
  the same steps to the same policies.
* ``migrate_diana_state`` carries and re-zeroes the same memories as the JAX
  package's, frees what it re-zeroes, and the metadata round-trips into the
  JAX package's dict.
* The in-turn trainer with ``--budget-bits-per-dim``, ``--controller-interval``
  and ``--warmup-dense-steps``: the JAX controller fed the port's telemetry
  switches at the same steps to the same policies; ``--faults`` with a
  budget exits.
"""

import contextlib
import io
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import controller as JC
from repro.core import policy as JPol
from repro.core import telemetry as JT
from repro.core.diana import init_state as j_init_state
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import controller as TC
from repro_torch.core import policy as TPol
from repro_torch.core import prng
from repro_torch.core import telemetry as TT
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import init_state as t_init_state, reference_init, reference_step
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import train
from repro_torch.models.transformer import init_model

RTOL = 2e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return replace(reduced(get_config("llama3.2-1b")), d_model=64, n_heads=2, n_kv_heads=1,
                   head_dim=32, d_ff=128)


def _trees():
    """The port's parameter tree and the JAX package's nested tree of the
    same shapes (its flatten order is the port's path order)."""
    params = init_model(_cfg(), "cpu", seed=0)
    nested = {}
    for p, v in params.items():
        node = nested
        *head, last = p.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.zeros(v.shape, jnp.float32)
    return {p: v.detach() for p, v in params.items()}, nested


def _nested(flat):
    out = {}
    for p, v in flat.items():
        node = out
        *head, last = p.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v.numpy())
    return out


def _policies(**kw):
    rules = get_config("llama3.2-1b").comp_policy
    assert rules == j_get_config("llama3.2-1b").comp_policy
    return (TPol.CompressionPolicy(rules=TPol.parse_rules(rules), bucketed=True, **kw),
            JPol.CompressionPolicy(rules=JPol.parse_rules(rules), bucketed=True, **kw))


def _ghat(params, seed=0):
    rng = np.random.default_rng(seed)
    return {p: torch.from_numpy((rng.standard_normal(v.shape) * (1 + i % 3)).astype(np.float32)
                                + np.float32(0.01 * i))
            for i, (p, v) in enumerate(params.items())}


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert np.all(np.abs(a - b) <= RTOL * np.abs(b) + 1e-30), (what, a, b)


# ------------------------------------------------------------ telemetry


def test_measure_matches_jax_flat_and_grouped():
    params, _ = _trees()
    tpol, jpol = _policies()
    for seed in range(3):
        g = _ghat(params, seed)
        jg = _nested(g)
        for tspec, jspec in ((None, None), (TCfg(), None), (tpol, jpol)):
            t, j = TT.measure(tspec, g), JT.measure(jspec, jg)
            _close(t.m2, j.m2, "m2")
            _close(t.var, j.var, "var")
            assert t.ok and bool(j.ok)
            assert TT.telemetry_group_names(tspec, g) == JT.telemetry_group_names(jspec, jg)
            assert TT.group_dims(tspec, g) == JT.group_dims(jspec, jg)
    assert not TT.measure(tpol, g, ok=False).ok


def test_reference_step_telemetry_is_a_pure_observer():
    params, _ = _trees()
    tpol, _ = _policies()
    g = {p: torch.stack([x, 2 * x, -x, x / 2]) for p, x in _ghat(params).items()}
    for spec in (TCfg(method="diana", bucketed=True), tpol):
        a = reference_step(g, reference_init(params, spec, 4), prng.PRNGKey(1), spec)
        b = reference_step(g, reference_init(params, spec, 4), prng.PRNGKey(1), spec,
                           telemetry=True)
        assert all(torch.equal(a[0][p], b[0][p]) for p in params)
        want = TT.measure(spec if isinstance(spec, TPol.CompressionPolicy) else None, b[0])
        assert torch.equal(b[2].m2, want.m2) and torch.equal(b[2].var, want.var)


def test_ema_update_and_read_bitwise_jax():
    rng = np.random.default_rng(4)
    te, je = TT.init_ema(3), JT.init_ema(3)
    for step in range(60):
        m2 = (rng.random(3) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
        var = (m2 * rng.random(3)).astype(np.float32)
        ok = step % 7 != 3
        te = TT.ema_update(te, TT.GroupTelemetry(torch.from_numpy(m2), torch.from_numpy(var),
                                                 ok))
        je = JT.ema_update(je, JT.GroupTelemetry(jnp.asarray(m2), jnp.asarray(var),
                                                 jnp.asarray(ok)))
        assert te.count == int(je.count)
        for a, b in ((te.m2, je.m2), (te.var, je.var)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), step
        for a, b in zip(TT.ema_read(te), JT.ema_read(je)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), step


# ----------------------------------------------------------- controller


def test_omega_lattice_and_allocate_equal_jax(monkeypatch):
    params, nested = _trees()
    tpol, jpol = _policies()
    tlat, jlat = TC.default_lattice(tpol), JC.default_lattice(jpol)
    assert [[c.__dict__ for c in r] for r in tlat] == [[c.__dict__ for c in r] for r in jlat]
    for rule_t, rule_j in zip(tlat, jlat):
        for ct, cj in zip(rule_t, rule_j):
            cfg_t = tpol.with_rule_specs([ct] * len(tpol.rules)).rule_config(0)
            cfg_j = jpol.with_rule_specs([cj] * len(jpol.rules)).rule_config(0)
            for sizes in ((64,), (4096, 300, 17), (1 << 20,)):
                assert TC.spec_omega(cfg_t, sizes) == JC.spec_omega(cfg_j, sizes)
    energies = [(1e-4, 2e-3, 5e-2), (3.0, 1e-6, 0.2), (0.0, 0.0, 0.0)]
    for greedy in (False, True):
        if greedy:
            monkeypatch.setattr(TC, "_EXHAUSTIVE_LIMIT", 1)
            monkeypatch.setattr(JC, "_EXHAUSTIVE_LIMIT", 1)
        for budget in (0.7, 1.0, 2.5, 9.0, 32.0):
            tctl = TC.BudgetController(base=tpol, budget_bits_per_dim=budget)
            jctl = JC.BudgetController(base=jpol, budget_bits_per_dim=budget)
            for e in energies:
                ts = TC.ControllerState(ema_m2=e, ema_var=e, count=3)
                js = JC.ControllerState(ema_m2=e, ema_var=e, count=3)
                choice = TC.allocate(tctl, ts, params)
                assert choice == JC.allocate(jctl, js, nested), (greedy, budget, e)
                tp = tctl.policy_for(choice)
                assert tp.to_json_dict() == {k: v for k, v in
                                             jctl.policy_for(choice).to_json_dict().items()
                                             if k != "worker_axes"}
                assert TPol.policy_bits_per_dim(tp, params) <= budget + 1e-9
    with pytest.raises(ValueError, match="infeasible"):
        TC.allocate(TC.BudgetController(base=tpol, budget_bits_per_dim=0.01),
                    TC.ControllerState(ema_m2=(1.0,) * 3, ema_var=(0.0,) * 3), params)


def _samples(steps=30, seed=9):
    """The embedding group quiet and the bulk loud for 10 steps, then the
    reverse, with noise; every 11th sample degraded."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        energy = np.array([1.0, 1e-6, 1.0] if s < 10 else [1.0, 1.0, 1e-6])
        m2 = (energy * (0.5 + rng.random(3))).astype(np.float32)
        out.append((m2, (m2 * 0.3).astype(np.float32), s % 11 != 6))
    return out


def test_maybe_reallocate_switches_like_jax():
    """A lattice where the budget (8.5 bits per coordinate) affords the
    natural operator on the embedding group or on the bulk, not both: the
    first allocation after the warmup, then a switch once the energies
    swap, at the same steps and to the same policies as the JAX
    controller."""
    params, nested = _trees()
    tpol, jpol = _policies()
    lattices = [tuple((cls("identity"),) if i == 0 else (cls(*first), cls("natural"))
                      for i, first in enumerate((None, ("topk_ef", 256),
                                                 ("diana",))))
                for cls in (TPol.ChannelSpec, JPol.ChannelSpec)]
    kw = dict(budget_bits_per_dim=8.5, interval=3, warmup_dense_steps=2, hysteresis=0.1)
    tctl = TC.BudgetController(base=tpol, lattice=lattices[0], **kw)
    jctl = JC.BudgetController(base=jpol, lattice=lattices[1], **kw)
    assert tctl.warmup_policy().to_json_dict()["rules"] == \
        jctl.warmup_policy().to_json_dict()["rules"]
    ts, js = TC.init_controller_state(tctl, params), JC.init_controller_state(jctl, nested)
    switches = []
    for step, (m2, var, ok) in enumerate(_samples()):
        ts = TC.observe(tctl, ts, TT.GroupTelemetry(torch.from_numpy(m2),
                                                    torch.from_numpy(var), ok))
        js = JC.observe(jctl, js, JT.GroupTelemetry(jnp.asarray(m2), jnp.asarray(var),
                                                    jnp.asarray(ok)))
        ts, tp = TC.maybe_reallocate(tctl, ts, params)
        js, jp = JC.maybe_reallocate(jctl, js, nested)
        assert TC.controller_metadata(tctl, ts) == JC.controller_metadata(jctl, js), step
        assert (tp is None) == (jp is None), step
        if tp is not None:
            assert tp.to_json_dict()["rules"] == jp.to_json_dict()["rules"]
            switches.append(step)
    assert switches == [1, 10], switches   # the first allocation, then the swap


def test_migrate_carries_and_rezeros_like_jax():
    params, nested = _trees()
    tpol, jpol = _policies()
    n = 2
    choice = (1, 0, 0)   # the identity group as natural: the same shape
    for new_choice in ((0, 0, 0), (0, 2, 1), (1, 4, 4), (1, 3, 3)):
        tctl = TC.BudgetController(base=tpol, budget_bits_per_dim=4.0)
        jctl = JC.BudgetController(base=jpol, budget_bits_per_dim=4.0)
        t_old = t_init_state(params, tctl.policy_for(choice), n)
        j_old = j_init_state(nested, jctl.policy_for(choice), n)
        for tree in (t_old.h_worker, t_old.h_server):
            for v in tree.values():
                for x in (v if isinstance(v, list) else [v]):
                    x.fill_(1.0)
        j_old = jax.tree_util.tree_map(jnp.ones_like, j_old)
        carried = []
        t_new = TC.migrate_diana_state(t_old, params, tctl.policy_for(new_choice), n, carried)
        j_new = JC.migrate_diana_state(j_old, nested, jctl.policy_for(new_choice), n)
        j_carried = {"/".join(JC._path_str(k) for k in path)
                     for path, leaf in jax.tree_util.tree_flatten_with_path(j_new)[0]
                     if bool(jnp.all(leaf == 1.0))}
        assert set(carried) == j_carried, (new_choice, carried, j_carried)
        for name in ("h_worker", "h_server"):
            for g, v in getattr(t_new, name).items():
                j = getattr(j_new, name)[g]
                assert tuple(v.shape) == tuple(j.shape) and bool((v == 1).all()) == bool(
                    jnp.all(j == 1)), (name, g)
        # a re-zeroed memory's old storage is freed before its zeros exist
        for name in ("h_worker", "h_server"):
            for g, v in getattr(t_old, name).items():
                if f"{name}/{g}" not in carried:
                    assert v.untyped_storage().nbytes() == 0


def test_metadata_round_trips_into_jax_dict():
    tpol, jpol = _policies()
    tctl = TC.BudgetController(base=tpol, budget_bits_per_dim=1.5, interval=7,
                               warmup_dense_steps=3)
    jctl = JC.BudgetController(base=jpol, budget_bits_per_dim=1.5, interval=7,
                               warmup_dense_steps=3)
    st = TC.ControllerState(step=12, last_switch=9, choice=(0, 2, 1), ema_m2=(0.5, 1e-3, 2.0),
                            ema_var=(0.1, 0.0, 0.4), count=11)
    doc = TC.controller_metadata(tctl, st)
    jst = JC.state_from_metadata(doc)
    assert JC.controller_metadata(jctl, jst) == doc
    assert TC.state_from_metadata(JC.controller_metadata(jctl, jst)) == st


# -------------------------------------------------------------- trainer


def test_trainer_controller_switches_like_jax_on_port_telemetry():
    """Five in-turn steps at n = 4 under the curated policy with a budget of
    1 bit per coordinate, interval 1, one dense warmup step: the port's
    controller ticks, and the JAX controller fed the same telemetry
    switches at the same steps to the same policies."""
    cfg = replace(_cfg(), comp_k=512)
    params0 = init_model(cfg, "cpu", seed=1)
    opt = train.make_optimizer(cfg, lr=3e-4, policy="default")
    _, jpol = _policies()
    kw = dict(budget_bits_per_dim=1.0, interval=1, warmup_dense_steps=1)
    tctl = TC.BudgetController(base=opt.policy, **kw)
    jctl = JC.BudgetController(base=jpol, **kw)
    opt = train._with_policy(opt, tctl.warmup_policy())
    params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in params0.items()}
    state = opt.init(params, 4)
    build = lambda o: train.build_train_step(cfg, o, 4, "cpu", telemetry=True)  # noqa: E731
    step_fn = build(opt)
    ts = TC.init_controller_state(tctl, params)
    _, nested = _trees()
    js = JC.init_controller_state(jctl, nested)
    policies = []
    for s in range(5):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_lm_batch(cfg, ShapeConfig("t", 16, 4, "train"), s).items()}
        params, state, met = step_fn(params, state, batch, prng.fold_in(prng.PRNGKey(0), s))
        assert met["telemetry_m2"].shape == (3,) and met["telemetry_ok"] is True
        before = opt.policy
        with contextlib.redirect_stdout(io.StringIO()):
            opt, state, step_fn, ts = train.controller_tick(tctl, ts, opt, state, step_fn, met,
                                                            params, 4, build)
        js = JC.observe(jctl, js, JT.GroupTelemetry(jnp.asarray(met["telemetry_m2"].numpy()),
                                                    jnp.asarray(met["telemetry_var"].numpy()),
                                                    jnp.asarray(True)))
        js, jp = JC.maybe_reallocate(jctl, js, nested)
        switched = opt.policy != before
        assert switched == (jp is not None), s
        if switched:
            assert opt.policy.to_json_dict()["rules"] == jp.to_json_dict()["rules"]
            assert TPol.policy_bits_per_dim(opt.policy, params) <= 1.0
            policies.append(s)
        assert math.isfinite(float(met["loss"]))
    assert policies and policies[0] == 0   # the first allocation after the dense step


def test_cli_budget_flags_and_faults_refusal():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x1",
                    "--steps", "2", "--batch", "2", "--seq", "16", "--comp-policy", "default",
                    "--budget-bits-per-dim", "1.0", "--controller-interval", "1",
                    "--warmup-dense-steps", "1"])
    assert "controller: switching policy at step 1" in buf.getvalue()
    with pytest.raises(SystemExit, match="faults"):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x1",
                    "--steps", "1", "--budget-bits-per-dim", "1.0", "--faults", "checksum"])
