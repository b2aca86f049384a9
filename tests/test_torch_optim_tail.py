"""The optimizer tail against ``repro.optim.optimizers``: ``adamw`` (with
and without weight decay) over several steps, and the decreasing and
warmup-cosine schedules, on numpy-seeded f32 inputs.

* Eager JAX (op by op): ``adamw``'s updates and its ``mu`` / ``nu`` are
  bit for bit the JAX package's, and so are both schedules' values: the
  port spells out each of its roundings (``tests`` of the rounding order:
  ``repro_torch/optim/optimizers.py``).
* Jitted JAX: XLA may contract a product into a sum (one rounding where
  eager JAX has two), which under cancellation moves the result by more
  than an ulp of it.  So from the same state (the JAX state carried into
  each step), ``mu`` / ``nu`` are held within one f32 rounding of the
  product they contract (``2^-24 * (|b m| + |(1 - b) g|)``, plus one of
  the result), and the update within what that moves it (``lr / bc1 /
  (sqrt(nu / bc2) + eps)`` times mu's room) plus rtol 1e-6; the schedules
  within 2 ulps.
* ``mu`` / ``nu`` are updated in place (the buffers ``init`` made), and the
  update takes the learning rate as a float or a 0-dim f32 tensor.
* ``AdamState`` converts from the JAX package (``convert.adam_state_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as J
from repro_torch.convert import adam_state_from_jax
from repro_torch.optim import optimizers as T

STEPS = 5
SHAPES = {"w": (33, 17), "b": (40,)}


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
            for k, s in SHAPES.items()}


def _params():
    rng = np.random.default_rng(7)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["eager", "jit"])
def test_adamw_matches_jax(wd, mode):
    params = _params()
    jopt, topt = J.adamw(weight_decay=wd), T.adamw(weight_decay=wd)
    jst = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    tpar = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = topt.init(tpar)
    bufs = (dict(tst.mu), dict(tst.nu))
    jupdate = jax.jit(jopt.update) if mode == "jit" else jopt.update
    lr = 3e-4
    for step in range(STEPS):
        g = _grads(step)
        prev_mu = {k: v.numpy().astype(np.float64) for k, v in tst.mu.items()}
        prev_nu = {k: v.numpy().astype(np.float64) for k, v in tst.nu.items()}
        jup, jst = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jst,
                           {k: jnp.asarray(v) for k, v in params.items()}, jnp.float32(lr))
        t_lr = lr if step % 2 else torch.tensor(lr, dtype=torch.float32)
        tup, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tst, tpar, t_lr)
        assert tst.count == int(jst.count) == step + 1
        for k in SHAPES:
            if mode == "eager":
                assert np.array_equal(tup[k].numpy(), np.asarray(jup[k])), (k, step)
                assert np.array_equal(tst.mu[k].numpy(), np.asarray(jst.mu[k])), (k, step)
                assert np.array_equal(tst.nu[k].numpy(), np.asarray(jst.nu[k])), (k, step)
            else:
                gk = g[k].astype(np.float64)
                rooms = []
                for got, want, prev, beta, gg in ((tst.mu[k], jst.mu[k], prev_mu[k], 0.9, gk),
                                                  (tst.nu[k], jst.nu[k], prev_nu[k], 0.999,
                                                   gk * gk)):
                    want = np.asarray(want, np.float64)
                    rooms.append(2.0 ** -24 * (np.abs(beta * prev) + np.abs((1 - beta) * gg)
                                               + np.abs(want)))
                    assert (np.abs(got.numpy() - want) <= rooms[-1]).all(), (k, step)
                # the update inherits mu's contraction: lr / bc1 / (sqrt(nu / bc2) + eps)
                # times mu's room, plus rtol 1e-6 for its own chain
                c = step + 1
                denom = np.sqrt(np.asarray(jst.nu[k], np.float64) / (1 - 0.999 ** c)) + 1e-8
                room_u = lr / (1 - 0.9 ** c) * rooms[0] / denom + 1e-6 * np.abs(
                    np.asarray(jup[k], np.float64))
                assert (np.abs(tup[k].numpy() - np.asarray(jup[k])) <= room_u).all(), (k, step)
            assert tst.mu[k] is bufs[0][k] and tst.nu[k] is bufs[1][k]   # in place
        if mode == "jit":   # carry the JAX state so each step compares one update
            tst = T.AdamState(mu={k: torch.from_numpy(np.array(v)) for k, v in jst.mu.items()},
                              nu={k: torch.from_numpy(np.array(v)) for k, v in jst.nu.items()},
                              count=int(jst.count))
            bufs = (dict(tst.mu), dict(tst.nu))


def test_adam_state_converts_from_jax():
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    jopt = J.adamw()
    st = jopt.init(params)
    _, st = jopt.update({k: jnp.asarray(v) for k, v in _grads(0).items()}, st, params,
                        jnp.float32(1e-3))
    tst = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, st), "cpu")
    assert tst.count == 1
    for k in SHAPES:
        assert np.array_equal(tst.mu[k].numpy(), np.asarray(st.mu[k]))
        assert np.array_equal(tst.nu[k].numpy(), np.asarray(st.nu[k]))


SCHEDULES = {
    "decreasing": (J.diana_decreasing_schedule(0.1, 7.0), T.diana_decreasing_schedule(0.1, 7.0)),
    "decreasing-odd": (J.diana_decreasing_schedule(1 / 3, 0.3),
                       T.diana_decreasing_schedule(1 / 3, 0.3)),
    "warmup-cosine": (J.warmup_cosine_schedule(3e-4, 10, 100, 1e-5),
                      T.warmup_cosine_schedule(3e-4, 10, 100, 1e-5)),
    "cosine-no-warmup": (J.warmup_cosine_schedule(0.1, 0, 37), T.warmup_cosine_schedule(0.1, 0, 37)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    jf, tf = SCHEDULES[name]
    jj = jax.jit(jf)
    for step in [0, 1, 2, 5, 9, 10, 11, 36, 50, 99, 100, 150, 1000]:
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = tf(step)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.dim() == 0
        assert np.array_equal(got.numpy(), want), (name, step, float(got), float(want))
        assert _ulps(got.numpy(), jj(jnp.asarray(step, jnp.int32))) <= 2, (name, step)
