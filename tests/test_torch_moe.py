"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's ``moe_layer`` (single device, no sharding policy) on the reduced
``granite-moe`` config (f32) and numpy-seeded inputs.

* Routing: the experts each token picks (``lax.top_k``'s order: descending
  probability, ties to the lower expert) and each choice's capacity slot
  equal the JAX package's exactly; the slot weights within rtol 1e-5 (the
  router's product over d_model sums in another order).
* ``capacity_factor`` 0.5 forces drops: the same choices are dropped.
* The layer's output, its aux loss and their gradients (inputs, router,
  experts) under a random linear probe of the output, unchunked, with
  drops, and in token chunks of 16 (each recomputed in the backward, the
  aux the chunks' mean).  The probe's gradients are O(1) sums over the
  tokens with terms of both signs, so each array is held normwise: within
  rtol 1e-5 of its largest entry, plus atol 1e-6 (the aux loss
  elementwise).  The whole model's loss and gradients are held elementwise
  in ``tests/test_torch_model_families.py``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import moe as JM
from repro_torch.configs import get_config, reduced
from repro_torch.models.moe import moe_layer, route

RTOL, ATOL = 1e-5, 1e-6
T, D = 64, 256


def _cfgs(**moe):
    jcfg = j_reduced(j_get_config("granite-moe-3b-a800m"))
    tcfg = reduced(get_config("granite-moe-3b-a800m"))
    return replace(jcfg, moe=replace(jcfg.moe, **moe)), replace(tcfg, moe=replace(tcfg.moe, **moe))


def _inputs(jcfg, seed=0):
    params = JM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, T // 2, D)).astype(np.float32)
    return {k: np.asarray(v) for k, v in params.items()}, x


@pytest.mark.parametrize("cf", [None, 0.5], ids=["no-drops", "drops"])
def test_routing_and_slots_equal_jax(cf):
    jcfg, tcfg = _cfgs(**({} if cf is None else {"capacity_factor": cf}))
    params, x = _inputs(jcfg)
    xf = x.reshape(T, D)
    _, tok_slot, w_slot, cap, aux = JM._dispatch(jnp.asarray(params["router"]), jnp.asarray(xf),
                                                 jcfg)
    top_p, top_e, slot, keep, tcap, taux = route(torch.from_numpy(params["router"]),
                                                 torch.from_numpy(xf), tcfg)
    _, j_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf) @ params["router"]), jcfg.moe.top_k)
    assert tcap == cap
    assert np.array_equal(top_e.numpy(), np.asarray(j_e))
    e = jcfg.moe.n_experts
    # the JAX slot tables, rebuilt from the port's routing
    t_tok = np.full(e * cap + 1, T, np.int32)
    t_w = np.zeros(e * cap + 1, np.float32)
    kept = keep.numpy().reshape(-1)
    flat_slot = slot.numpy().reshape(-1)
    toks = np.repeat(np.arange(T), jcfg.moe.top_k)
    t_tok[flat_slot[kept]] = toks[kept]
    t_w[flat_slot[kept]] = top_p.numpy().reshape(-1)[kept]
    assert np.array_equal(t_tok[:e * cap], np.asarray(tok_slot)[:e * cap])
    np.testing.assert_allclose(t_w[:e * cap], np.asarray(w_slot)[:e * cap], rtol=RTOL, atol=0)
    np.testing.assert_allclose(float(taux), float(aux), rtol=RTOL)
    if cf is not None:
        assert 0 < (~kept).sum() < kept.size      # some choices dropped, not all


def test_ties_go_to_the_lower_expert():
    jcfg, tcfg = _cfgs()
    xf = np.ones((8, D), np.float32)
    router = np.zeros((D, jcfg.moe.n_experts), np.float32)      # every probability equal
    _, top_e, slot, keep, cap, _ = route(torch.from_numpy(router), torch.from_numpy(xf), tcfg)
    _, j_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf) @ router), jcfg.moe.top_k)
    assert np.array_equal(top_e.numpy(), np.asarray(j_e))
    assert top_e[0].tolist() == list(range(jcfg.moe.top_k))


@pytest.mark.parametrize("moe", [{}, {"capacity_factor": 0.5}, {"token_chunk": 16},
                                 {"token_chunk": 16, "capacity_factor": 0.75}],
                         ids=["plain", "drops", "chunked", "chunked-drops"])
def test_layer_and_grads_match_jax(moe):
    jcfg, tcfg = _cfgs(**moe)
    params, x = _inputs(jcfg, seed=1)
    probe = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = JM.moe_layer(p, xx, jcfg)
        return jnp.sum(out * probe) + aux, (out, aux)

    (jl, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                                has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe_layer(tp, tx, tcfg)
    loss = torch.sum(out * torch.from_numpy(probe)) + aux
    grads = torch.autograd.grad(loss, [tx, *tp.values()])
    _close(out.detach().numpy(), jout, "out")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=RTOL, atol=ATOL)
    _close(grads[0].numpy(), jgx, "x")
    for (k, _), g in zip(tp.items(), grads[1:]):
        _close(g.numpy(), jgp[k], k)


def _close(got, want, name):
    """Normwise: within rtol of the array's largest entry, plus atol."""
    want = np.asarray(want)
    err, bound = np.abs(got - want).max(), RTOL * np.abs(want).max() + ATOL
    assert err <= bound, (name, err, bound)
