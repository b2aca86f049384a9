"""The port's ``train_loss`` and its gradients against JAX
``value_and_grad(train_loss)`` on ``reduced(llama3.2-1b)`` in f32, with the
JAX weights loaded through ``convert.py``.  Tolerance rtol=1e-5, atol=1e-6:
both sides run f32, but matrix products and reductions sum in other orders.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import init_model as j_init_model, train_loss as j_train_loss
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import flatten_nested
from repro_torch.models.transformer import Transformer, train_loss as t_train_loss

RTOL, ATOL = 1e-5, 1e-6


def _configs(**over):
    jcfg = replace(j_reduced(j_get_config("llama3.2-1b")), **over)
    tcfg = replace(t_reduced(t_get_config("llama3.2-1b")), **over)
    return jcfg, tcfg


def test_reduced_configs_agree():
    jcfg, tcfg = _configs()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "resolved_head_dim", "d_ff",
              "vocab", "padded_vocab", "n_blocks", "act", "rope_theta", "norm_eps",
              "attn_q_chunk", "compression", "comp_p", "comp_block", "comp_bucketed"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f


@pytest.mark.parametrize("seq,labels,over", [
    (24, True, {}),
    (32, False, {"attn_q_chunk": 8}),           # query-chunked attention
    (1024, True, {"remat": "full"}),            # chunked CE (2 chunks), remat
])
def test_train_loss_and_grads_match_jax(seq, labels, over):
    jcfg, tcfg = _configs(**over)
    jparams = j_init_model(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, size=(2, seq), dtype=np.int32)
    batch = {"tokens": tokens}
    if labels:
        batch["labels"] = np.roll(tokens, -1, axis=1)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_train_loss(p, b, jcfg)))(jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    model = Transformer(tcfg, params_from_jax(np_params, tcfg, "cpu"))
    tloss = model({k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    jg = flatten_nested(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(jg) == set(model.params.keys())
    for p, g in jg.items():
        np.testing.assert_allclose(model.params[p].grad.numpy(), g, rtol=RTOL, atol=ATOL,
                                   err_msg=p)


def test_forward_takes_the_functional_params():
    _, tcfg = _configs()
    jparams = j_init_model(_configs()[0], jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    tokens = torch.from_numpy(np.arange(16, dtype=np.int32).reshape(2, 8))
    a = t_train_loss(params, {"tokens": tokens}, tcfg)
    b = Transformer(tcfg, params)({"tokens": tokens})
    assert torch.equal(a, b) and torch.isfinite(a)
