"""The port's ``train_loss`` and its gradients for every reduced
architecture (f32) against jitted JAX ``value_and_grad(train_loss)``, with
the JAX weights loaded through ``convert.py`` and the batch from both
packages' ``make_lm_batch`` (the frontend models' stub embeddings
included): MoE (``granite-moe``, ``phi3.5-moe``), squared ReLU
(``nemotron``), GELU and the audio frontend (``musicgen``), the vision
frontend (``internvl2``), Mamba-2 (``mamba2``) and the hybrid pattern
(``jamba``), and the sliding-window mask, chunked and not.

Tolerance rtol=1e-5, atol=1e-6 (that of ``tests/test_torch_model.py``):
both sides run f32, but matrix products and reductions sum in other orders,
and the MoE combine adds a token's ``top_k`` slots in another order.

The two architectures with Mamba-2 mixers are held differently: their f32
SSD evaluates ``exp`` of chunk cumsums, whose error grows with the decay
accumulated over a chunk, so neither side's f32 gradient lies within 1e-5
of the float64 value elementwise.  The port's model run in float64 (every
f32 cast of the port widens to float64) gives that value.  Per leaf, both
the port's distance from it and its distance from the JAX gradient must be
within ``SSM_NORMWISE`` = 1e-4 of the leaf's largest entry, plus atol
(measured on ``jamba``'s embedding, the worst leaf: the JAX package 1.6e-5
from the float64 value, the port 2.0e-5, whose SSD forms the decays'
prefix sums in float64, ``repro_torch/models/mamba2.py``); the loss within
rtol 1e-5.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config as j_get_config, reduced as j_reduced
from repro.configs.base import ShapeConfig as JShape
from repro.data import make_lm_batch as j_make_lm_batch
from repro.models import init_model as j_init_model, train_loss as j_train_loss
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import flatten_nested
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.models.transformer import train_loss

RTOL, ATOL = 1e-5, 1e-6
SSM_NORMWISE = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(arch, seq=64, window=None, **over):
    jcfg = replace(j_reduced(j_get_config(arch)), **over)
    tcfg = replace(reduced(get_config(arch)), **over)
    if jcfg.frontend != "none":
        seq += jcfg.frontend_tokens
    batch = make_lm_batch(tcfg, ShapeConfig("t", seq, 2, "train"), 0)
    jbatch = j_make_lm_batch(jcfg, JShape("t", seq, 2, "train"), 0)
    assert set(batch) == set(jbatch) and all(np.array_equal(batch[k], jbatch[k]) for k in batch)
    jparams = j_init_model(jcfg, jax.random.PRNGKey(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_train_loss(p, b, jcfg, window=window)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = jax.tree_util.tree_map(np.asarray, jparams)

    def port(dtype):
        cfg = replace(tcfg, param_dtype=dtype, compute_dtype=dtype)
        params = {k: torch.nn.Parameter(v.detach().to(dtype))
                  for k, v in params_from_jax(np_params, tcfg, "cpu").items()}
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        loss = train_loss(params, b, cfg, window=window)
        return loss.item(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    jg = flatten_nested(jax.tree_util.tree_map(np.asarray, jgrads))
    return tcfg, float(jloss), jg, port


@pytest.mark.parametrize("arch,over,window", [
    *[(a, {}, None) for a in ASSIGNED_ARCHS],
    ("llama3.2-1b", {"attn_q_chunk": 16}, 24),       # sliding window, query-chunked
    ("granite-moe-3b-a800m", {}, 24),                # sliding window, one chunk
], ids=lambda v: str(v) if not isinstance(v, dict) else ",".join(f"{k}={x}" for k, x in v.items()))
def test_train_loss_and_grads_match_jax(arch, over, window):
    tcfg, jloss, jg, port = _case(arch, window=window, **over)
    loss, grads = port(torch.float32)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
    assert set(grads) == set(jg)
    if not tcfg.has_mamba():
        for p, g in jg.items():
            np.testing.assert_allclose(grads[p].numpy(), g, rtol=RTOL, atol=ATOL, err_msg=p)
        return
    _, g64 = port(torch.float64)
    for p, g in jg.items():
        exact, mine = g64[p].numpy(), grads[p].numpy()
        scale = SSM_NORMWISE * np.abs(exact).max() + ATOL
        assert np.abs(mine - exact).max() <= scale, (p, np.abs(mine - exact).max(), scale)
        assert np.abs(mine - g).max() <= scale, (p, np.abs(mine - g).max(), scale)


def test_frontend_positions_drop_out_of_the_loss():
    """A frontend model's loss covers the token span only: the labels'
    length, not the sequence's, sets the mean."""
    _, jloss, _, port = _case("internvl2-2b", seq=32)
    loss, grads = port(torch.float32)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
    assert float(grads["frontend_proj/w"].abs().sum()) > 0


def test_remat_dots_is_refused():
    """``remat="dots"`` was refused until the port had it; now it builds
    (``tests/test_torch_remat.py`` holds it to the JAX package), and what is
    refused is a mode the JAX package does not know."""
    from repro_torch.models.transformer import init_model
    init_model(replace(reduced(get_config("llama3.2-1b")), remat="dots"), "cpu")
    with pytest.raises(ValueError, match="unknown remat"):
        init_model(replace(reduced(get_config("llama3.2-1b")), remat="offload"), "cpu")
