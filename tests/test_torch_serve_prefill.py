"""The port's prefill (``build_prefill``: ``forward(last_token_only=True)``
and the head) against jitted JAX ``forward(..., last_token_only=True)`` for
every reduced architecture, the two frontend stubs included, with the JAX
weights loaded through ``convert.py`` and the batch from both packages'
``make_lm_batch``; and the port's decode against its own forward.

Tolerances.  Prefill (f32): the (B, 1, V) logits within rtol 1e-5 of their
largest entry plus atol 1e-6 (the rtol / atol of
``tests/test_torch_model_families.py``, normwise as in
``tests/test_torch_serve_decode.py``: a logit sums ``d_model`` products).
The two architectures with Mamba-2 mixers are held as
``tests/test_torch_model_families.py`` holds them: within ``SSM_NORMWISE``
= 1e-4 of the largest logit plus atol, both from the port's prefill in
float64 and from JAX's (the f32 SSD's ``exp`` of chunk cumsums).
Decode against forward (f32): atol 2e-4, that of the JAX package's
``tests/test_models_smoke.py::test_prefill_decode_parity`` (the decode's
flash-style softmax and the SSM recurrence against the forward's softmax
and chunked SSD).  bf16 decode against forward, 16 tokens: ``BF16_PARITY``
= 4 bf16 epsilons (2^-7) of the largest logit for llama, 16 for mamba2
(measured here: llama 1.55 on two layers and 2.26 on sixteen, mamba2 0.00
on two and 8.63 on twenty-four; the JAX package's own bf16 decode is 3.48
epsilons from its forward on those twenty-four layers, and the test holds
it to the same bound).  The two paths
round differently at bf16, legitimately: the train path's softmax rounds
its probabilities after normalising and the decode's before, and the
chunked SSD rounds to bf16 from another f32 order than the recurrence; a
flipped rounding in one layer grows through the later ones.
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
from repro.models import decode_step as j_decode_step, forward as j_forward
from repro.models import init_caches as j_init_caches, init_model as j_init_model
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import serve
from repro_torch.models.transformer import decode_step, forward, head_logits, init_caches

RTOL, ATOL = 1e-5, 1e-6
SSM_NORMWISE = 1e-4
PARITY_ATOL = 2e-4
BF16_PARITY = {"llama3.2-1b": 4 * 2.0 ** -7, "mamba2-130m": 16 * 2.0 ** -7}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(jcfg, tcfg, seed=1):
    """The JAX weights, and the port's copy in their dtypes."""
    jparams = j_init_model(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_matches_jax(arch):
    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    seq = 64 + (jcfg.frontend_tokens if jcfg.frontend != "none" else 0)
    batch = make_lm_batch(tcfg, ShapeConfig("p", seq, 2, "prefill"), 0)
    jbatch = j_make_lm_batch(jcfg, JShape("p", seq, 2, "prefill"), 0)
    assert set(batch) == set(jbatch) and "labels" not in batch
    assert all(np.array_equal(batch[k], jbatch[k]) for k in batch)
    jparams, params = _params(jcfg, tcfg)
    want = np.asarray(jax.jit(lambda p, b: j_forward(p, b, jcfg, last_token_only=True)[0])(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = serve.build_prefill(tcfg, ShapeConfig("p", seq, 2, "prefill"))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == want.shape == (2, 1, tcfg.padded_vocab) and got.dtype == torch.float32
    got = got.numpy()
    if not tcfg.has_mamba():
        scale = RTOL * np.abs(want).max() + ATOL
        assert np.abs(got - want).max() <= scale, (np.abs(got - want).max(), scale)
        return
    f64 = torch.float64
    exact = serve.build_prefill(replace(tcfg, param_dtype=f64, compute_dtype=f64), None)(
        {k: v.detach().double() for k, v in params.items()},
        {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
         for k, v in batch.items()}).numpy()
    scale = SSM_NORMWISE * np.abs(exact).max() + ATOL
    assert np.abs(got - exact).max() <= scale, (np.abs(got - exact).max(), scale)
    assert np.abs(got - want).max() <= scale, (np.abs(got - want).max(), scale)


def test_prefill_runs_no_checkpoint(monkeypatch):
    """Under inference mode neither the block stack (``remat="full"``), the
    query chunks nor the MoE token chunks route through
    ``torch.utils.checkpoint``; with autograd the training path still does."""
    from repro_torch.models import layers, moe, transformer

    calls = []

    def spy(fn, *a, **kw):
        calls.append(fn)
        return fn(*a)

    for mod in (layers, moe, transformer):
        monkeypatch.setattr(mod, "checkpoint", spy)
    cfg = replace(reduced(get_config("granite-moe-3b-a800m")), remat="full", attn_q_chunk=16)
    cfg = replace(cfg, moe=replace(cfg.moe, token_chunk=32))
    _, params = _params(j_reduced(j_get_config("granite-moe-3b-a800m")), cfg)
    batch = {"tokens": torch.from_numpy(make_lm_batch(cfg, ShapeConfig("p", 64, 2, "prefill"),
                                                      0)["tokens"])}
    serve.build_prefill(cfg, None)(params, batch)
    caches = init_caches(cfg, 2, 8)
    serve.build_serve_step(cfg, ShapeConfig("d", 8, 2, "decode"))(params, caches,
                                                                  batch["tokens"][:, :1])
    assert calls == []
    forward(params, batch, cfg)
    assert calls


def _decode_all(params, tokens, cfg, window=None):
    caches = init_caches(cfg, tokens.shape[0], tokens.shape[1], window=window)
    out = []
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            lg, caches = decode_step(params, tokens[:, t:t + 1], caches, cfg, window)
            out.append(lg[:, 0])
    return torch.stack(out, dim=1), caches


@pytest.mark.parametrize("arch,window", [("llama3.2-1b", None), ("mamba2-130m", None),
                                         ("jamba-v0.1-52b", None), ("llama3.2-1b", 6)])
def test_decode_equals_forward(arch, window):
    """``test_prefill_decode_parity`` / ``test_sliding_window_parity`` of
    the JAX package on the port: 16 tokens decoded one at a time equal the
    forward over them (window 6: the ring buffer wraps twice)."""
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    _, params = _params(jcfg, cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)))
    with torch.inference_mode():
        x, _ = forward(params, {"tokens": tokens}, cfg, window)
        full = head_logits(params, x, cfg)
    dec, caches = _decode_all(params, tokens, cfg, window)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=PARITY_ATOL)
    assert all(int(c.pos[0]) == 16 for c in caches)


@pytest.mark.parametrize("arch,layers", [("llama3.2-1b", 2), ("llama3.2-1b", 16),
                                         ("mamba2-130m", 2), ("mamba2-130m", 24)])
def test_bf16_decode_equals_forward(arch, layers):
    """At two layers and at the full model's depth (the card holds the full
    width to twice this bound, ``chip_smoke.py``); the JAX package's own
    bf16 decode and forward keep the same bound."""
    bf = torch.bfloat16
    jcfg = replace(j_reduced(j_get_config(arch)), param_dtype=jnp.bfloat16,
                   compute_dtype=jnp.bfloat16, n_layers=layers)
    cfg = replace(reduced(get_config(arch)), param_dtype=bf, compute_dtype=bf, n_layers=layers)
    jparams, params = _params(jcfg, cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    with torch.inference_mode():
        x, _ = forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
        full = head_logits(params, x, cfg).numpy()
    dec, _ = _decode_all(params, torch.from_numpy(tokens), cfg)
    jfull = np.asarray(jax.jit(lambda p, t: j_forward(p, {"tokens": t}, jcfg)[0])(
        jparams, jnp.asarray(tokens)))
    jstep = jax.jit(lambda p, t, c: j_decode_step(p, t, c, jcfg))
    jc, jdec = j_init_caches(jcfg, 2, 16), []
    for t in range(16):
        lg, jc = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]), jc)
        jdec.append(np.asarray(lg)[:, 0])
    for label, d, f in (("port", dec.numpy(), full), ("JAX", np.stack(jdec, axis=1), jfull)):
        scale, err = np.abs(f).max(), np.abs(d - f).max()
        print(f"{label} {arch} {layers} layers: bf16 decode - forward "
              f"{err / (2.0 ** -7 * scale):.2f} epsilons of the largest logit")
        assert err <= BF16_PARITY[arch] * scale, label


def test_last_token_only_is_the_last_row_of_the_full_forward():
    cfg = reduced(get_config("internvl2-2b"))
    _, params = _params(j_reduced(j_get_config("internvl2-2b")), cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             make_lm_batch(cfg, ShapeConfig("p", 48, 2, "prefill"), 0).items()}
    with torch.inference_mode():
        x, _ = forward(params, batch, cfg)
        last, _ = forward(params, batch, cfg, last_token_only=True)
    assert x.shape[1] == 48 and last.shape[1] == 1
    assert torch.equal(last, x[:, -1:])
