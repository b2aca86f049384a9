"""The port's cached single-token decode against jitted JAX ``decode_step``,
with the JAX weights loaded through ``convert.py`` and the tokens from numpy
seeds: the logits of every step and every cache leaf after the last.

* Every reduced architecture (f32), 4 steps from empty caches.
* A decode from a converted JAX cache of 8192 positions, two chunks of
  ``DECODE_KV_CHUNK`` rows, with ``pos`` near the end: the chunks' combine.
* The ring buffer past wrap-around (window 6, 16 steps).
* Reduced ``granite-moe`` at batch 8 with ``capacity_factor`` 1.25, where
  the decode's capacity of B tokens drops choices (held to JAX's decode, not
  to the forward, which keeps them).
* Reduced ``llama3.2-1b`` and ``mamba2-130m`` with bf16 parameters and
  compute.

Tolerances.  f32: the logits of each step and each cache leaf within rtol
1e-5 of the tensor's largest entry plus atol 1e-6 (the rtol / atol of
``tests/test_torch_model_families.py``, taken normwise) from the port's own
decode in float64, and twice that from the JAX decode (each side rounds).
Elementwise they would not hold: a logit or a K / V entry sums ``d_model``
products, one near zero carries the rounding of its terms, and the decode
carries each step's rounding into the next (after llama's 16 ring-buffer
steps a logit of the f32 port is 1.7e-6 from float64, on logits up to
1.37).  The architectures with Mamba-2 mixers hold the same bound (the
decode has no prefix sum; on ``jamba``'s eight layers the f32 state is
5e-6 of its largest entry from JAX's).  bf16 (8 steps): the logits and the bf16 cache leaves (K, V, the conv
history) within ``BF16_LOGITS`` = 4 bf16 epsilons (2^-7) of their largest
entry (measured here: logits 1.2 epsilons for llama, 0.7 for mamba2; K and
V 1.2), the f32 SSM state within 1e-4 of its largest entry (``SSM_BF16``;
measured 6e-8), and ``pos`` exactly.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config as j_get_config, reduced as j_reduced
from repro.models import decode_step as j_decode_step, init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro_torch.configs import get_config, reduced
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.models.layers import DECODE_KV_CHUNK
from repro_torch.models.transformer import decode_step, init_caches

RTOL, ATOL = 1e-5, 1e-6
SSM_BF16 = 1e-4
BF16_LOGITS = 4 * 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def _run(arch, steps, batch=2, max_len=16, window=None, dtype="float32", over=None,
         j_caches=None, seed=0, jit=True):
    """Decode ``steps`` tokens in both packages from the same weights and
    caches.  Returns (config, JAX logits, port logits, JAX cache leaves,
    port caches, a function rerunning the port's decode in ``dtype``)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    over = over or {}
    jcfg = replace(j_reduced(j_get_config(arch)), param_dtype=jdt, compute_dtype=jdt, **over)
    tcfg = replace(reduced(get_config(arch)), param_dtype=tdt, compute_dtype=tdt, **over)
    jparams = j_init_model(jcfg, jax.random.PRNGKey(seed + 1))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (batch, steps)).astype(np.int32)
    jc = j_caches if j_caches is not None else j_init_caches(jcfg, batch, max_len, window=window)
    start = jax.tree_util.tree_map(np.asarray, jc)
    step = lambda p, t, c: j_decode_step(p, t, c, jcfg, window=window)  # noqa: E731
    jl = []
    with jax.disable_jit(not jit):
        step = jax.jit(step)
        for i in range(steps):
            lg, jc = step(jparams, jnp.asarray(toks[:, i:i + 1]), jc)
            jl.append(np.asarray(lg))
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jc)]

    def port(run_dtype):
        cfg = replace(tcfg, param_dtype=run_dtype, compute_dtype=run_dtype)
        params = {k: v.detach().to(run_dtype if v.dtype == tdt else v.dtype)
                  for k, v in params_from_jax(np_params, tcfg, "cpu").items()}
        if j_caches is None:
            caches = init_caches(cfg, batch, max_len, window=window)
        else:
            caches = tuple(type(c)(*(t.to(run_dtype) if t.is_floating_point()
                                     and t.dtype != torch.float32 else t for t in c))
                           for c in caches_from_jax(start, "cpu"))
        if run_dtype == torch.float64:
            caches = tuple(type(c)(*(t.double() if t.is_floating_point() else t for t in c))
                           for c in caches)
        out = []
        with torch.inference_mode():
            for i in range(steps):
                lg, caches = decode_step(params, torch.from_numpy(toks[:, i:i + 1]), caches,
                                         cfg, window)
                out.append(lg.clone())
        return out, caches

    tl, tc = port(tdt)
    return tcfg, jl, tl, jleaves, tc, port


def _leaves(caches):
    return [t for c in caches for t in c]


def _check_f32(tcfg, jl, tl, jleaves, tc, port):
    assert len(_leaves(tc)) == len(jleaves)
    for a, b in zip(_leaves(tc), jleaves):
        assert tuple(a.shape) == b.shape
        if not a.is_floating_point():
            assert np.array_equal(a.numpy(), b)
    l64, c64 = port(torch.float64)
    pairs = [*zip(tl, jl, l64), *zip(_leaves(tc), jleaves, _leaves(c64))]
    for mine, ref, exact in pairs:
        mine, ref, exact = _f64(mine), _f64(ref), _f64(exact)
        scale = RTOL * np.abs(exact).max() + ATOL
        assert np.abs(mine - exact).max() <= scale, (np.abs(mine - exact).max(), scale)
        assert np.abs(mine - ref).max() <= 2 * scale, (np.abs(mine - ref).max(), scale)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_matches_jax(arch):
    _check_f32(*_run(arch, 4))


def test_decode_two_kv_chunks_from_a_converted_cache():
    """A JAX cache of 8192 positions filled by random K / V up to ``pos`` =
    8189, then three steps: positions 8189-8191 in the second chunk, which
    the combine weighs against the first.  The JAX decode runs eagerly here:
    jitted, XLA's ``pow`` in ``rope_freqs`` is one ulp off the eager value
    (and the port's) in 10 of 32 frequencies, which at position 8189 turns
    a K entry by up to 1e-3."""
    arch, b, n = "llama3.2-1b", 2, 2 * DECODE_KV_CHUNK
    jcfg = j_reduced(j_get_config(arch))
    rng = np.random.default_rng(5)
    caches = j_init_caches(jcfg, b, n)
    pos = n - 3
    filled = []
    for c in caches:
        # positive values: the attention sums them without cancellation, so
        # the output is as well conditioned as with a real cache
        k = rng.standard_normal(c.k.shape).astype(np.float32)
        v = rng.uniform(0.5, 1.5, c.v.shape).astype(np.float32)
        k[:, :, pos:], v[:, :, pos:] = 0, 0
        filled.append(type(c)(k=jnp.asarray(k), v=jnp.asarray(v),
                              pos=jnp.full(c.pos.shape, pos, jnp.int32)))
    res = _run(arch, 3, batch=b, max_len=n, j_caches=tuple(filled), jit=False)
    _check_f32(*res)
    assert int(res[4][0].pos[0]) == n


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_ring_buffer_past_wrap_around(arch):
    """Window 6, 16 steps: the slot wraps twice, and ``(slot - j) mod w``
    must be the floor modulo."""
    res = _run(arch, 16, window=6)
    _check_f32(*res)
    assert tuple(res[4][0].k.shape[2:3]) == (6,)


def test_moe_decode_drops_tokens_as_jax(monkeypatch):
    """Batch 8, 4 experts, top-2, ``capacity_factor`` 1.25: the decode's
    capacity is max(1, int(1.25 * 8 * 2 / 4)) = 5 per expert, so choices
    are dropped; the port drops the same ones."""
    from repro_torch.models import moe

    arch = "granite-moe-3b-a800m"
    cfg = reduced(get_config(arch))
    over = {"moe": replace(cfg.moe, capacity_factor=1.25)}
    seen = []
    route = moe.route

    def spy(*a):
        out = route(*a)
        seen.append((out[4], int((~out[3]).sum())))
        return out

    monkeypatch.setattr(moe, "route", spy)
    _check_f32(*_run(arch, 4, batch=8, over=over))
    assert {c for c, _ in seen} == {5}
    assert sum(d for _, d in seen) > 0, seen


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_bf16_decode_matches_jax(arch):
    tcfg, jl, tl, jleaves, tc, _ = _run(arch, 8, dtype="bfloat16")
    scale = np.abs(np.stack(jl)).max()
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - b).max() <= BF16_LOGITS * scale
    for a, b in zip(_leaves(tc), jleaves):
        if not a.is_floating_point():
            assert np.array_equal(a.numpy(), b)
            continue
        if b.dtype == np.uint16:                         # the JAX package's KV storage
            b = b.view(ml_dtypes.bfloat16)
        b = _f64(b)
        if a.dtype == torch.bfloat16:
            assert np.abs(_f64(a) - b).max() <= BF16_LOGITS * np.abs(b).max()
        else:
            assert a.dtype == torch.float32
            assert np.abs(_f64(a) - b).max() <= SSM_BF16 * np.abs(b).max() + ATOL
