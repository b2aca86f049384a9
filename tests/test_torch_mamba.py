"""The port's Mamba-2 pieces (``repro_torch/models/mamba2.py``) against the
JAX package's (``repro/models/mamba2.py``) on numpy-seeded inputs.

* The causal depthwise conv with SiLU and the gated RMSNorm at rtol 1e-5 /
  atol 1e-6 (f32 on both sides; sums in other orders).
* The chunked SSD against ``_ssd_chunked``, forward and gradients, at
  several chunk sizes, on the decays the model feeds it (``A = -exp(A_log)``
  with ``A_log`` the init's ``log(linspace(1, 16))``, ``dt = softplus(.)``):
  their chunk cumsums reach the hundreds, so ``exp`` of an f32 cumsum
  carries ~1e-5 relative error on the JAX side, which the port avoids by
  forming the prefix sums in float64.  Both are held against the port's
  float64 evaluation, normwise per array: within 1e-4 of its largest entry
  plus atol (as ``tests/test_torch_model_families.py`` holds the Mamba-2
  models), the port also within 1e-5 of it.
* The masked upper triangle (``-inf`` before ``exp``) gives zero, finite
  gradients even where the unmasked differences would overflow.
* The whole layer (``mamba_layer``) against ``mamba_layer(cache=None)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import mamba2 as JM
from repro_torch.configs import get_config, reduced
from repro_torch.models import mamba2 as TM

RTOL, ATOL, SSM_NORMWISE = 1e-5, 1e-6, 1e-4


def _normwise(got, want, rel, name=""):
    want = np.asarray(want)
    err, bound = np.abs(np.asarray(got) - want).max(), rel * np.abs(want).max() + ATOL
    assert err <= bound, (name, err, bound)


def _ssd_inputs(seed, b=2, l=64, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    return ((x * dt[..., None]).astype(np.float32), (a * dt).astype(np.float32),
            rng.standard_normal((b, l, h, n)).astype(np.float32),
            rng.standard_normal((b, l, h, n)).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_matches_jax(chunk):
    args = _ssd_inputs(chunk)
    probe = np.random.default_rng(1).standard_normal(args[0].shape).astype(np.float32)
    jf = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(JM._ssd_chunked(*a, chunk) * probe), argnums=(0, 1, 2, 3)))
    jy = np.asarray(jax.jit(lambda *a: JM._ssd_chunked(*a, chunk))(*args))
    _, jgrads = jf(*args)

    def port(dtype):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in args]
        y = TM.ssd_chunked(*ts, chunk)
        g = torch.autograd.grad(torch.sum(y * torch.from_numpy(probe).to(dtype)), ts)
        return y.detach().numpy(), [x.numpy() for x in g]

    y32, g32 = port(torch.float32)
    y64, g64 = port(torch.float64)
    assert y32.dtype == np.float32 and y64.dtype == np.float64
    _normwise(y32, y64, RTOL, "y port")
    _normwise(jy, y64, SSM_NORMWISE, "y jax")
    _normwise(y32, jy, SSM_NORMWISE, "y")
    for i, (a, b, c) in enumerate(zip(g32, jgrads, g64)):
        _normwise(a, c, SSM_NORMWISE, f"grad {i} port")
        _normwise(b, c, SSM_NORMWISE, f"grad {i} jax")
        _normwise(a, b, SSM_NORMWISE, f"grad {i}")


def test_masked_triangle_has_finite_zero_gradients():
    """A chunk of 64 steps with decays of -40 each: the unmasked upper
    differences reach +2520, whose exp overflows; the masked ones must
    still give finite gradients."""
    x, _, b_, c_ = _ssd_inputs(3)
    at = np.full(x.shape[:3], -40.0, np.float32)
    ts = [torch.tensor(v, requires_grad=True) for v in (x, at, b_, c_)]
    y = TM.ssd_chunked(*ts, 64)
    grads = torch.autograd.grad(y.sum(), ts)
    assert torch.isfinite(y).all() and all(torch.isfinite(g).all() for g in grads)
    jy = JM._ssd_chunked(x, at, b_, c_, 64)
    _normwise(y.detach().numpy(), jy, RTOL, "y")


def test_conv_and_gated_norm_match_jax():
    jcfg = j_reduced(j_get_config("mamba2-130m"))
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 32, 96)).astype(np.float32)
    w = rng.standard_normal((4, 96)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jconv = np.asarray(JM._conv_full({"conv_w": w, "conv_b": bias}, jnp.asarray(u), jcfg))
    tconv = TM.conv_full(torch.from_numpy(w), torch.from_numpy(bias), torch.from_numpy(u),
                         torch.float32)
    np.testing.assert_allclose(tconv.numpy(), jconv, rtol=RTOL, atol=ATOL)
    y, z = (rng.standard_normal((2, 32, 64)).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(64).astype(np.float32)
    gated = y * jax.nn.silu(z)
    var = jnp.mean(gated * gated, axis=-1, keepdims=True)
    want = gated * jax.lax.rsqrt(var + jcfg.norm_eps) * scale      # mamba2.py:200-202
    got = TM.gated_rms_norm(torch.from_numpy(y), torch.from_numpy(z), torch.from_numpy(scale),
                            jcfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seq", [32, 128])
def test_layer_matches_jax(seq):
    jcfg = j_reduced(j_get_config("mamba2-130m"))
    tcfg = reduced(get_config("mamba2-130m"))
    params = {k: np.asarray(v) for k, v in JM.init_mamba(jax.random.PRNGKey(5), jcfg,
                                                         jnp.float32).items()}
    x = np.random.default_rng(6).standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    jy, _ = jax.jit(lambda p, xx: JM.mamba_layer(p, xx, jcfg))(params, x)
    ty = TM.mamba_layer({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                        torch.from_numpy(x), tcfg)
    _normwise(ty.numpy(), jy, SSM_NORMWISE, "layer")
