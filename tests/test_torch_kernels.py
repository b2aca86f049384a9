"""The port's plain kernel versions against the JAX package's Pallas kernels
(run in interpret mode), on the same numpy-seeded inputs.

p = inf is bitwise.  For p in {1, 2} the block scale is a sum, which XLA and
torch reduce in different orders: scales agree within 4 ulp and codes on at
least 99.99% of coordinates.  The fused server update is compared under
``jax.jit``, where XLA contracts ``h + alpha * dm`` into one FMA.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.kernels.quantize_pack import quantize_pack as j_quantize_pack
from repro.kernels.unpack_reduce import (unpack_reduce as j_unpack_reduce,
                                         unpack_reduce_apply as j_unpack_reduce_apply,
                                         unpack_reduce_mean as j_unpack_reduce_mean)
from repro_torch.core import packing as tpacking
from repro_torch.core.numerics import fma32
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 128)])
def test_pack_unpack_matches_jax(shape):
    rng = np.random.default_rng(0)
    signs = rng.integers(-1, 2, size=shape).astype(np.int8)
    tp = tpacking.pack2bit(_t(signs))
    assert np.array_equal(tp.numpy(), np.asarray(jpacking.pack2bit(jnp.asarray(signs))))
    assert np.array_equal(tpacking.unpack2bit(tp).numpy(), signs)
    raw = rng.integers(0, 256, size=shape[:-1] + (shape[-1] // 4,), dtype=np.uint8)
    assert np.array_equal(tpacking.unpack2bit(_t(raw)).numpy(),
                          np.asarray(jpacking.unpack2bit(jnp.asarray(raw))))


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0])
@pytest.mark.parametrize("m,b", [(13, 256), (5, 128)])
def test_quantize_pack_matches_pallas(p, m, b):
    rng = np.random.default_rng(1)
    delta = (rng.standard_normal((m, b)) * rng.random((m, 1)) * 3).astype(np.float32)
    delta[1] = 0.0                      # a zero block quantizes to zero
    delta[2, :b // 2] = -0.0
    bits = rng.integers(0, 2**32, size=(m, b), dtype=np.uint32)
    jp, js = j_quantize_pack(jnp.asarray(delta), jnp.asarray(bits), p=p, interpret=True)
    tp, ts = ops.quantize_pack_op(_t(delta), _t(bits.view(np.int32)), p=p)
    jp, js = np.asarray(jp), np.asarray(js)
    assert tp.shape == jp.shape and ts.shape == js.shape
    if p == math.inf:
        assert np.array_equal(tp.numpy(), jp) and np.array_equal(ts.numpy(), js)
    else:
        assert _ulps(ts.numpy(), js).max() <= 4
        codes_t = tpacking.unpack2bit(tp).numpy()
        codes_j = np.asarray(jpacking.unpack2bit(jnp.asarray(jp)))
        assert np.mean(codes_t == codes_j) >= 0.9999


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("m", [13, 3])
def test_unpack_reduce_and_mean_match_pallas(n, m):
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, size=(n, m, 64), dtype=np.uint8)
    scales = rng.random((n, m, 1)).astype(np.float32) * 5
    js = np.asarray(j_unpack_reduce(jnp.asarray(packed), jnp.asarray(scales), interpret=True))
    jm = np.asarray(j_unpack_reduce_mean(jnp.asarray(packed), jnp.asarray(scales),
                                         interpret=True))
    assert np.array_equal(ops.unpack_reduce_op(_t(packed), _t(scales)).numpy(), js)
    assert np.array_equal(ops.unpack_reduce_mean_op(_t(packed), _t(scales)).numpy(), jm)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("d_short", [0, 100])
def test_unpack_reduce_apply_matches_jitted_pallas(n, d_short):
    rng = np.random.default_rng(3)
    m, b4 = 13, 64
    packed = rng.integers(0, 256, size=(n, m, b4), dtype=np.uint8)
    scales = rng.random((n, m, 1)).astype(np.float32) * 5
    h = rng.standard_normal(m * b4 * 4 - d_short).astype(np.float32)
    alpha = 0.04348
    jg, jh = jax.jit(lambda a, s, hh: j_unpack_reduce_apply(a, s, hh, alpha=alpha,
                                                            interpret=True))(
        jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(h))
    tg, th = ops.unpack_reduce_apply_op(_t(packed), _t(scales), _t(h), alpha=alpha)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(th.numpy(), np.asarray(jh))


def test_fma32_reproduces_jitted_jax_and_eager_does_not():
    """Which formulation gives JAX's bits: the jitted ``h + a*x`` is one FMA;
    fma32 matches it everywhere, the eager two-rounding form does not."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal(200_000).astype(np.float32)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.integers(-8, 8, 200_000)).astype(np.float32)
    a = 0.021739130434782608
    jit = np.asarray(jax.jit(lambda hh, xx: hh + a * xx)(jnp.asarray(h), jnp.asarray(x)))
    assert np.array_equal(fma32(a, _t(x), _t(h)).numpy(), jit)
    eager = (_t(h) + np.float32(a) * _t(x)).numpy()
    assert not np.array_equal(eager, jit)


def test_ops_dispatch_cpu_to_plain():
    rng = np.random.default_rng(5)
    delta = _t(rng.standard_normal((3, 128)).astype(np.float32))
    bits = _t(rng.integers(0, 2**32, size=(3, 128), dtype=np.uint32).view(np.int32))
    got = ops.quantize_pack_op(delta, bits, p=math.inf)
    want = ref.ref_quantize_pack(delta, bits, math.inf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        ops.quantize_pack_op(delta.to("meta"), bits.to("meta"), p=math.inf)


@pytest.mark.parametrize("p", [math.inf, 2.0])
def test_quantize_blocks_matches_jax(p):
    """The fallback quantizer (pad to blocks, threefry bits, Def. 2) on a
    leaf whose size is not a multiple of the block."""
    from repro.core.quantization import quantize_blocks as j_quantize_blocks
    from repro_torch.core import prng
    from repro_torch.core.quantization import quantize_blocks as t_quantize_blocks

    x = np.random.default_rng(6).standard_normal((37, 29)).astype(np.float32)
    jq = j_quantize_blocks(jnp.asarray(x), jax.random.PRNGKey(4), p=p, block_size=128)
    tq = t_quantize_blocks(_t(x), prng.PRNGKey(4), p=p, block_size=128)
    assert np.array_equal(tq.signs.numpy(), np.asarray(jq.signs))
    if p == math.inf:
        assert np.array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    else:
        assert _ulps(tq.scales.numpy(), np.asarray(jq.scales)).max() <= 4


def test_build_target_hashes_every_header(tmp_path, monkeypatch):
    """A library is named by its source, every ``csrc/*.cuh`` header and the
    flags: a changed (or added) header gives every source a new target, so
    no stale library is loaded from the build cache."""
    from repro_torch.kernels import build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// no include\n")
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    a1, b1 = build._target("a"), build._target("b")
    assert build._target("a") == a1 and a1 != b1 and a1.parent == build.BUILD_DIR
    (tmp_path / "h.cuh").write_text("// two\n")
    a2, b2 = build._target("a"), build._target("b")
    assert a2 != a1 and b2 != b1
    (tmp_path / "g.cuh").write_text("// new\n")
    assert build._target("a") not in (a1, a2)
    (tmp_path / "g.cuh").unlink()
    assert build._target("a") == a2
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// changed\n')
    assert build._target("a") != a2 and build._target("b") == b2
