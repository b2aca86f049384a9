"""The in-kernel-PRNG encodes (``quantize_pack_prng``, ``nat_pack_prng``) of
the port against the JAX package, on the same numpy-seeded inputs.

The JAX package's own in-kernel-PRNG kernels draw from the TPU's hardware
generator and run only compiled on a TPU; their contract is equality in
distribution with the bits variants.  The port's kernels draw counter-mode
threefry2x32 in registers, which is ``jax.random.bits`` itself: segment
``i`` of a key table draws ``bits(keys[i], shape_i)``.  So their plain
versions (here on the CPU; the CUDA kernels are held to them on the card,
``tests/test_torch_cuda.py``) are held BITWISE to the JAX bits kernels
(``quantize_pack`` / ``nat_pack``, interpret mode) fed those draws
concatenated: one-key tables, multi-segment tables, and natural segment
sizes that split groups of 4.  Beside that: the output shapes and dtypes of
the JAX in-kernel-PRNG wrappers (``jax.eval_shape``), and unbiasedness over
2000 keys with ``tests/test_kernels.py``'s statistic.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.nat_pack import nat_pack as j_nat_pack, nat_pack_prng as j_nat_pack_prng
from repro.kernels.quantize_pack import (quantize_pack as j_quantize_pack,
                                         quantize_pack_prng as j_quantize_pack_prng)
from repro_torch.core import prng
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keys(nseg, seed):
    """The same key table on both sides: ``split(PRNGKey(seed), nseg)``."""
    return jax.random.split(jax.random.PRNGKey(seed), nseg), prng.split(prng.PRNGKey(seed), nseg)


def _jax_bits(jkeys, shapes):
    return jnp.concatenate([jax.random.bits(k, s, dtype=jnp.uint32) for k, s in
                            zip(jkeys, shapes)])


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0])
@pytest.mark.parametrize("seg_rows,b", [((13,), 128), ((1, 3, 1, 2), 256), ((2, 1, 5), 128)])
def test_quantize_pack_prng_matches_jax_bits_kernel(p, seg_rows, b):
    m = sum(seg_rows)
    rng = np.random.default_rng(m + b)
    delta = (rng.standard_normal((m, b)) * rng.uniform(1e-3, 1e3, (m, 1))).astype(np.float32)
    delta[0, :3] = [-0.0, 0.0, np.finfo(np.float32).max]
    jkeys, tkeys = _keys(len(seg_rows), m)
    jbits = _jax_bits(jkeys, [(r, b) for r in seg_rows])
    jp, js = j_quantize_pack(jnp.asarray(delta), jbits, p=p, interpret=True)
    tp, ts = ref.ref_quantize_pack_prng(_t(delta), tkeys, seg_rows, p)
    op, os_ = ops.quantize_pack_prng_op(_t(delta), tkeys, seg_rows, p=p)   # CPU: the plain version
    assert torch.equal(op, tp) and torch.equal(os_, ts)
    assert tp.shape == (m, b // 4) and tp.dtype == torch.uint8
    assert ts.shape == (m, 1) and ts.dtype == torch.float32
    if p == math.inf:
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert np.array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    else:
        # The norm's sum reduces in another order in torch and XLA.
        assert _ulps(ts.numpy(), np.asarray(js)).max() <= 4
        codes = [(tp.numpy() >> s) & 3 == (np.asarray(jp) >> s) & 3 for s in (0, 2, 4, 6)]
        assert np.mean(codes) >= 0.9999


def test_quantize_pack_prng_one_key_is_the_per_leaf_draw():
    """A one-row table is the per-leaf ``compress(delta, key)``: the bits of
    ``bits(key, (m, B))`` (the JAX package's CPU route)."""
    rng = np.random.default_rng(1)
    delta = rng.standard_normal((6, 128)).astype(np.float32)
    jkey, tkey = jax.random.PRNGKey(4), prng.PRNGKey(4)
    jbits = jax.random.bits(jkey, (6, 128), dtype=jnp.uint32)
    jp, js = j_quantize_pack(jnp.asarray(delta), jbits, p=math.inf, interpret=True)
    tp, ts = ops.quantize_pack_prng_op(_t(delta), tkey, (6,), p=math.inf)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def _nat_inputs(d, seed):
    """Values over 60 decades with zeros, +-2^k, the float below 2^k and
    FLT_MAX spliced in (subnormals code to 0 on both sides)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(d) * 10.0 ** rng.uniform(-30, 30, d)).astype(np.float32)
    pows = np.ldexp(np.float32(1.0), np.arange(-126, 128)).astype(np.float32)
    sp = np.concatenate([pows, np.nextafter(pows, np.float32(0)),
                         np.array([0.0, -0.0, 1e-40, np.finfo(np.float32).max], np.float32)])
    sp = np.concatenate([sp, -sp])
    pos = rng.choice(d, size=min(d, sp.size), replace=False)
    x[pos] = sp[:pos.size]
    return x


@pytest.mark.parametrize("sizes", [(1,), (4097,), (1, 2, 5, 3, 7, 1, 1, 9),
                                   (3, 1031, 2, 6, 1001, 1)])
def test_nat_pack_prng_matches_jax_bits_kernel(sizes):
    """Segment sizes that split groups of 4 (a boundary inside a float4)."""
    d = sum(sizes)
    x = _nat_inputs(d, seed=d)
    jkeys, tkeys = _keys(len(sizes), d)
    jbits = _jax_bits(jkeys, [(s,) for s in sizes])
    want = np.asarray(j_nat_pack(jnp.asarray(x), jbits, interpret=True))
    assert np.array_equal(want, np.asarray(jref.ref_nat_pack(jnp.asarray(x), jbits)))
    got = ref.ref_nat_pack_prng(_t(x), tkeys, sizes)
    assert got.dtype == torch.int16 and got.shape == (d,)
    assert np.array_equal(got.numpy(), want)
    out = torch.full((d,), 7, dtype=torch.int16)
    assert ops.nat_pack_prng_op(_t(x), tkeys, sizes, out=out) is out
    assert np.array_equal(out.numpy(), want)


def test_segment_bits_are_the_concatenated_draws():
    sizes = (5, 1, 0, 130)
    jkeys, tkeys = _keys(len(sizes), 3)
    want = np.asarray(_jax_bits(jkeys, [(s,) for s in sizes]))
    got = ops.segment_bits_op(tkeys, sizes, "cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().view(np.uint32), want)


def test_prng_wrappers_shapes_match_jax_eval_shape():
    """The JAX in-kernel-PRNG wrappers run compiled on a TPU only; their
    output shapes and dtypes are checked abstractly, as
    ``tests/test_kernels.py`` does, against the port's."""
    jout = jax.eval_shape(functools.partial(j_quantize_pack_prng, p=2.0),
                          jax.ShapeDtypeStruct((5, 256), jnp.float32),
                          jax.ShapeDtypeStruct((2,), jnp.int32))
    tp, ts = ops.quantize_pack_prng_op(torch.zeros((5, 256)), prng.PRNGKey(0), (5,), p=2.0)
    assert tuple(tp.shape) == jout[0].shape and tp.numpy().dtype == jout[0].dtype
    assert tuple(ts.shape) == jout[1].shape and ts.numpy().dtype == jout[1].dtype
    for d in (1, 1000, 1031):
        jo = jax.eval_shape(j_nat_pack_prng, jax.ShapeDtypeStruct((d,), jnp.float32),
                            jax.ShapeDtypeStruct((2,), jnp.int32))
        to = ops.nat_pack_prng_op(torch.zeros(d), prng.PRNGKey(0), (d,))
        assert tuple(to.shape) == jo.shape and to.numpy().dtype == jo.dtype


def test_prng_encodes_unbiased():
    """Over 2000 keys the decoded encodes average to the input
    (``tests/test_kernels.py``'s statistic: max |mean - x| < 0.2)."""
    x = np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32)
    keys = prng.split(prng.PRNGKey(5), 2000)
    tern = torch.zeros((4, 256), dtype=torch.float64)
    nat = torch.zeros(1024, dtype=torch.float64)
    for k in keys:
        pk, sc = ops.quantize_pack_prng_op(_t(x), k, (4,), p=math.inf)
        tern += ref.ref_unpack_reduce(pk[None], sc[None]).double()
        nat += ref.ref_nat_decode(ops.nat_pack_prng_op(_t(x).reshape(-1), k, (1024,))).double()
    assert np.abs(tern.numpy() / len(keys) - x).max() < 0.2
    assert np.abs(nat.numpy() / len(keys) - x.reshape(-1)).max() < 0.2
