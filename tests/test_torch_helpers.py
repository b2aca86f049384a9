"""The paper's helpers in the port against the JAX package, on the same
numpy-seeded inputs: ``compress_tree`` / ``decompress_tree`` for the five
operators on a mixed bf16 / f32 tree, ``quantize_pytree`` /
``dequantize_pytree`` / ``dequantize_blocks``, ``num_blocks``,
``packed_nbytes``, ``payload_nbits``, Theorem 1's ``expected_sparsity`` and
Lemma 2's ``quantization_variance``, the registry's ``register`` /
``alias``, and ``input_specs`` for every arch and shape.

Bitwise, except:

* natural compression's decoded values: the JAX package decodes with XLA's
  CPU ``exp2``, within ``EXP2_RTOL`` = 4.1e-6 of the exact power of two the
  port writes (``tests/test_torch_natural.py``); its codes are bitwise;
* the block norms for p in {1, 2}: an f32 sum over the block in another
  order, so the scales (and the decoded values, ``sign * scale``) are
  within ``NORM_ULPS`` = 4 ulp (``tests/test_torch_kernels.py``'s bound;
  a bf16 leaf's decode rounds both to the same bf16), the codes equal;
* ``expected_sparsity`` and ``quantization_variance``: f32 sums over blocks
  in another order, so within ``SUM_RTOL`` = 1e-5 (m ~ 10 blocks summed:
  a few f32 roundings).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES, input_specs as j_input_specs
from repro.core import quantization as JQ
from repro.core.compression import (CompressionConfig as JCfg, compress_tree as j_compress_tree,
                                    decompress_tree as j_decompress_tree)
from repro.core.compressors import registry as JR
from repro.core.compressors.base import payload_nbits as j_payload_nbits
from repro.core.packing import packed_nbytes as j_packed_nbytes
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.core import prng
from repro_torch.core import quantization as TQ
from repro_torch.core.compression import (CompressionConfig as TCfg, compress_tree,
                                          decompress_tree)
from repro_torch.core.compressors import (IdentityCompressor, available_methods, canonical_name,
                                          registry as TR)
from repro_torch.core.compressors.base import payload_nbits
from repro_torch.core.packing import packed_nbytes
from repro_torch.core.tree import flatten_nested

EXP2_RTOL = 4.1e-6
SUM_RTOL = 1e-5
NORM_ULPS = {math.inf: 0, 2.0: 4, 1.0: 4}
METHODS = ("diana", "natural", "randk", "topk_ef", "none")


def _tree():
    """A nested JAX tree (mixed bf16 / f32, leaves not multiples of the
    block) and the port's ``{path: tensor}`` of the same bits."""
    rng = np.random.default_rng(7)
    np_tree = {"blocks": {"w": rng.standard_normal((6, 50)).astype(np.float32),
                          "b": rng.standard_normal(37).astype(np.float32)},
               "embed": rng.standard_normal((9, 16)).astype(np.float32) * 3,
               "scale": rng.standard_normal(5).astype(np.float32)}
    jtree = {"blocks": {"w": jnp.asarray(np_tree["blocks"]["w"], jnp.bfloat16),
                        "b": jnp.asarray(np_tree["blocks"]["b"])},
             "embed": jnp.asarray(np_tree["embed"], jnp.bfloat16),
             "scale": jnp.asarray(np_tree["scale"])}
    ttree = {}
    for path, a in flatten_nested(jtree).items():
        a = np.asarray(a)
        ttree[path] = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                       if a.dtype.name == "bfloat16" else torch.from_numpy(a.copy()))
    return jtree, ttree


def _np(t):
    """A tensor as numpy (bf16 widened to f32, exactly)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def _fields_equal(jpay, tpay):
    for name in ("packed", "scales", "indices", "values"):
        j, t = getattr(jpay, name), getattr(tpay, name)
        assert (j is None) == (t is None), name
        if j is not None:
            j = np.asarray(j)
            got = t.view(torch.int16 if t.dtype == torch.uint16 else t.dtype)
            got = got.numpy().view(j.dtype) if j.dtype.itemsize == t.element_size() else got
            np.testing.assert_array_equal(np.asarray(got), j, err_msg=name)


@pytest.mark.parametrize("method", METHODS)
def test_compress_tree_and_decompress_tree_match_jax(method):
    jtree, ttree = _tree()
    over = dict(method=method, block_size=16, k=9)
    jpay, jloc = j_compress_tree(jtree, jax.random.PRNGKey(3), JCfg(**over))
    tpay, tloc = compress_tree(ttree, prng.PRNGKey(3), TCfg(**over))
    jpay_flat = dict(zip(sorted(ttree, key=lambda p: tuple(p.split("/"))),
                         jax.tree_util.tree_leaves(
                             jpay, is_leaf=lambda t: type(t).__name__ == "Payload")))
    assert sorted(tpay) == sorted(jpay_flat) == sorted(tloc)
    for path, jp in jpay_flat.items():
        _fields_equal(jp, tpay[path])
    if method == "diana":
        jloc_flat = dict(zip(sorted(jpay_flat, key=lambda p: tuple(p.split("/"))),
                             jax.tree_util.tree_leaves(
                                 jloc, is_leaf=lambda t: type(t).__name__ == "QuantizedBlocks")))
        for path, q in jloc_flat.items():
            np.testing.assert_array_equal(tloc[path].signs.numpy(), np.asarray(q.signs))
            np.testing.assert_array_equal(tloc[path].scales.numpy(), np.asarray(q.scales))
    else:
        assert all(tloc[p] is tpay[p] for p in tpay)
    jout = flatten_nested(j_decompress_tree(jpay, jtree, JCfg(**over)))
    tout = decompress_tree(tpay, ttree, TCfg(**over))
    for path, j in jout.items():
        assert tout[path].dtype == ttree[path].dtype and tout[path].shape == ttree[path].shape
        if method == "natural":
            np.testing.assert_allclose(_np(tout[path]), _jnp(j), rtol=EXP2_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(_np(tout[path]), _jnp(j), err_msg=path)


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0], ids=["inf", "2", "1"])
def test_quantize_pytree_and_dequantize_pytree_match_jax(p):
    jtree, ttree = _tree()
    jq = JQ.quantize_pytree(jtree, jax.random.PRNGKey(5), p=p, block_size=16)
    tq = TQ.quantize_pytree(ttree, prng.PRNGKey(5), p=p, block_size=16)
    for path, q in flatten_nested(jq).items():
        np.testing.assert_array_equal(tq[path].signs.numpy(), np.asarray(q.signs), err_msg=path)
        assert _ulps(tq[path].scales.numpy(), np.asarray(q.scales)) <= NORM_ULPS[p], path
    jout = flatten_nested(JQ.dequantize_pytree(jq, jtree))
    tout = TQ.dequantize_pytree(tq, ttree)
    for path, j in jout.items():
        assert tout[path].dtype == ttree[path].dtype
        got, want = _np(tout[path]), _jnp(j)
        if tout[path].dtype == torch.bfloat16 or p == math.inf:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            assert _ulps(got, want) <= NORM_ULPS[p], path


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0], ids=["inf", "2", "1"])
@pytest.mark.parametrize("block", [16, 128])
def test_quantize_blocks_of_a_bf16_leaf_bitwise(p, block):
    """A bf16 leaf's codes and scales bitwise the jitted JAX function's: the
    block norm rounded to bf16 as XLA stores it (``_narrow_norm``), over
    leaves of several scales."""
    for seed in range(4):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(1000) * rng.uniform(0.01, 100)).astype(np.float32)
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16)
        jq = JQ.quantize_blocks(jx, jax.random.PRNGKey(seed), p=p, block_size=block)
        tq = TQ.quantize_blocks(tx, prng.PRNGKey(seed), p=p, block_size=block)
        np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
        np.testing.assert_array_equal(tq.signs.numpy(), np.asarray(jq.signs))


def test_dequantize_blocks_shapes_and_dtypes():
    _, ttree = _tree()
    jtree, _ = _tree()
    tq = TQ.quantize_blocks(ttree["blocks/w"], prng.PRNGKey(1), block_size=16)
    jq = JQ.quantize_blocks(jtree["blocks"]["w"], jax.random.PRNGKey(1), block_size=16)
    for shape, dtype, jdt in [(None, torch.float32, jnp.float32), ((6, 50), torch.float32,
                                                                  jnp.float32),
                              ((300,), torch.bfloat16, jnp.bfloat16)]:
        got = TQ.dequantize_blocks(tq, shape, dtype)
        want = JQ.dequantize_blocks(jq, shape, jdt)
        assert tuple(got.shape) == want.shape and got.dtype == dtype
        np.testing.assert_array_equal(_np(got), _jnp(want))


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0, 3.0], ids=["inf", "2", "1", "3"])
@pytest.mark.parametrize("block", [16, 64])
def test_theory_quantities_match_jax(p, block):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(150).astype(np.float32)
    x[20:40] = 0.0                                  # a zero block: sparsity 0 there
    for jf, tf in [(JQ.expected_sparsity, TQ.expected_sparsity),
                   (JQ.quantization_variance, TQ.quantization_variance)]:
        want = float(jf(jnp.asarray(x), p, block))
        got = tf(torch.from_numpy(x), p, block)
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=SUM_RTOL)


def test_counts_match_jax():
    for d in (1, 3, 4, 5, 2047, 2048, 2049, 10 ** 6 + 3):
        for b in (4, 16, 2048):
            assert TQ.num_blocks(d, b) == JQ.num_blocks(d, b)
        assert packed_nbytes(d) == j_packed_nbytes(d)
    assert TQ.np_prod((3, 4, 5)) == JQ.np_prod((3, 4, 5)) == 60 and TQ.np_prod(()) == 1
    jtree, ttree = _tree()
    for method in METHODS:
        over = dict(method=method, block_size=16, k=9)
        jpay, _ = j_compress_tree(jtree, jax.random.PRNGKey(0), JCfg(**over))
        tpay, _ = compress_tree(ttree, prng.PRNGKey(0), TCfg(**over))
        jbits = [j_payload_nbits(x) for x in jax.tree_util.tree_leaves(
            jpay, is_leaf=lambda t: type(t).__name__ == "Payload")]
        tbits = [payload_nbits(tpay[p]) for p in sorted(tpay, key=lambda q: tuple(q.split("/")))]
        assert tbits == jbits, method


def test_register_and_alias_reach_the_config():
    """The built-in registry answers as the JAX package's; a new factory and
    an alias of it are reachable from ``CompressionConfig``, then removed."""
    assert available_methods() == JR.available_methods()
    for m in available_methods():
        assert canonical_name(m) == JR.canonical_name(m)
        assert TR._ALIASES.get(m, (m, {})) == JR._ALIASES.get(m, (m, {}))
    made = []

    @TR.register("test_dense")
    def _dense(cfg, *, scale=1.0):
        made.append(scale)
        return IdentityCompressor()

    TR.alias("test-dense-x2", "test_dense", scale=2.0)
    try:
        assert "test_dense" in available_methods() and "test-dense-x2" in available_methods()
        assert canonical_name("test-dense-x2") == "test_dense"
        assert isinstance(TCfg(method="test_dense").make(), IdentityCompressor)
        TCfg(method="test-dense-x2").make()
        TCfg(method="diana", down_method="test-dense-x2")
        assert made == [1.0, 2.0]
    finally:
        del TR._FACTORIES["test_dense"], TR._ALIASES["test-dense-x2"]
    assert available_methods() == JR.available_methods()
    with pytest.raises(KeyError, match="unknown compression method"):
        TCfg(method="test_dense")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match_jax(arch):
    dt = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.int32): torch.int32}
    assert sorted(SHAPES) == sorted(J_SHAPES)
    for name in SHAPES:
        want = j_input_specs(j_get_config(arch), J_SHAPES[name])
        got = input_specs(get_config(arch), SHAPES[name])
        assert list(got) == list(want)
        for k, s in want.items():
            assert got[k] == (tuple(s.shape), dt[s.dtype]), (name, k)
