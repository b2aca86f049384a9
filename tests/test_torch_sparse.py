"""Rand-k and top-k with error feedback in the port against the JAX package,
on the same numpy-seeded inputs.

What is bitwise and what is not, and why:

* The plain kernel versions (``ref_sparse_gather``, ``ref_sparse_decode_sum``,
  ``_mean``) equal the JAX package's ``kernels/ref.py`` and its Pallas kernels
  (``interpret=True``) bit for bit, signed zeros included, on inputs without
  subnormals.  XLA's CPU build flushes subnormal inputs and results to zero;
  the port keeps IEEE subnormals (:func:`test_subnormals_kept_where_xla_flushes`).
* Selection reproduces ``lax.top_k``'s set and order, ties included.
* ``reference_step`` equals the jitted JAX ``reference_step`` bitwise in
  ghat, ``h_worker`` and ``h_server``, in both layouts, for n in {1, 2, 4}.
  For n = 3 the jitted reference divides the worker sum by n as
  ``s * f32(1/3)`` (XLA's simplifier; in the per-leaf layout it also folds
  ``alpha * f32(1/3)`` into one constant), where the port takes the IEEE
  ``s / 3``: payloads and ``h_worker`` stay bitwise, ghat and ``h_server``
  agree within 2 ulp of the magnitudes summed into them, and the test shows
  that the division is the whole difference (ROADMAP.md queue 3).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bucket import BucketedCompressor as JBucketed
from repro.core.compression import CompressionConfig as JCfg
from repro.core.compressors.base import Payload as JPayload, index_dtype as j_index_dtype
from repro.core.compressors.randk import RandKCompressor as JRandK, _uniform_subset
from repro.core.compressors.topk_ef import TopKEFCompressor as JTopK
from repro.core.diana import bucket_layout as j_layout
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro.kernels import ref as jref
from repro.kernels.sparse import (sparse_decode_sum as j_decode_sum,
                                  sparse_decode_sum_mean as j_decode_sum_mean,
                                  sparse_gather as j_gather)
from repro_torch.core import numerics, prng
from repro_torch.core.bucket import bucketed_compressor
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.compression import payload_bits_per_dim as t_bits
from repro_torch.core.compressors import Payload, RandKCompressor, TopKEFCompressor
from repro_torch.core.compressors import base as tbase
from repro_torch.core.compressors.randk import uniform_subset
from repro_torch.core.compressors.sparse import top_k_indices
from repro_torch.core.diana import (bucket_layout as t_layout, reference_init as t_init,
                                    reference_step as t_step, worker_key)
from repro_torch.core.numerics import SegmentRates, fma32
from repro_torch.core.tree import flatten_nested
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
F32_EPS = 2.0 ** -23


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(a, b):
    return np.array_equal(_bits(a), _bits(b))


def _jcomp(method, k):
    return (JRandK(k, use_kernel=False) if method == "randk"
            else JTopK(k, use_kernel=False))


def _tcomp(method, k):
    return RandKCompressor(k) if method == "randk" else TopKEFCompressor(k)


# ----------------------------------------------------------- plain versions

def _sparse_inputs(n, d, k, seed):
    """Indices unique per worker with both ends present, values over 40
    decades with -0.0, +-inf and products that underflow to -0.0 (no
    subnormal anywhere), a per-entry scale."""
    rng = np.random.default_rng(seed)
    idx = np.empty((n, k), np.int64)
    for i in range(n):
        row = np.concatenate([[0, d - 1], rng.choice(np.arange(1, d - 1), k - 2,
                                                     replace=False)])
        idx[i] = rng.permutation(row)
    values = (rng.standard_normal((n, k)) * 10.0 ** rng.uniform(-20, 20, (n, k))
              ).astype(np.float32)
    scale = np.full(k, np.float32(d / k), np.float32)
    values[:, 0] = -0.0
    values[0, 1], values[0, 2] = np.inf, -np.inf
    scale[3:6] = np.float32(1e-30)
    values[:, 3:6] = -1e-20           # -1e-50 underflows to -0.0
    return idx.astype(j_index_dtype(d)), values, scale


@pytest.mark.parametrize("n,d", [(1, 200), (2, 3000), (3, 70001), (4, 3000)])
def test_plain_versions_match_jax_ref_and_pallas(n, d):
    k = min(150, d - 2)
    idx, values, scale = _sparse_inputs(n, d, k, seed=n * 7 + d)
    ti, tv, ts = _t(idx), _t(values), _t(scale)
    assert ti.dtype == tbase.index_dtype(d)
    ji, jv, js = jnp.asarray(idx), jnp.asarray(values), jnp.asarray(scale)

    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    tg = ref.ref_sparse_gather(_t(x), ti[0]).numpy()
    assert _same(tg, jref.ref_sparse_gather(jnp.asarray(x), ji[0]))
    assert _same(tg, j_gather(jnp.asarray(x), ji[0].astype(jnp.int32), interpret=True))
    assert _same(ops.sparse_gather_op(_t(x), ti[0]).numpy(), tg)
    out = torch.full((k,), 7.0)
    assert ops.sparse_gather_op(_t(x), ti[0], out=out) is out and _same(out.numpy(), tg)

    s = ref.ref_sparse_decode_sum(ti, tv, ts, d).numpy()
    assert _same(s, jref.ref_sparse_decode_sum(ji, jv, js, d))
    assert _same(s, j_decode_sum(ji, jv, js, d=d, interpret=True))
    assert _same(ops.sparse_decode_sum_op(ti, tv, ts, d).numpy(), s)
    assert not np.any(np.signbit(s) & (s == 0))      # no -0.0 in any sum
    assert np.isposinf(s[idx[0, 1]]) and np.isneginf(s[idx[0, 2]])

    m = ref.ref_sparse_decode_sum_mean(ti, tv, ts, d).numpy()
    assert _same(ops.sparse_decode_sum_mean_op(ti, tv, ts, d).numpy(), m)
    assert _same(m, s / np.float32(n))                # IEEE division
    jm = np.asarray(j_decode_sum_mean(ji, jv, js, d=d, interpret=True))
    if n & (n - 1) == 0:
        assert _same(m, jm)
    else:
        # The jitted Pallas kernel divides as s * f32(1/n) (XLA's rewrite).
        assert _same(jm, s * np.float32(1.0 / n))
        fin = np.isfinite(m)
        assert np.all(np.abs(_bits(m[fin]).astype(np.int64) - _bits(jm[fin])) <= 1)


def test_subnormals_kept_where_xla_flushes():
    """Hazard: a value -1e-40 (subnormal) decodes to itself in the port, and
    to +0.0 in the JAX package's CPU reference (XLA flushes it)."""
    idx = np.array([[3, 1]], np.uint8)
    values = np.array([[-1e-40, 2.0 ** -140]], np.float32)
    scale = np.ones(2, np.float32)
    got = ref.ref_sparse_decode_sum(_t(idx), _t(values), _t(scale), 5).numpy()
    assert got[3] == np.float32(-1e-40) and got[1] == np.float32(2.0 ** -140)
    want = np.asarray(jref.ref_sparse_decode_sum(jnp.asarray(idx), jnp.asarray(values),
                                                 jnp.asarray(scale), 5))
    assert want[3] == 0.0 and want[1] == 0.0
    assert np.array_equal(np.delete(got, [1, 3]), np.delete(want, [1, 3]))


# ----------------------------------------------------------------- selection

def test_top_k_ties_match_lax_order():
    tags = np.array([5, 3, 5, 7, 3, 5, 0, 0, 7], np.uint32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(tags), 6)[1])
    assert want.tolist() == [3, 8, 0, 2, 5, 1]
    assert top_k_indices(_t(tags.astype(np.int64)), 6).tolist() == want.tolist()
    x = np.array([0.0, -0.0, 2.0, 2.0, 1.0, 0.0], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)), 5)[1])
    assert want.tolist() == [2, 3, 4, 0, 1]
    assert TopKEFCompressor(5)._select(_t(x), 5, None).tolist() == want.tolist()

    rng = np.random.default_rng(0)
    tags = rng.integers(0, 8, 5000).astype(np.uint32)
    tags[::97] = 2**32 - 1
    mags = rng.standard_normal(5000).astype(np.float32)
    mags = np.where(rng.random(5000) < 0.3, 0.0,
                    np.asarray(jnp.asarray(mags).astype(jnp.bfloat16).astype(jnp.float32)))
    mags[::11] = -mags[::11]
    for k in (1, 100, 4999, 5000):
        want = np.asarray(jax.lax.top_k(jnp.asarray(tags), k)[1])
        assert np.array_equal(top_k_indices(_t(tags.astype(np.int64)), k).numpy(), want), k
        want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(mags)), k)[1])
        assert np.array_equal(TopKEFCompressor(k)._select(_t(mags), k, None).numpy(), want), k


@pytest.mark.parametrize("d,k", [(1, 1), (70, 9), (70, 70), (3000, 100), (70001, 517)])
def test_uniform_subset_matches_jax(d, k):
    key = prng.fold_in(prng.PRNGKey(5), d)
    want = np.asarray(_uniform_subset(jax.random.fold_in(jax.random.PRNGKey(5), d), d, k))
    got = uniform_subset(key, d, k, "cpu")
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


# -------------------------------------------------------------- per-leaf hooks

@pytest.mark.parametrize("method", ["randk", "topk_ef"])
def test_perleaf_hooks_match_jax(method):
    """compress (index dtype, indices and values in JAX's order), decode,
    decode_sum and the server tail (jitted on the JAX side) for 4 workers
    at three index widths; the fused hooks equal the base composition."""
    n, k = 4, 100
    for d in (70, 3000, 70001):
        rng = np.random.default_rng(d)
        deltas = (rng.standard_normal((n, d)) * 10.0 ** rng.uniform(-3, 3, (n, 1))
                  ).astype(np.float32)
        h = rng.standard_normal(d).astype(np.float32)
        jc, tc = _jcomp(method, k), _tcomp(method, k)
        jpays, tpays = [], []
        for w in range(n):
            jp = jc.compress(jnp.asarray(deltas[w]),
                             jax.random.fold_in(jax.random.PRNGKey(3), w))
            tp = tc.compress(_t(deltas[w]), prng.fold_in(prng.PRNGKey(3), w))
            assert tp.indices.numpy().dtype == np.asarray(jp.indices).dtype
            assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))
            assert _same(tp.values.numpy(), jp.values)
            assert _same(tc.decode(tp, d).numpy(), jax.jit(lambda p: jc.decode(p, d))(jp))
            jpays.append(jp)
            tpays.append(tp)
        jg = JPayload(indices=jnp.stack([p.indices for p in jpays]),
                      values=jnp.stack([p.values for p in jpays]))
        tg = Payload.stack(tpays)
        ts = tc.decode_sum(tg, n, d)
        assert _same(ts.numpy(), jax.jit(lambda g: jc.decode_sum(g, n, d))(jg))
        assert torch.equal(ts, tbase.Compressor.decode_sum(tc, tg, n, d))
        jgh, jnh = jax.jit(lambda g, hh: jc.decode_sum_apply(g, n, d, hh))(jg, jnp.asarray(h))
        tgh, tnh = tc.decode_sum_apply(tg, n, d, _t(h))
        assert _same(tgh.numpy(), jgh) and _same(tnh.numpy(), jnh)
        base = tbase.Compressor.decode_sum_apply(tc, tg, n, d, _t(h))
        assert torch.equal(tgh, base[0]) and torch.equal(tnh, base[1])
        dh = tc.decode(tpays[0], d)
        jnm = jax.jit(lambda hh, dd, de: jc.next_memory(hh, dd, de))(
            jnp.asarray(h), jnp.asarray(dh.numpy()), jnp.asarray(deltas[0]))
        assert _same(tc.next_memory(_t(h), dh, _t(deltas[0])).numpy(), jnm)
        assert tc.bits_per_dim(d) == jc.bits_per_dim(d) and tc.memory_alpha(d) == \
            jc.memory_alpha(d)
        g = _t(deltas[1]).clone()
        want = tc.compress_input(g, _t(h))
        assert torch.equal(tc.compress_input_(g, _t(h)), want) and torch.equal(g, want)


def test_memoryless_randk_mean_and_bucketed_payload():
    """``RandKCompressor(memory=False)``: ONE ``sparse_decode_sum_mean`` gives
    ghat and the server memory is untouched; the bucketed payload (global
    indices in the buffer's index width + values), written into a worker's
    row of the gathered buffer, equals the JAX package's in order."""
    tree = _grads(np.random.default_rng(3), 1)
    jparams = jax.tree_util.tree_map(lambda g: jnp.asarray(g[0]), tree)
    tl = t_layout(TCfg(method="randk", k=100, bucketed=True),
                  {p: _t(g[0]) for p, g in flatten_nested(tree).items()})
    jl = j_layout(JCfg(method="randk", k=100, bucketed=True), jparams)
    flat = np.asarray(jl.flatten(jparams))
    for method in ("randk", "topk_ef"):
        jbc = JBucketed(_jcomp(method, 100), jl)
        tbc = bucketed_compressor(TCfg(method=method, k=100, bucketed=True), tl)
        jp = jbc.compress(jnp.asarray(flat), jax.random.PRNGKey(4))
        buf = tbc.gathered(2, "cpu")
        tp = tbc.compress(_t(flat), prng.PRNGKey(4), out=buf.select(1))
        kk = tbc.base.payload_length(tl)
        assert kk == 370 and tuple(buf.values.shape) == (2, kk)
        assert tp.values.data_ptr() == buf.values[1].data_ptr()
        assert tp.indices.dtype == tbase.index_dtype(tl.padded_size) == torch.uint16
        assert buf.indices.numpy().dtype == np.asarray(jp.indices).dtype
        assert np.array_equal(buf.indices[1].numpy(), np.asarray(jp.indices))
        assert _same(buf.values[1].numpy(), jp.values)
    comp = RandKCompressor(9, memory=False)
    tg = Payload.stack([comp.compress(_t(flat[:3000] * (w + 1)), prng.PRNGKey(w))
                        for w in range(3)])
    hs = torch.ones(3000)
    ghat, new_h = comp.decode_sum_apply(tg, 3, 3000, hs)
    assert new_h is hs and comp.memory_alpha(3000) == 0.0
    assert torch.equal(ghat, numerics.div_n(comp.decode_sum(tg, 3, 3000), 3))


# ----------------------------------------------------------- the DIANA round

def _grads(rng, n):
    def draw(shape):
        return (rng.standard_normal((n, *shape)) * rng.random()).astype(np.float32)
    return {"a": draw((3000,)), "blk": {"w": draw((40, 70)), "scale": draw((70,))},
            "emb": draw((5, 130))}


def _flat(tree, layout):
    """A param-shaped or per-leaf ``(d,)`` tree (or a flat buffer) as one
    vector in the bucket layout (the sparse layouts have no padding)."""
    if isinstance(tree, dict):
        tree = {p: np.asarray(v) for p, v in flatten_nested(tree).items()}
        return np.concatenate([tree[p].reshape(-1) for p in layout.paths])
    return np.asarray(tree)


def _run(method, bucketed, n, k=100, steps=3, jax_side=True):
    """``steps`` jitted JAX and port reference steps from the same grads; per
    step both sides' ghat / h_worker / h_server in the flat layout."""
    rng = np.random.default_rng(17 + n)
    grads = [_grads(rng, n) for _ in range(steps)]
    shapes = {p: g.shape[1:] for p, g in flatten_nested(grads[0]).items()}
    tl = t_layout(TCfg(method=method, k=k, bucketed=True),
                  {p: torch.zeros(s) for p, s in shapes.items()})
    tcfg = TCfg(method=method, k=k, bucketed=bucketed)
    ts = t_init({p: torch.zeros(s) for p, s in shapes.items()}, tcfg, n)
    if jax_side:
        jcfg = JCfg(method=method, k=k, bucketed=bucketed, use_kernel=False)
        js = j_init(jax.tree_util.tree_map(lambda g: jnp.zeros(g.shape[1:]), grads[0]), jcfg, n)
        jstep = jax.jit(lambda g, s, kk: j_step(g, s, kk, jcfg))
    out = []
    for s in range(steps):
        r = {}
        if jax_side:
            jv, js = jstep(jax.tree_util.tree_map(jnp.asarray, grads[s]), js,
                           jax.random.fold_in(jax.random.PRNGKey(0), s))
            r.update(jghat=_flat(flatten_nested(jax.tree_util.tree_map(np.asarray, jv)), tl),
                     jhw=_hw(js.h_worker, tl), jhs=_flat(js.h_server, tl))
        tv, ts = t_step({p: _t(g) for p, g in flatten_nested(grads[s]).items()}, ts,
                        prng.fold_in(prng.PRNGKey(0), s), tcfg)
        r.update(tghat=_flat({p: v.numpy() for p, v in tv.items()}, tl),
                 thw=_hw(ts.h_worker, tl), ths=_flat(ts.h_server, tl))
        out.append(r)
    return out


def _hw(h, layout):
    if isinstance(h, dict):
        h = {p: np.asarray(v) for p, v in flatten_nested(h).items()}
        return np.concatenate([h[p].reshape(h[p].shape[0], -1) for p in layout.paths], axis=1)
    return np.asarray(h)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("method", ["randk", "topk_ef"])
def test_reference_step_matches_jitted_jax(method, bucketed, n):
    """k = 100 keeps every coordinate of the 70-element leaf and a share of
    the others, so rand-k's rates differ per segment (100/3000, 1.0,
    100/2800, 100/650)."""
    for r in _run(method, bucketed, n):
        for side in ("ghat", "hw", "hs"):
            assert _same(r["t" + side], r["j" + side]), side


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("method", ["randk", "topk_ef"])
def test_reference_step_n3_division(method, bucketed, monkeypatch):
    """n = 3: the jitted reference divides the worker sum as ``s * f32(1/3)``
    and the port as ``s / 3``.  h_worker (which no division reaches) stays
    bitwise; ghat and h_server agree within 2 ulp of the magnitudes summed
    into them over the steps.  With the port's division swapped for XLA's
    product, top-k's ghat and the bucketed rand-k server memory become
    bitwise: the whole difference is the division.  (rand-k's ghat
    ``h + s * f32(1/3)`` is then one FMA in XLA's graph, and in the per-leaf
    layout XLA folds ``alpha * f32(1/3)`` into one constant.)"""
    ieee = _run(method, bucketed, 3)
    scale = np.zeros_like(ieee[0]["jhs"], np.float64)
    prev_hs = np.zeros_like(scale)
    for r in ieee:
        assert _same(r["thw"], r["jhw"])
        scale += np.abs(r["jghat"]) + np.abs(r["jhs"]) + prev_hs
        prev_hs = np.abs(r["jhs"]).astype(np.float64)
        for side in ("ghat", "hs"):
            assert np.all(np.abs(r["t" + side] - r["j" + side]) <= 2 * F32_EPS * scale), side

    def xla_div(s, n):
        return s * torch.tensor(np.float32(1.0 / n), dtype=s.dtype, device=s.device)

    for mod in (tbase, ref):
        monkeypatch.setattr(mod, "div_n", xla_div)
    for r in _run(method, bucketed, 3):
        assert _same(r["thw"], r["jhw"])
        if method == "topk_ef":
            assert _same(r["tghat"], r["jghat"]) and _same(r["ths"], r["jhs"])
        elif bucketed:
            assert _same(r["ths"], r["jhs"])


@pytest.mark.parametrize("method", ["randk", "topk_ef"])
def test_port_bucketed_equals_perleaf_bitwise(method):
    """Bucketed == per-leaf inside the port for n in {3, 4} (at n = 3 too: the
    port divides the same way in both layouts)."""
    for n in (3, 4):
        b = _run(method, True, n, jax_side=False)
        p = _run(method, False, n, jax_side=False)
        for rb, rp in zip(b, p):
            for key in ("tghat", "thw", "ths"):
                assert _same(rb[key], rp[key]), (n, key)


def test_segment_rates_fma_matches_jitted_jax_vector():
    """Hazard: the bucketed memory rate is a constant (Dp,) vector in the JAX
    package; XLA contracts ``h + alpha_vec * x`` into one FMA under jit, and
    the port's per-segment ``fma32`` takes each segment's scalar."""
    sizes, rates = (3000, 70, 2800, 650), (100 / 3000, 1.0, 100 / 2800, 100 / 650)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1]))
    rng = np.random.default_rng(2)
    h, x = (rng.standard_normal((2, sum(sizes))) * 10.0 ** rng.uniform(-5, 5, sum(sizes))
            ).astype(np.float32)
    avec = jnp.asarray(np.concatenate([np.full(s, r, np.float32) for s, r in zip(sizes, rates)]))
    want = np.asarray(jax.jit(lambda hh, xx: hh + avec * xx)(jnp.asarray(h), jnp.asarray(x)))
    got = fma32(SegmentRates(rates, offsets, sizes), _t(x), _t(h)).numpy()
    assert _same(got, want)
    two = (h + (np.asarray(avec) * x).astype(np.float32)).astype(np.float32)
    assert not _same(two, want)               # the contraction is visible here
    with pytest.raises(ValueError):
        fma32(SegmentRates(rates, offsets, sizes), _t(x[:10]), _t(h[:10]))


def test_registry_config_and_accounting_match_jax():
    from repro.core.compression import payload_bits_per_dim as j_bits

    for name, canon in (("randk", "randk"), ("rand-k", "randk"), ("topk_ef", "topk_ef"),
                        ("top-k-ef", "topk_ef")):
        c = TCfg(method=name, k=9).make()
        assert c.name == canon and c.k == 9
        assert t_bits(TCfg(method=name, k=9), 70) == j_bits(JCfg(method=name, k=9), 70)
    assert TCfg().k == JCfg().k == 64
    for d in (1, 256, 257, 65536, 65537):
        assert tbase.index_dtype(d).itemsize == np.dtype(j_index_dtype(d)).itemsize
        assert tbase.index_nbits(d) == 8 * np.dtype(j_index_dtype(d)).itemsize
    tree = {p: torch.zeros(g.shape[1:]) for p, g in
            flatten_nested(_grads(np.random.default_rng(0), 1)).items()}
    jtree = {p: jnp.zeros(v.shape) for p, v in tree.items()}
    for method in ("randk", "topk_ef"):
        tl = t_layout(TCfg(method=method, k=100, bucketed=True), tree)
        jl = j_layout(JCfg(method=method, k=100, bucketed=True), jtree)
        assert tl.align == 1 and (tl.sizes, tl.offsets) == (jl.sizes, jl.offsets)
        tbc = bucketed_compressor(TCfg(method=method, k=100, bucketed=True), tl)
        jbc = JBucketed(_jcomp(method, 100), jl)
        assert tbc.bits_per_dim() == jbc.bits_per_dim()
        ta, ja = tbc.base.bucketed_alpha(tl), jbc.base.bucketed_alpha(jl)
        if method == "topk_ef":
            assert ta == ja == 1.0
        else:
            vec = np.concatenate([np.full(s, r, np.float32)
                                  for r, s in zip(ta.rates, ta.sizes)])
            assert ta.offsets == tl.offsets and np.array_equal(vec, np.asarray(ja))
    assert TCfg(method="identity").make().name == "identity"   # ported too


def test_worker_key_schedule_matches_jax_bucketed_payload():
    """The trainer's per-worker key: bucketed rand-k payloads at
    ``worker_key(key, w)`` equal the JAX package's at ``fold_in(key, w)``."""
    tree = _grads(np.random.default_rng(5), 1)
    jparams = jax.tree_util.tree_map(lambda g: jnp.asarray(g[0]), tree)
    jl = j_layout(JCfg(method="randk", k=9, bucketed=True), jparams)
    tl = t_layout(TCfg(method="randk", k=9, bucketed=True),
                  {p: _t(g[0]) for p, g in flatten_nested(tree).items()})
    flat = np.asarray(jl.flatten(jparams))
    jbc = JBucketed(JRandK(9, use_kernel=False), jl)
    tbc = bucketed_compressor(TCfg(method="randk", k=9, bucketed=True), tl)
    for w in range(3):
        jp = jbc.compress(jnp.asarray(flat), jax.random.fold_in(jax.random.PRNGKey(8), w))
        tp = tbc.compress(_t(flat), worker_key(prng.PRNGKey(8), w))
        assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))
        assert _same(tbc.decode(tp).numpy(), jax.jit(jbc.decode)(jp))


@pytest.mark.parametrize("method", ["randk", "topk_ef"])
def test_trainer_cli_runs_sparse_on_cpu(method):
    # One torch thread: the test suite runs several workers on the CPU.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
         "--reduced", "--device", "cpu", "--mesh", "2x1", "--steps", "2",
         "--batch", "4", "--seq", "32", "--compression", method, "--comp-k", "9"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
