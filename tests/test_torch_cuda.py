"""The CUDA kernels against their plain versions on the card, at edge shapes
(rows not a multiple of 8, one worker, a short ``h``; for the natural
kernels odd lengths, 1-3 workers and rows that are not 8-byte aligned; for
the sparse kernels k = 1 and k = d, odd k, the three index widths, indices
at both ends, -0.0, +-inf and products that underflow to -0.0, rows of a
wider gathered buffer, more workers than one launch group (513, 1025); for
the in-kernel-PRNG encodes one-row and empty segments, segment boundaries
between rows, inside a group of 4, inside the peeled head and inside a
warp's chunk, B in {128, 2048, 4096} with row counts below and above the
grid's warps, a segment past 2^32 words (17 GB of f32), and equality with
the bits kernels fed ``threefry_bits``; for the dense kernels odd d, 1-5
workers, rows at unaligned starts, -0.0, +-inf and NaN; and every operator's
kernels on the chunk views of the wire schedule, odd offsets included).
Needs an NVIDIA GPU: each test skips without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.compressors.base import index_dtype
from repro_torch.core.numerics import div_n
from repro_torch.kernels import build, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the CPU runs the plain versions")
    return torch.device("cuda", 0)


def test_threefry_bits_bitwise(dev):
    key = prng.fold_in(prng.PRNGKey(0), 3)
    for shape in [(1,), (3,), (4097,), (13, 128), (1000, 2048)]:
        before = build.LAUNCHES["threefry_bits"]
        got = ops.bits_op(key, shape, dev)
        assert build.LAUNCHES["threefry_bits"] == before + 1
        assert torch.equal(got, prng.bits(key, shape, device=dev))


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0, 3.0])
@pytest.mark.parametrize("m,b", [(13, 128), (300, 2048)])
def test_quantize_pack(dev, p, m, b):
    g = torch.Generator(device=dev).manual_seed(0)
    delta = torch.randn((m, b), generator=g, device=dev)
    delta[1] = 0.0
    bits = ops.bits_op(prng.PRNGKey(1), (m, b), dev)
    kp, ks = ops.quantize_pack_op(delta, bits, p=p)
    pp, ps = ref.ref_quantize_pack(delta, bits, p)
    if p == math.inf:
        assert torch.equal(kp, pp) and torch.equal(ks, ps)
    else:
        ulp = (ks.view(torch.int32).long() - ps.view(torch.int32).long()).abs().max()
        assert int(ulp) <= 4
        same = sum(int(((kp >> s) & 3).eq((pp >> s) & 3).sum()) for s in (0, 2, 4, 6))
        assert same >= 0.9999 * m * b


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("m", [13, 300])
@pytest.mark.parametrize("d_short", [0, 100])
def test_unpack_reduce_family(dev, n, m, d_short):
    g = torch.Generator(device=dev).manual_seed(1)
    packed = torch.randint(0, 256, (n, m, 512), generator=g, device=dev, dtype=torch.uint8)
    scales = torch.rand((n, m, 1), generator=g, device=dev) * 3
    assert torch.equal(ops.unpack_reduce_op(packed, scales), ref.ref_unpack_reduce(packed, scales))
    assert torch.equal(ops.unpack_reduce_mean_op(packed, scales),
                       ref.ref_unpack_reduce_mean(packed, scales))
    h = torch.randn(m * 2048 - d_short, generator=g, device=dev)
    got = ops.unpack_reduce_apply_op(packed, scales, h, alpha=0.0217)
    want = ref.ref_unpack_reduce_apply(packed, scales, h, 0.0217, n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_reject_bad_inputs(dev):
    delta = torch.zeros((4, 102), device=dev)     # a block the 2-bit packing cannot split
    with pytest.raises(ValueError):
        ops.quantize_pack_op(delta, torch.zeros((4, 102), dtype=torch.int32, device=dev),
                             p=math.inf)
    with pytest.raises(ValueError):
        ops.unpack_reduce_op(torch.zeros((2, 3, 8), dtype=torch.uint8, device=dev),
                             torch.zeros((2, 4, 1), device=dev))


def _special(dev):
    """Zeros, +-2^k, the float just below each 2^k, subnormals, FLT_MAX."""
    pows = torch.ldexp(torch.ones(254, device=dev), torch.arange(-126, 128, device=dev))
    below = torch.nextafter(pows, torch.zeros_like(pows))
    tiny = torch.tensor([1e-45, 3e-39, 1.1754942e-38, 0.0, -0.0, 3.4028235e38], device=dev)
    v = torch.cat([pows, below, tiny])
    return torch.cat([v, -v])


def _nat_inputs(dev, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(d, generator=g, device=dev) * 10.0 ** (
        torch.rand(d, generator=g, device=dev) * 60 - 30)
    sp = _special(dev)
    k = min(d, sp.numel())
    x[torch.randperm(d, generator=g, device=dev)[:k]] = sp[:k]
    bits = torch.randint(-2**31, 2**31, (d,), generator=g, device=dev, dtype=torch.int32)
    return x, bits


@pytest.mark.parametrize("d", [1, 3, 1001, 4097])
def test_nat_pack(dev, d):
    x, bits = _nat_inputs(dev, d, seed=d)
    want = ref.ref_nat_pack(x, bits)
    before = build.LAUNCHES["nat_pack"]
    assert torch.equal(ops.nat_pack_op(x, bits), want)
    # into the rows of a gathered buffer whose rows are only 2-byte aligned
    buf = torch.zeros((3, d + 1), dtype=torch.int16, device=dev)
    for w in range(3):
        assert ops.nat_pack_op(x, bits, out=buf[w, :d]) is not None
        assert torch.equal(buf[w, :d], want) and int(buf[w, d]) == 0
    # x and bits one element off their 16-byte alignment, and off each other's
    xb = torch.empty(d + 2, device=dev)
    bb = torch.empty(d + 2, dtype=torch.int32, device=dev)
    xb[1:d + 1], bb[2:] = x, bits
    assert torch.equal(ops.nat_pack_op(xb[1:d + 1], bits), want)
    assert torch.equal(ops.nat_pack_op(xb[1:d + 1], bb[2:]), want)
    assert build.LAUNCHES["nat_pack"] == before + 6


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("d", [1, 3, 1001, 4097])
@pytest.mark.parametrize("ld_pad", [0, 1, 8])
def test_nat_decode_family(dev, n, d, ld_pad):
    """Rows ``d + ld_pad`` codes apart: contiguous (0), only 2-byte aligned
    for odd d (1), and 16-byte aligned where d is a multiple of 8 (8)."""
    g = torch.Generator(device=dev).manual_seed(n * 7 + d)
    buf = torch.randint(-288, 289, (n, d + ld_pad), generator=g, device=dev,
                        dtype=torch.int32).to(torch.int16)
    buf[:, ::5] = torch.randint(-10, 0, buf[:, ::5].shape, generator=g, device=dev,
                                dtype=torch.int32).to(torch.int16)   # -0.0 decodes
    codes = buf[:, :d]
    plain = codes.contiguous()
    assert _same_bits(ops.nat_decode_sum_op(codes), ref.ref_nat_decode_sum(plain))
    assert _same_bits(ops.nat_decode_sum_mean_op(codes), ref.ref_nat_decode_sum_mean(plain))
    hb = torch.randn(d + 1, generator=g, device=dev)
    for h in (hb[:d], hb[1:]):                  # 16-byte aligned, and 4-byte aligned
        got = ops.nat_decode_sum_apply_op(codes, h, alpha=8.0 / 9.0)
        want = ref.ref_nat_decode_sum_apply(plain, h, 8.0 / 9.0)
        assert all(_same_bits(a, b) for a, b in zip(got, want))


def test_nat_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(10, device=dev)
    with pytest.raises(ValueError):
        ops.nat_pack_op(x, torch.zeros(10, device=dev))              # bits not int32
    with pytest.raises(ValueError):
        ops.nat_pack_op(x, torch.zeros(10, dtype=torch.int32, device=dev),
                        out=torch.zeros(9, dtype=torch.int16, device=dev))
    with pytest.raises(ValueError):
        ops.nat_decode_sum_op(torch.zeros((2, 10), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        ops.nat_decode_sum_apply_op(torch.zeros((2, 10), dtype=torch.int16, device=dev),
                                    torch.zeros(9, device=dev), alpha=0.5)


def _sparse_case(dev, n, d, k, seed):
    """idx (n, k) unique per worker, 0 and d - 1 in worker 0's row, in
    ``index_dtype(d)``; values (n, k) with -0.0, +-inf and entries whose
    product with a 1e-30 scale underflows to -0.0; scale (k,)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(d)[:k] for _ in range(n)])
    if k >= 2 and d >= 2:
        row = [j for j in range(d) if j not in (0, d - 1)]
        idx[0] = rng.permutation(np.concatenate([[0, d - 1],
                                                 rng.choice(row, k - 2, replace=False)]))
    values = (rng.standard_normal((n, k))
              * 10.0 ** rng.uniform(-20, 20, (n, k))).astype(np.float32)
    scale = np.full(k, np.float32(d / k), np.float32)
    values[:, 0] = -0.0
    if k >= 4:
        values[0, 1], values[n - 1, 2] = np.inf, -np.inf
        scale[3] = 1e-30
        values[:, 3] = -1e-20
    return (torch.from_numpy(idx).to(index_dtype(d)).to(dev),
            torch.from_numpy(values).to(dev), torch.from_numpy(scale).to(dev))


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("d,k", [(1, 1), (5, 5), (200, 1), (200, 200), (3001, 1001),
                                 (70001, 4099)])
def test_sparse_family(dev, n, d, k):
    idx, values, scale = _sparse_case(dev, n, d, k, seed=n * 31 + d + k)
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(d, generator=g, device=dev)
    before = dict(build.LAUNCHES)
    # the gather into the rows of a wider gathered buffer (rows k + 3 apart)
    buf = torch.full((n, k + 3), 7.0, device=dev)
    for w in range(n):
        assert ops.sparse_gather_op(x, idx[w], out=buf[w, :k]) is not None
        assert _same_bits(buf[w, :k], ref.ref_sparse_gather(x, idx[w]))
        assert bool((buf[w, k:] == 7.0).all())
    assert _same_bits(ops.sparse_gather_op(x, idx[0]), ref.ref_sparse_gather(x, idx[0]))
    # the decode reads values from rows k + 3 apart and indices from a view too
    vbuf = torch.empty((n, k + 3), device=dev)
    vbuf[:, :k] = values
    ibuf = torch.zeros((n, k + 5), dtype=torch.int64, device=dev)
    ibuf[:, :k] = idx.to(torch.int64)
    iv = ibuf.to(idx.dtype)[:, :k]
    for vals, ids in ((values, idx), (vbuf[:, :k], iv)):
        s = ops.sparse_decode_sum_op(ids, vals, scale, d)
        assert _same_bits(s, ref.ref_sparse_decode_sum(idx, values, scale, d))
        assert not bool(((s == 0) & torch.signbit(s)).any())       # no -0.0
        assert _same_bits(ops.sparse_decode_sum_mean_op(ids, vals, scale, d),
                          ref.ref_sparse_decode_sum_mean(idx, values, scale, d))
    assert build.LAUNCHES["sparse_gather"] == before.get("sparse_gather", 0) + n + 1
    assert build.LAUNCHES["sparse_decode_sum"] == before.get("sparse_decode_sum", 0) + 2
    assert build.LAUNCHES["sparse_decode_sum_mean"] == \
        before.get("sparse_decode_sum_mean", 0) + 2


def test_sparse_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(10, device=dev)
    with pytest.raises(ValueError):
        ops.sparse_gather_op(x, torch.zeros(3, dtype=torch.int64, device=dev))  # not a wire width
    with pytest.raises(ValueError):
        ops.sparse_gather_op(x, torch.zeros(3, dtype=torch.uint8, device=dev),
                             out=torch.zeros(4, device=dev))
    idx = torch.zeros((2, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        ops.sparse_decode_sum_op(idx, torch.zeros((2, 3), device=dev),
                                 torch.zeros(4, device=dev), 10)
    with pytest.raises(ValueError):
        ops.sparse_decode_sum_mean_op(idx, torch.zeros((2, 4), device=dev),
                                      torch.zeros(3, device=dev), 10)
    with pytest.raises(ValueError):                 # beyond the widest index word
        ops.sparse_decode_sum_op(idx, torch.zeros((2, 3), device=dev),
                                 torch.zeros(3, device=dev), (1 << 32) + 1)


@pytest.mark.parametrize("n", [513, 1025])
@pytest.mark.parametrize("d,k", [(200, 200), (70001, 4099)])
def test_sparse_decode_beyond_one_group(dev, n, d, k):
    """More workers than the decode's passes take at once (512): the groups
    continue each other's sums in worker order, so sum and mean stay bitwise
    the plain versions; -0.0, +-inf and underflowing products included, and
    rows of wider buffers."""
    from repro_torch.kernels.sparse import GROUP

    assert n > GROUP
    idx, values, scale = _sparse_case(dev, n, d, k, seed=n + d)
    vbuf = torch.zeros((n, k + 3), device=dev)
    vbuf[:, :k] = values
    before = dict(build.LAUNCHES)
    for mean, op in ((False, ops.sparse_decode_sum_op), (True, ops.sparse_decode_sum_mean_op)):
        want = _decode_expected(idx, values, scale, d, mean)
        assert _same_bits(op(idx, values, scale, d), want)
        assert _same_bits(op(idx, vbuf[:, :k], scale, d), want)
    assert build.LAUNCHES["sparse_decode_sum"] == before.get("sparse_decode_sum", 0) + 2


def _widths(d):
    """Every wire width that holds indices below d + 8 (some tests add some)."""
    return [dt for dt, top in ((torch.uint8, 256), (torch.uint16, 65536), (torch.uint32, 1 << 32))
            if d + 8 <= top]


def _decode_expected(idx, values, scale, d, mean):
    """The plain version over each worker's entries below d, summed in order."""
    acc = None
    for r in range(idx.shape[0]):
        ir = idx[r].to(torch.int64)
        m = ir < d
        row = ref.ref_sparse_decode_sum(ir[m][None], values[r][m][None], scale[m], d)
        acc = row if acc is None else acc + row
    return div_n(acc, idx.shape[0]) if mean else acc


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("d_off", ["small", -1, 0, 1])
def test_sparse_decode_tile_edges(dev, n, d_off):
    """d < T, T - 1, T, T + 1 (T the decode's tile); every worker keeps every
    coordinate (full tiles, collisions everywhere), then a sparse row set
    with indices >= d that the decode drops; every width that holds the
    indices; rows of wider buffers."""
    from repro_torch.kernels.sparse import TILE

    d = 200 if d_off == "small" else TILE + d_off
    for k in (d, max(1, d // 7)):
        idx, values, scale = _sparse_case(dev, n, d, k, seed=n * 13 + d + k)
        if k < d:                                    # entries d .. d + 7: dropped
            idx = idx.to(torch.int64)
            idx[:, 5:5 + min(8, k - 5)] = d + torch.arange(min(8, k - 5), device=dev)
        for dt in _widths(d):
            ids = idx.to(torch.int64).to(dt)
            ibuf = torch.zeros((n, k + 3), dtype=dt, device=dev)
            ibuf[:, :k] = ids
            vbuf = torch.zeros((n, k + 5), device=dev)
            vbuf[:, :k] = values
            for mean, op in ((False, ops.sparse_decode_sum_op), (True, ops.sparse_decode_sum_mean_op)):
                want = _decode_expected(ids, values, scale, d, mean)
                assert _same_bits(op(ids, values, scale, d), want)
                assert _same_bits(op(ibuf[:, :k], vbuf[:, :k], scale, d), want)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_sparse_decode_across_coarse_bins(dev, n):
    """d just above 2 S (S the coarse bin): three bins, the last one partial
    (5 coordinates, one partial tile); entries in bins 0 and 2 only, so bin
    1 and its 32 tiles stay empty, with both ends of every bin, entries
    >= d and a dense stretch that every worker keeps whole."""
    from repro_torch.kernels.sparse import COARSE, TILE

    d = 2 * COARSE + 5
    rng = np.random.default_rng(n)
    dense = np.arange(COARSE - TILE // 2, COARSE)            # the end of bin 0, every worker
    pool = np.setdiff1d(np.concatenate([np.arange(COARSE), np.arange(2 * COARSE, d)]), dense)
    ends = np.array([0, 2 * COARSE, d - 1])                 # COARSE - 1 is in the dense stretch
    rows = [np.concatenate([dense, rng.choice(np.setdiff1d(pool, ends), 3000, replace=False),
                            ends, [d, d + 1]]) for _ in range(n)]
    idx = torch.from_numpy(np.stack([rng.permutation(r) for r in rows])).to(torch.uint32).to(dev)
    k = idx.shape[1]
    values = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
    values[:, :7] = torch.tensor([-0.0, float("inf"), 1e-40, -1e-45, 3.0, -2.0, 0.5], device=dev)
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, k).astype(np.float32)).to(dev)
    for mean, op in ((False, ops.sparse_decode_sum_op), (True, ops.sparse_decode_sum_mean_op)):
        got = op(idx, values, scale, d)
        assert _same_bits(got, _decode_expected(idx, values, scale, d, mean))
        assert bool((got[COARSE:2 * COARSE] == 0).all())


def test_sparse_decode_is_deterministic(dev):
    """The cursor atomics order a run's records differently from launch to
    launch; the result may not change."""
    from repro_torch.kernels.sparse import TILE

    d = 3 * TILE + 5
    idx, values, scale = _sparse_case(dev, 4, d, d // 2, seed=3)
    first = ops.sparse_decode_sum_op(idx, values, scale, d)
    for _ in range(3):
        assert _same_bits(ops.sparse_decode_sum_op(idx, values, scale, d), first)
    assert _same_bits(first, ref.ref_sparse_decode_sum(idx, values, scale, d))


@pytest.mark.parametrize("k", [1, 7, 9, 15, 1001])
@pytest.mark.parametrize("d", [200, 3001, 70001])
def test_sparse_gather_unaligned_rows(dev, d, k):
    """Index rows and output rows at every element offset of a 16-byte
    line (a gathered payload's rows start w * k elements apart), k not a
    multiple of 8, every width that holds the indices, and indices >= d,
    which the gather clamps to d - 1."""
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn(d, generator=g, device=dev)
    rng = np.random.default_rng(d + k)
    want_idx = torch.from_numpy(rng.integers(0, d + 8, k)).to(dev)
    want = x[want_idx.clamp(max=d - 1)]
    for dt in _widths(d):
        flat = torch.zeros(k + 16, dtype=dt, device=dev)
        for io in range(8):
            flat[io:io + k] = want_idx.to(dt)
            for oo in (0, 1, 3, 5):
                out = torch.full((k + 8,), 7.0, device=dev)
                ops.sparse_gather_op(x, flat[io:io + k], out=out[oo:oo + k])
                assert _same_bits(out[oo:oo + k], want)
                assert bool((out[:oo] == 7.0).all()) and bool((out[oo + k:] == 7.0).all())


# ------------------------------------------------ in-kernel-PRNG encodes

def _keys(n, seed):
    return prng.split(prng.fold_in(prng.PRNGKey(seed), 9), n)


_MANY_ROWS = (1700, 0, 1, 3000, 0, 299, 2)      # 5002 rows: more than the grid's warps


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0, 3.0])
@pytest.mark.parametrize("seg_rows,b", [((13,), 128), ((1, 1, 5, 1, 3, 2), 128),
                                        ((1,), 2048), ((3, 0, 40, 1), 2048),
                                        ((2, 0, 9, 1), 4096), (_MANY_ROWS, 128),
                                        (_MANY_ROWS, 2048), (_MANY_ROWS, 4096),
                                        ((3,), 8), ((14,), 8), ((2,), 16), ((1, 1), 64),
                                        ((4, 0, 3), 100), ((5, 2), 200), (_MANY_ROWS, 8)])
def test_quantize_pack_prng(dev, p, seg_rows, b):
    """Bitwise the bits kernel fed ``threefry_bits`` per segment (every p: the
    same reduction order), and the plain version (p = inf; else as
    ``quantize_pack``'s tolerance).  B = 2048 stages the pre-drawn rows in
    shared memory, 4096 does not; a few rows leave most of the grid's warps
    idle, 5002 rows make every warp walk several; empty segments and
    boundaries between rows; blocks below 128 (the convex harness's 8-64,
    lanes without a group) and blocks with a tail of groups (100, 200)."""
    m = sum(seg_rows)
    g = torch.Generator(device=dev).manual_seed(m + b)
    delta = torch.randn((m, b), generator=g, device=dev)
    delta[0, :7] = torch.tensor([-0.0, 0.0, 1e-40, -1e-45, 3.4028235e38, -3.4028235e38, 2.0])
    if m > 2:
        delta[1] = 0.0
        delta[2, 5] = float("inf")
    keys = _keys(len(seg_rows), m)
    before = dict(build.LAUNCHES)
    kp, ks = ops.quantize_pack_prng_op(delta, keys, seg_rows, p=p)
    assert build.LAUNCHES["quantize_pack_prng"] == before.get("quantize_pack_prng", 0) + 1
    bits = ops.segment_bits_op(keys, [r * b for r in seg_rows], dev).reshape(m, b)
    bp, bs = ops.quantize_pack_op(delta, bits, p=p)
    assert torch.equal(kp, bp) and torch.equal(ks, bs)
    pp, ps = ref.ref_quantize_pack_prng(delta, keys, seg_rows, p)
    if p == math.inf:
        assert torch.equal(kp, pp) and torch.equal(ks, ps)
    else:
        ulp = (ks.view(torch.int32).long() - ps.view(torch.int32).long()).abs().max()
        assert int(ulp) <= 4
        same = sum(int(((kp >> s) & 3).eq((pp >> s) & 3).sum()) for s in (0, 2, 4, 6))
        assert same >= 0.9999 * m * b


def _plain_words(key, lo_counter, count):
    """Words lo_counter .. lo_counter + count - 1 of ``bits(key, ...)``,
    from the plain cipher (64-bit counters), as int32."""
    j = torch.arange(lo_counter, lo_counter + count, dtype=torch.int64)
    k0, k1 = prng.key_words(key)
    x0, x1 = prng.threefry2x32(k0, k1, j >> 32, j & prng.MASK)
    return prng.to_int32(x0 ^ x1)


def test_quantize_pack_prng_past_2_32_words(dev):
    """A segment of 2^21 + 5 rows of B = 2048: its counters pass 2^32 at
    row 2^21 of the segment (the rows above draw with high word 1).  Bitwise
    the bits kernel fed ``threefry_bits``, and around the crossing the plain
    version fed the plain cipher's words."""
    b, seg_rows = 2048, (3, (1 << 21) + 5)
    m = sum(seg_rows)
    g = torch.Generator(device=dev).manual_seed(21)
    delta = torch.randn((m, b), generator=g, device=dev)
    keys = _keys(2, 32)
    kp, ks = ops.quantize_pack_prng_op(delta, keys, seg_rows, p=math.inf)
    bits = ops.segment_bits_op(keys, [r * b for r in seg_rows], dev).reshape(m, b)
    bp, bs = ops.quantize_pack_op(delta, bits, p=math.inf)
    assert torch.equal(kp, bp) and torch.equal(ks, bs)
    del bits, bp, bs
    r0 = seg_rows[0] + (1 << 21) - 2                 # 2 rows below the crossing, 2 above
    words = _plain_words(keys[1], (r0 - seg_rows[0]) * b, 4 * b).to(dev).reshape(4, b)
    pp, ps = ref.ref_quantize_pack(delta[r0:r0 + 4], words, math.inf)
    assert torch.equal(kp[r0:r0 + 4], pp) and torch.equal(ks[r0:r0 + 4], ps)
    del delta, kp, ks
    torch.cuda.empty_cache()


def test_nat_pack_prng_past_2_32_words(dev):
    """A segment of 2^32 + 2995 coordinates after one of 5: its counters
    pass 2^32 inside a warp's chunk (the 64-bit path) and the chunks above
    draw with high word 1.  Bitwise ``nat_pack`` fed ``threefry_bits``, and
    around the crossing the plain version fed the plain cipher's words."""
    sizes = [5, (1 << 32) + 2995]
    d = sum(sizes)
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(d, generator=g, device=dev)
    keys = _keys(2, 33)
    got = ops.nat_pack_prng_op(x, keys, sizes)
    bits = ops.segment_bits_op(keys, sizes, dev)
    assert torch.equal(got, ops.nat_pack_op(x, bits))
    del bits
    c = sizes[0] + (1 << 32)                         # coordinate of counter 2^32
    lo = c - 1500
    words = _plain_words(keys[1], lo - sizes[0], 3000).to(dev)
    assert torch.equal(got[lo:lo + 3000], ref.ref_nat_pack(x[lo:lo + 3000], words))
    del x, got
    torch.cuda.empty_cache()


def _split(d, seed):
    """Segment sizes summing to d: one-coordinate and empty segments, and odd
    sizes whose boundaries fall inside groups of 4."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < d:
        sizes.append(int(min(d - sum(sizes), rng.choice([0, 1, 1, 2, 3, 5, 7, 33, 1001]))))
    return sizes


@pytest.mark.parametrize("d", [1, 3, 7, 1001, 4097])
@pytest.mark.parametrize("one_key", [True, False])
def test_nat_pack_prng(dev, d, one_key):
    x, _ = _nat_inputs(dev, d, seed=d + 5)
    sizes = [d] if one_key else _split(d, d)
    keys = _keys(len(sizes), d)
    want = ref.ref_nat_pack_prng(x, keys, sizes)
    bits = ops.segment_bits_op(keys, sizes, dev)
    assert torch.equal(ops.nat_pack_op(x, bits), want)       # the bits kernel agrees
    before = build.LAUNCHES["nat_pack_prng"]
    assert torch.equal(ops.nat_pack_prng_op(x, keys, sizes), want)
    # x at 4-, 8- and 12-byte offsets (peeled heads of 3, 2 and 1 coordinates)
    xb = torch.empty(d + 3, device=dev)
    for off in (1, 2, 3):
        xb[off:off + d] = x
        assert torch.equal(ops.nat_pack_prng_op(xb[off:off + d], keys, sizes), want)
    # into the rows of a gathered buffer whose rows are only 2-byte aligned
    buf = torch.zeros((3, d + 1), dtype=torch.int16, device=dev)
    for w in range(3):
        assert ops.nat_pack_prng_op(x, keys, sizes, out=buf[w, :d]) is not None
        assert torch.equal(buf[w, :d], want) and int(buf[w, d]) == 0
    assert build.LAUNCHES["nat_pack_prng"] == before + 7


@pytest.mark.parametrize("layout", ["head", "chunk", "edges", "tail"])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_nat_pack_prng_boundaries(dev, layout, off):
    """d = 70,001 (136 chunks of 512 and a tail of 369 - head coordinates)
    with x at a 4 * off byte offset (a peeled head of 0, 3 or 1
    coordinates): segment boundaries inside the head (one-coordinate and
    empty segments), inside chunks and groups of 4, on chunk edges, and
    inside the tail; into contiguous codes and into rows of a buffer that
    are only 2-byte aligned."""
    d = 70001
    head = (4 - off) % 4
    sizes = {"head": [1, 0, 1, d - 2],
             "chunk": [head + 37, 0, 512 * 3 + 1, 2, 511, d - head - 37 - 1537 - 513],
             "edges": [head + 512, 512, 0, 1024, d - head - 2048],
             "tail": [d - 300, 3, 0, 296, 1]}[layout]
    assert sum(sizes) == d
    x, _ = _nat_inputs(dev, d, seed=off + 7)
    keys = _keys(len(sizes), d + off)
    want = ref.ref_nat_pack_prng(x, keys, sizes)
    assert torch.equal(ops.nat_pack_op(x, ops.segment_bits_op(keys, sizes, dev)), want)
    xb = torch.empty(d + 3, device=dev)
    xb[off:off + d] = x
    assert torch.equal(ops.nat_pack_prng_op(xb[off:off + d], keys, sizes), want)
    buf = torch.zeros((2, d + 1), dtype=torch.int16, device=dev)
    for w in range(2):
        ops.nat_pack_prng_op(xb[off:off + d], keys, sizes, out=buf[w, :d])
        assert torch.equal(buf[w, :d], want) and int(buf[w, d]) == 0


def test_prng_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(300, device=dev)
    keys = _keys(129, 0)
    with pytest.raises(ValueError):           # more segments than the key table holds
        ops.nat_pack_prng_op(x, keys, [1] * 128 + [172])
    with pytest.raises(ValueError):           # segments do not cover x
        ops.nat_pack_prng_op(x, keys[:2], [100, 100])
    with pytest.raises(ValueError):
        ops.quantize_pack_prng_op(torch.zeros((3, 128), device=dev), keys[:2], (1, 1),
                                  p=math.inf)
    with pytest.raises(ValueError):           # block not a multiple of 4
        ops.quantize_pack_prng_op(torch.zeros((3, 102), device=dev), keys[:1], (3,),
                                  p=math.inf)


# ------------------------------------------------------------ dense

def _same_bits_or_nan(a, b):
    """Equal bits, NaN payloads aside (a NaN is compared as a NaN)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _dense_rows(dev, n, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((n, d), generator=g, device=dev) * 10.0 ** (
        torch.rand((n, d), generator=g, device=dev) * 60 - 30)
    v[:, ::7] = -0.0                              # -0.0 in every worker: the sum keeps it
    sp = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e-40, -1e-45,
                       3.4028235e38, 0.0], device=dev)
    for i in range(n):
        j = torch.randperm(d, generator=g, device=dev)[:min(d, sp.numel())]
        v[i, j] = sp[:j.numel()]
    return v


@pytest.mark.parametrize("d", [1, 3, 1001, 4097])
def test_dense_copy(dev, d):
    x = _dense_rows(dev, 1, d, seed=d)[0]
    before = build.LAUNCHES["dense_copy"]
    assert torch.equal(ops.dense_copy_op(x).view(torch.int32), x.view(torch.int32))
    xb = torch.empty(d + 3, device=dev)
    ob = torch.full((d + 3,), 7.0, device=dev)
    for xo, oo in ((1, 1), (3, 3), (1, 0), (0, 2)):   # shared offsets peel; others scalar
        xb[xo:xo + d] = x
        ob.fill_(7.0)
        out = ops.dense_copy_op(xb[xo:xo + d], out=ob[oo:oo + d])
        assert torch.equal(out.view(torch.int32), x.view(torch.int32))
        assert bool((ob[:oo] == 7.0).all()) and bool((ob[oo + d:] == 7.0).all())
    assert build.LAUNCHES["dense_copy"] == before + 5


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("d", [1, 3, 1001, 4097])
@pytest.mark.parametrize("ld_pad", [0, 1, 4])
def test_dense_decode_family(dev, n, d, ld_pad):
    """Rows ``d + ld_pad`` floats apart (contiguous; 4-byte aligned for odd
    d; 16-byte aligned where d is a multiple of 4), and the same rows one
    float into the buffer (an unaligned start)."""
    vals = _dense_rows(dev, n, d, seed=n * 11 + d + ld_pad)
    buf = torch.zeros((n, d + ld_pad + 1), device=dev)
    before = dict(build.LAUNCHES)
    for start in (0, 1):
        view = buf[:, start:start + d]
        view.copy_(vals)
        s = ops.dense_decode_sum_op(view)
        want = ref.ref_dense_decode_sum(vals)
        assert _same_bits_or_nan(s, want)
        neg0 = ((vals == 0) & torch.signbit(vals)).all(0)     # -0.0 in every worker
        assert bool((torch.signbit(s[neg0]) & (s[neg0] == 0)).all())
        assert _same_bits_or_nan(ops.dense_decode_sum_mean_op(view),
                                 ref.ref_dense_decode_sum_mean(vals))
    assert build.LAUNCHES["dense_decode_sum"] == before.get("dense_decode_sum", 0) + 2
    assert build.LAUNCHES["dense_decode_sum_mean"] == before.get("dense_decode_sum_mean", 0) + 2


def test_dense_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        ops.dense_copy_op(torch.zeros(10, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        ops.dense_copy_op(torch.zeros(10, device=dev), out=torch.zeros(9, device=dev))
    with pytest.raises(ValueError):
        ops.dense_decode_sum_op(torch.zeros(10, device=dev))
    with pytest.raises(ValueError):
        ops.dense_decode_sum_mean_op(torch.zeros((2, 10), dtype=torch.int32, device=dev))


# --------------------------------------------------- the elastic round's pieces


def test_checksum_on_card_equals_cpu(dev):
    """The wire checksum reduced on the card (chunks of 2^24 bytes, int64
    sums) equals the CPU's words on wires over 2^24 bytes, with the
    positions shifted past 2^32 too; a corrupted byte is caught on the card."""
    from repro_torch.core.bucket import add_checksum, checksum_words, verify_checksum

    g = torch.Generator(device=dev).manual_seed(3)
    rows = torch.randint(0, 256, (2, (1 << 24) + 12345), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    assert checksum_words(rows) == checksum_words(rows.cpu())
    for pos0 in (2**32 - 5000, 2**33 + 7):
        assert checksum_words(rows[1], pos0=pos0) == checksum_words(rows[1].cpu(), pos0=pos0)
    wire = add_checksum(rows[:1])
    assert torch.equal(wire.cpu(), add_checksum(rows[:1].cpu()))
    wire[(1 << 24) + 3] ^= 0x40
    assert not bool(verify_checksum(wire)[1])


@pytest.mark.parametrize("method", ["diana", "natural", "randk", "topk_ef", "none"])
@pytest.mark.parametrize("bucketed", [True, False])
def test_masked_decode_sum_equals_plain(dev, method, bucketed):
    """Each operator's ``decode_sum`` over a gathered payload of 4 workers
    with workers 1 and 3 excluded (``mask_workers`` and its in-place form),
    through the kernels, bit for bit the plain versions on the same bytes;
    an excluded sparse row carries out-of-range indices, as a corrupted
    wire may."""
    from repro_torch.core.bucket import BucketLayout, bucketed_compressor
    from repro_torch.core.compression import CompressionConfig

    cfg = CompressionConfig(method=method, block_size=128, k=97, bucketed=bucketed)
    tree = {"a": torch.zeros(3001), "b": torch.zeros(70, 130)}
    if bucketed:
        comp = bucketed_compressor(cfg, BucketLayout.for_tree(tree, cfg.make().bucket_align()))
        d = comp.layout.padded_size
    else:
        comp, d = cfg.make(), 3001
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((4, d), generator=g, device=dev)
    x[:, ::5] = -0.0
    pays = [comp.compress(x[w], prng.fold_in(prng.PRNGKey(2), w)) for w in range(4)]
    stacked = type(pays[0]).stack(pays)
    if stacked.indices is not None:
        stacked.indices[1].copy_(torch.full_like(stacked.indices[1], d + 5)
                                 if stacked.indices.dtype != torch.uint8 else stacked.indices[1])
    mask = torch.tensor([True, False, True, False])
    plain = comp.decode_sum(type(stacked)(*(None if f is None else f.cpu() for f in stacked))
                            .mask_workers(mask), 4, d)
    got = comp.decode_sum(stacked.mask_workers(mask), 4, d)
    assert _same_bits_or_nan(got.cpu(), plain)
    got_ = comp.decode_sum(stacked.mask_workers_(mask), 4, d)
    assert _same_bits_or_nan(got_.cpu(), plain)


# The wire schedule's chunk views: whole-leaf chunks of a flat buffer, at
# offsets that are not 16-byte aligned for the unaligned operators (leaf
# sizes 384, 260, 160, 279, 70 and 1).
_CHUNK_SHAPES = {"emb": (24, 16), "w1": (20, 13), "b1": (160,), "w2": (9, 31), "b2": (70,),
                 "s": ()}
_CHUNK_OPS = [("diana", dict(block_size=16)), ("natural", {}), ("randk", dict(k=9)),
              ("topk_ef", dict(k=9)), ("none", {})]


@pytest.mark.parametrize("method,kw", _CHUNK_OPS, ids=[m for m, _ in _CHUNK_OPS])
def test_kernels_on_chunk_views(dev, method, kw):
    """Each chunk's encode reads a view of the flat buffer at the chunk's
    offset, and the server decodes (sum, and the fused apply into a view
    of ``h_server``) run per chunk: on the card bitwise the plain versions
    on the CPU, and every kernel of the operator launched."""
    from repro_torch.core.bucket import ChunkedSchedule, bucketed_compressor
    from repro_torch.core.compressors.base import Payload
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.diana import bucket_layout

    cfg = CompressionConfig(method=method, bucketed=True, chunk_bytes=300, **kw)
    g = torch.Generator().manual_seed(5)
    tree = {p: torch.randn(s, generator=g) for p, s in _CHUNK_SHAPES.items()}
    lay = bucket_layout(cfg, tree)
    sched = ChunkedSchedule.for_layout(lay, 300)
    assert sched.n_chunks >= 3
    if cfg.make().bucket_align() == 1:
        assert any((4 * o) % 16 for o in sched.chunk_offsets)
    n = 3
    flats = [lay.flatten({p: v * (w + 1) for p, v in tree.items()}) for w in range(n)]
    h = torch.randn(lay.padded_size, generator=g)
    before = dict(build.LAUNCHES)
    for c, cl in enumerate(sched.chunk_layouts):
        comp = bucketed_compressor(cfg, cl)
        keys = [sched.chunk_keys(prng.split(prng.fold_in(prng.PRNGKey(2), w), lay.n_leaves), c)
                for w in range(n)]
        out = {}
        for where in ("cpu", dev):
            views = [sched.split(f.to(where))[c] for f in flats]
            pays = [cfg.make().compress_bucketed_keys(cl, v, k) for v, k in zip(views, keys)]
            stacked = Payload.stack(pays)
            hs = sched.split(h.to(where))[c]
            own = comp.decode(pays[0], cl.padded_size)
            total = comp.decode_sum(stacked, n, cl.padded_size)
            ghat, new_h = comp.decode_sum_apply(stacked, n, cl.padded_size, hs)
            out[str(where)] = [f for f in stacked if f is not None] + [own, total, ghat, new_h]
        for a, b in zip(out["cpu"], out[str(dev)]):
            assert torch.equal(a, b.cpu()), (method, c)
    launched = {k for k, v in build.LAUNCHES.items() if v > before.get(k, 0)}
    want = {"diana": {"quantize_pack_prng", "unpack_reduce", "unpack_reduce_apply"},
            "natural": {"nat_pack_prng", "nat_decode_sum", "nat_decode_sum_apply"},
            "randk": {"threefry_bits", "sparse_gather", "sparse_decode_sum"},
            "topk_ef": {"sparse_gather", "sparse_decode_sum", "sparse_decode_sum_mean"},
            "none": {"dense_copy", "dense_decode_sum", "dense_decode_sum_mean"}}[method]
    assert want <= launched, (method, launched)


@pytest.mark.parametrize("method,kw", _CHUNK_OPS, ids=[m for m, _ in _CHUNK_OPS])
def test_chunked_reference_step_on_card_equals_cpu(dev, method, kw):
    """The chunked and the hierarchical ``reference_step`` through the
    kernels, bitwise the plain versions on the CPU (two steps, n = 4)."""
    from dataclasses import replace

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.diana import reference_init, reference_step

    g = torch.Generator().manual_seed(6)
    params = {p: torch.randn(s, generator=g) for p, s in _CHUNK_SHAPES.items()}
    grads = [{p: torch.randn((4, *s), generator=g) for p, s in _CHUNK_SHAPES.items()}
             for _ in range(2)]
    base = CompressionConfig(method=method, bucketed=True, chunk_bytes=300, **kw)
    for cfg in (base, replace(base, topology="hierarchical", node_size=2)):
        res = {}
        for where in ("cpu", dev):
            st = reference_init({p: v.to(where) for p, v in params.items()}, cfg, 4)
            for s in range(2):
                v, st = reference_step({p: x.to(where) for p, x in grads[s].items()}, st,
                                       prng.fold_in(prng.PRNGKey(3), s), cfg)
            res[str(where)] = (v, st)
        (vc, sc), (vg, sg) = res["cpu"], res[str(dev)]
        assert all(torch.equal(vc[p], vg[p].cpu()) for p in params), cfg.topology
        assert torch.equal(sc.h_worker, sg.h_worker.cpu())
        assert torch.equal(sc.h_server, sg.h_server.cpu())
