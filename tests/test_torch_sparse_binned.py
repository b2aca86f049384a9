"""The binned order of the card's sparse decode (``csrc/sparse.cu``: count,
scan, coarse bin, fine sort, tile), emulated in plain torch at small tiles,
against the plain versions ``ref_sparse_decode_sum`` / ``_mean`` and the
JAX package's decode, bit for bit; and the wrapper's scratch sizes.

The emulation follows the kernel's passes: per-coarse-bin counts and their
exclusive scan; coarse records appended to each bin's run in an arbitrary
order (the kernel's block reservations and shared-memory ranks; here a
seeded permutation); per coarse bin, fine runs by (tile, worker) in
tile-major worker-minor order, again in an arbitrary order inside a run
(the kernel's chunks of a bin reserve their pieces of a run with atomics);
then per tile an accumulator from +0.0 that takes the fine runs of workers
0..n-1 in order and is written once (divided by n for the mean).  More
workers than one launch group takes (512 on the card) go through the passes
a group at a time, each group's tile pass starting from the output the
earlier groups left, only the last one dividing for the mean
(:func:`grouped_decode`, at small groups).  The CUDA
kernel itself is held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.compressors.base import index_dtype
from repro_torch.core.numerics import div_n
from repro_torch.kernels import ref
from repro_torch.kernels.sparse import CHUNK, COARSE, TILE, decode_scratch


def _arbitrary_order(keys, rng):
    """Positions of a stable sort by key after a random shuffle: runs by key,
    any order inside a run."""
    perm = torch.from_numpy(rng.permutation(keys.numel()))
    return perm[torch.argsort(keys[perm], stable=True)]


def binned_decode(idx, values, scale, d, tile, coarse, mean=False, seed=0, start=None,
                  n_all=None):
    """Passes a-e of the card's decode in plain torch, at tiles of ``tile``
    and coarse bins of ``coarse`` floats (the card's are TILE and COARSE).
    Pass e starts from ``start`` (an earlier group's output) where given, and
    the mean divides by ``n_all`` (default: these rows' count)."""
    n, k = idx.shape
    n_all = n if n_all is None else n_all
    bins, tiles = -(-d // coarse), -(-d // tile)
    rng = np.random.default_rng(seed)
    i = idx.to(torch.int64)
    w = torch.arange(n)[:, None].expand(n, k)
    p = values * scale                       # pass c's product: one f32 rounding
    keep = i < d                             # entries at d or beyond are dropped
    i, w, p = i[keep], w[keep], p[keep]
    # a. count per coarse bin; b. exclusive scan
    cbin = i // coarse
    ccount = torch.zeros(bins, dtype=torch.int64).index_add_(0, cbin, torch.ones_like(cbin))
    cstart = torch.cumsum(ccount, 0) - ccount
    # c. coarse records, bin by bin
    order = _arbitrary_order(cbin, rng)
    cw, cloc, cp = w[order], i[order] % coarse, p[order]
    # d. per coarse bin, fine runs by (tile in bin, worker)
    fine, keys = coarse // tile, (coarse // tile) * n
    fine_start = torch.empty(tiles * n, dtype=torch.int64)
    fine_count = torch.empty(tiles * n, dtype=torch.int64)
    loc, prod = torch.empty_like(cloc), torch.empty_like(cp)
    for b in range(bins):
        a0, a1 = int(cstart[b]), int(cstart[b] + ccount[b])
        key = (cloc[a0:a1] // tile) * n + cw[a0:a1]
        kc = torch.zeros(keys, dtype=torch.int64).index_add_(0, key, torch.ones_like(key))
        g = b * keys + torch.arange(keys)
        valid = g < tiles * n
        fine_start[g[valid]] = (a0 + torch.cumsum(kc, 0) - kc)[valid]
        fine_count[g[valid]] = kc[valid]
        o2 = _arbitrary_order(key, rng)
        loc[a0:a1], prod[a0:a1] = cloc[a0:a1][o2] % tile, cp[a0:a1][o2]
    assert fine * bins >= tiles
    # e. tile
    out = torch.empty(d, dtype=torch.float32)
    for t in range(tiles):
        acc = torch.zeros(tile, dtype=torch.float32)
        if start is not None:
            part = start[t * tile:(t + 1) * tile]
            acc[:part.numel()] = part
        for wk in range(n):
            a = int(fine_start[t * n + wk])
            b = a + int(fine_count[t * n + wk])
            acc[loc[a:b]] = acc[loc[a:b]] + prod[a:b]
        seg = acc[:min(tile, d - t * tile)]
        out[t * tile:t * tile + seg.numel()] = div_n(seg, n_all) if mean else seg
    return out


def grouped_decode(idx, values, scale, d, tile, coarse, group, mean=False, seed=0):
    """The card's decode of more workers than a launch group: workers
    ``group`` at a time in order, each group's pass e continuing the last
    group's output, the last group alone dividing for the mean."""
    n = idx.shape[0]
    out = None
    for w0 in range(0, n, group):
        last = w0 + group >= n
        out = binned_decode(idx[w0:w0 + group], values[w0:w0 + group], scale, d, tile, coarse,
                            mean=mean and last, seed=seed + w0, start=out, n_all=n)
    return out


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _case(n, d, k, tile, seed, oob=0):
    """idx (n, k) unique per worker (collisions across workers), with both
    ends of every tile and of the buffer in worker 0's row when k allows, a
    band of empty tiles when d allows, and ``oob`` entries per worker at
    indices >= d (in the wire width's range); values with -0.0, +-inf, NaN,
    subnormals and products that underflow to -0.0."""
    rng = np.random.default_rng(seed)
    hi = min(np.iinfo(np.dtype(str(index_dtype(d)).split(".")[1])).max, d + 1000)
    pool = np.arange(d)
    if d >= 6 * tile and d - 2 * tile >= k:  # tiles 2 and 3 get no entries
        pool = pool[(pool < 2 * tile) | (pool >= 4 * tile)]
    edges = np.unique(np.clip(np.concatenate([np.arange(0, d, tile), np.arange(tile - 1, d, tile),
                                              [d - 1]]), 0, d - 1))
    edges = edges[np.isin(edges, pool)]
    idx = np.empty((n, k), np.int64)
    for r in range(n):
        row = rng.choice(pool, k - oob, replace=False)
        if r == 0 and k - oob >= edges.size:
            rest = rng.choice(np.setdiff1d(pool, edges), k - oob - edges.size, replace=False)
            row = np.concatenate([edges, rest])
        out_of_range = np.concatenate([[d], rng.choice(np.arange(d + 1, hi + 1),
                                                        max(oob - 1, 0), replace=False)])[:oob]
        idx[r] = rng.permutation(np.concatenate([row, out_of_range]))
    values = (rng.standard_normal((n, k)) * 10.0 ** rng.uniform(-20, 20, (n, k))).astype(np.float32)
    scale = np.full(k, np.float32(d / k), np.float32)
    values[:, 0] = -0.0
    if k >= 12:
        values[0, 1], values[n - 1, 2], values[n // 2, 4] = np.inf, -np.inf, np.nan
        scale[3] = 1e-30
        values[:, 3] = -1e-20                # -1e-50 underflows to -0.0
        values[:, 5:8] = np.float32(1e-40)   # subnormal products and sums
        scale[5:8] = 1.0
        values[:, 8] = -np.float32(1e-45)
        scale[8] = 1.0
    return (torch.from_numpy(idx).to(index_dtype(d)), torch.from_numpy(values),
            torch.from_numpy(scale))


def _expected(idx, values, scale, d, mean):
    """The plain version over each worker's entries below d, summed in order."""
    acc = None
    for r in range(idx.shape[0]):
        m = idx[r].to(torch.int64) < d
        row = ref.ref_sparse_decode_sum(idx[r][m][None], values[r][m][None], scale[m], d)
        acc = row if acc is None else acc + row
    return div_n(acc, idx.shape[0]) if mean else acc


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("d,k,tile,coarse", [
    (1, 1, 4, 4), (7, 7, 4, 8), (200, 150, 16, 64), (255, 100, 256, 256), (256, 256, 256, 1024),
    (257, 120, 256, 512), (3001, 1001, 64, 256), (4096, 4096, 512, 1024),
    (70001, 900, 4096, 16384)])
def test_binned_order_equals_plain(n, d, k, tile, coarse):
    idx, values, scale = _case(n, d, k, tile, seed=n * 1009 + d + k)
    for mean in (False, True):
        got = binned_decode(idx, values, scale, d, tile, coarse, mean=mean, seed=d)
        want = (ref.ref_sparse_decode_sum_mean if mean else ref.ref_sparse_decode_sum)(
            idx, values, scale, d)
        assert _same(got, want)
    s = binned_decode(idx, values, scale, d, tile, coarse)
    assert not bool(((s == 0) & torch.signbit(s)).any())        # no -0.0 in any sum


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("d,k,tile,coarse,oob", [
    (200, 60, 16, 32, 20), (40000, 700, 1024, 4096, 50), (4096, 300, 1024, 1024, 20),
    (70001, 500, 4096, 8192, 30)])
def test_binned_order_drops_indices_at_or_beyond_d(n, d, k, tile, coarse, oob):
    idx, values, scale = _case(n, d, k, tile, seed=n + d, oob=oob)
    assert bool((idx.to(torch.int64) >= d).any())
    for mean in (False, True):
        assert _same(binned_decode(idx, values, scale, d, tile, coarse, mean=mean, seed=n),
                     _expected(idx, values, scale, d, mean))


@pytest.mark.parametrize("n,group", [(2, 1), (5, 2), (7, 3), (9, 4), (13, 4), (4, 4)])
@pytest.mark.parametrize("d,k,tile,coarse", [(200, 150, 16, 64), (3001, 1001, 64, 256)])
def test_grouped_decode_equals_plain(n, group, d, k, tile, coarse):
    """Groups of workers continuing each other's sums: bitwise the plain
    versions (sum and mean), -0.0, +-inf, NaN and subnormals included."""
    idx, values, scale = _case(n, d, k, tile, seed=n * 7 + group + d)
    for mean in (False, True):
        got = grouped_decode(idx, values, scale, d, tile, coarse, group, mean=mean, seed=n)
        want = (ref.ref_sparse_decode_sum_mean if mean else ref.ref_sparse_decode_sum)(
            idx, values, scale, d)
        assert _same(got, want)


def test_binned_order_run_order_does_not_matter():
    idx, values, scale = _case(4, 3001, 2000, 64, seed=5)
    first = binned_decode(idx, values, scale, 3001, 64, 256, seed=0)
    for seed in (1, 2):
        assert _same(binned_decode(idx, values, scale, 3001, 64, 256, seed=seed), first)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_binned_order_equals_jax_decode(n):
    """Against the JAX package's plain decode on subnormal-free inputs (its
    CPU build flushes subnormals; test_torch_sparse.py)."""
    d, k, tile = 5000, 1200, 256
    idx, values, scale = _case(n, d, k, tile, seed=11 * n)
    values[:, 4:9] = 1.0                     # no subnormal, no NaN
    ji, jv, js = (jnp.asarray(t.numpy()) for t in (idx, values, scale))
    want = np.asarray(jref.ref_sparse_decode_sum(ji, jv, js, d))
    got = binned_decode(idx, values, scale, d, tile, 1024).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,k,d,want", [
    # uint8 indices (d <= 256): one tile, one bin
    (1, 5, 200, {"bins": 1, "tiles": 1, "runs": 1, "records": 5}),
    (4, 256, 256, {"bins": 1, "tiles": 1, "runs": 4, "records": 1024}),
    # uint16 indices (d <= 65536): 4 tiles, the last partial or full
    (3, 1001, 65535, {"bins": 1, "tiles": 4, "runs": 12, "records": 3003}),
    (4, 65536, 65536, {"bins": 1, "tiles": 4, "runs": 16, "records": 262144}),
    # uint32 indices: d = T + 1, S + 1, 2 S + 5, 2^32 and the 8-layer
    # llama3.2-1b bucket at K = 9,472,000
    (2, 7, TILE + 1, {"bins": 1, "tiles": 2, "runs": 4, "records": 14}),
    (1, 3, COARSE + 1, {"bins": 2, "tiles": 33, "runs": 33, "records": 3}),
    (3, 0, 2 * COARSE + 5, {"bins": 3, "tiles": 65, "runs": 195, "records": 0, "chunks": 3}),
    (4, 1, 1 << 32, {"bins": 8192, "tiles": 262_144, "runs": 1_048_576, "records": 4}),
    (1, 9_472_000, 1_023_444_992, {"bins": 1953, "tiles": 62_467, "runs": 62_467,
                                   "records": 9_472_000, "chunks": 2313 + 1953}),
    (4, 9_472_000, 1_023_444_992, {"bins": 1953, "tiles": 62_467, "runs": 249_868,
                                   "records": 37_888_000, "chunks": 9250 + 1953}),
])
def test_decode_scratch_sizes(n, k, d, want):
    size = decode_scratch(n, k, d)
    assert {key: size[key] for key in want} == want
    assert (size["tiles"] - 1) * TILE < d <= size["tiles"] * TILE
    assert (size["bins"] - 1) * COARSE < d <= size["bins"] * COARSE
    assert size["bins"] * (COARSE // TILE) >= size["tiles"]     # pass d covers every tile
    # enough chunks for any spread of the records over the bins: a bin of c
    # records takes ceil(c / CHUNK) <= c / CHUNK + 1 of them
    assert size["chunks"] * CHUNK >= size["records"] + (size["bins"] - 1) * CHUNK

