"""The port's threefry PRNG against ``jax.random`` (bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import diana as jdiana
from repro.core.compressors.ternary import TernaryCompressor as JTernary
from repro_torch.core import diana as tdiana
from repro_torch.core import prng
from repro_torch.kernels import ops


def _words(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_prngkey(seed):
    assert np.array_equal(_words(jax.random.PRNGKey(seed)), prng.PRNGKey(seed).numpy())


@pytest.mark.parametrize("data", [0, 1, 7, 0x444E, 0x4750, 0x434B, 2**31 + 5, 2**32 - 1])
def test_fold_in(data):
    jk = jax.random.fold_in(jax.random.PRNGKey(3), data)
    tk = prng.fold_in(prng.PRNGKey(3), data)
    assert np.array_equal(_words(jk), tk.numpy())


@pytest.mark.parametrize("num", [1, 2, 5, 12])
def test_split(num):
    jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 9), num)
    tk = prng.split(prng.fold_in(prng.PRNGKey(0), 9), num)
    assert np.array_equal(_words(jk), tk.numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (37, 128), (3, 2048), (2, 3, 5)])
def test_bits(shape):
    jk = jax.random.split(jax.random.PRNGKey(11), 3)[2]
    tk = prng.split(prng.PRNGKey(11), 3)[2]
    jb = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32))
    tb = prng.bits(tk, shape)
    assert tb.shape == jb.shape
    assert np.array_equal(tb.numpy().view(np.uint32), jb)


def test_bits_drawn_in_chunks_of_counters(monkeypatch):
    """A draw in several passes of counters (``BITS_CHUNK``, 7 here, not
    dividing the count) is ``jax.random.bits``'s."""
    monkeypatch.setattr(prng, "BITS_CHUNK", 7)
    jk = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    tk = prng.fold_in(prng.PRNGKey(5), 2)
    jb = np.asarray(jax.random.bits(jk, (37, 3), dtype=jnp.uint32))
    assert np.array_equal(prng.bits(tk, (37, 3)).numpy().view(np.uint32), jb)


def test_batched_bits_matches_vmapped_draw():
    """Segments sharing a row count are drawn by ONE vmapped jax.random.bits
    call in the JAX package; the port draws per key into the concatenation
    (``segment_bits_op``: the bits the in-kernel-PRNG ternary encode draws,
    segment ``i`` over ``m_i * B`` coordinates)."""
    seg_rows = [2, 3, 2, 1, 3, 2]
    jkeys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 2), len(seg_rows))
    tkeys = prng.split(prng.fold_in(prng.PRNGKey(0), 2), len(seg_rows))
    jb = np.concatenate([np.asarray(b) for b in
                         JTernary(block_size=128, use_kernel=False)._batched_bits(jkeys, seg_rows)])
    tb = ops.segment_bits_op(tkeys, [r * 128 for r in seg_rows], "cpu").reshape(-1, 128)
    assert np.array_equal(tb.numpy().view(np.uint32), jb)


def test_fold_constants():
    for name in ("DOWN_FOLD", "GROUP_FOLD", "CHUNK_FOLD"):
        assert getattr(tdiana, name) == getattr(jdiana, name)
