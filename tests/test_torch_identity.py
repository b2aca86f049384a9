"""The identity operator (``--compression none``, the uncompressed f32
baseline) in the port against the JAX package's, on the same numpy-seeded
inputs, with both of the JAX package's routes: ``IdentityCompressor()`` (its
plain composition) and ``IdentityCompressor(use_kernel=True)`` (its Pallas
dense kernels, in interpret mode).

What is bitwise and what is not, and why:

* Payloads, worker sums and the round's state are bitwise for every n, the
  server mean for n a power of two, -0.0 in every worker included (the sums
  start from worker 0's row).
* At n = 3 the jitted JAX round divides the worker sum as ``s * f32(1/3)``
  (XLA's simplifier, on both routes), where the port takes the IEEE
  ``s / 3`` as its CUDA kernel does: ghat agrees within 1 ulp, and with the
  port's division swapped for XLA's product it is bitwise, so the division
  is the whole difference (ROADMAP.md queue 3).
* Inputs carry no subnormals: XLA's CPU build flushes them in arithmetic.
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
from repro.core.compression import payload_bits_per_dim as j_bits
from repro.core.compressors.base import Payload as JPayload
from repro.core.compressors.identity import IdentityCompressor as JIdentity
from repro.core.diana import bucket_layout as j_layout
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro.kernels import ref as jref
from repro.kernels.dense import (dense_copy as j_dense_copy,
                                 dense_decode_sum as j_dense_decode_sum,
                                 dense_decode_sum_mean as j_dense_decode_sum_mean)
from repro_torch.core import prng
from repro_torch.core.bucket import bucketed_compressor
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.compression import payload_bits_per_dim as t_bits
from repro_torch.core.compressors import IdentityCompressor, Payload, available_methods
from repro_torch.core.diana import (bucket_layout as t_layout, reference_init as t_init,
                                    reference_step as t_step, worker_key)
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


def _rows(n, d, seed):
    """(n, d) f32 over 40 decades, -0.0 at the same coordinates in every
    worker (the sum must keep it), +-inf, FLT_MAX; no subnormals."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, d)) * 10.0 ** rng.uniform(-20, 20, (n, d))).astype(np.float32)
    v[:, ::5] = -0.0
    if d > 10:
        v[0, 1], v[n - 1, 2] = np.inf, -np.inf
        v[:, 3] = np.finfo(np.float32).max
    return v


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [1, 7, 3001])
def test_plain_dense_versions_match_jax_ref_and_pallas(n, d):
    v = _rows(n, d, seed=n * 13 + d)
    s = ref.ref_dense_decode_sum(_t(v)).numpy()
    assert _same(s, jref.ref_dense_decode_sum(jnp.asarray(v)))
    assert _same(s, j_dense_decode_sum(jnp.asarray(v), interpret=True))
    assert _same(ops.dense_decode_sum_op(_t(v)).numpy(), s)
    assert np.all(np.signbit(s[::5]) & (s[::5] == 0))          # -0.0 survives the sum
    m = ref.ref_dense_decode_sum_mean(_t(v)).numpy()
    assert _same(ops.dense_decode_sum_mean_op(_t(v)).numpy(), m)
    assert _same(m, s / np.float32(n))                          # IEEE division
    jm = np.asarray(j_dense_decode_sum_mean(jnp.asarray(v), interpret=True))
    if n & (n - 1) == 0:
        assert _same(m, jm)
    else:
        # The jitted Pallas kernel divides as s * f32(1/n) (XLA's rewrite).
        assert _same(jm, s * np.float32(1.0 / n))
        fin = np.isfinite(m)
        assert np.all(np.abs(_bits(m[fin]).astype(np.int64) - _bits(jm[fin])) <= 1)
    x = v[0]
    c = ref.ref_dense_copy(_t(x)).numpy()
    assert _same(c, j_dense_copy(jnp.asarray(x), interpret=True)) and _same(c, x)
    out = torch.full((d,), 7.0)
    assert ops.dense_copy_op(_t(x), out=out) is out and _same(out.numpy(), x)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_hooks_match_jax(n, use_kernel):
    """compress, decode, decode_sum and decode_sum_apply, per leaf and over
    the bucket, against both JAX routes (jitted, as the JAX round runs)."""
    d = 3001
    v = _rows(n, d, seed=n)
    h = np.random.default_rng(n).standard_normal(d).astype(np.float32)
    tc, jc = IdentityCompressor(), JIdentity(use_kernel=use_kernel)
    key = prng.PRNGKey(0)
    tp = [tc.compress(_t(v[w]), key) for w in range(n)]
    for w in range(n):
        jp = jax.jit(lambda x: jc.compress(x, jax.random.PRNGKey(0)))(jnp.asarray(v[w]))
        assert _same(tp[w].values.numpy(), jp.values)
        assert _same(tc.decode(tp[w], d).numpy(), jax.jit(lambda p: jc.decode(p, d))(jp))
    tg, jg = Payload.stack(tp), JPayload(values=jnp.asarray(v))
    assert _same(tc.decode_sum(tg, n, d).numpy(), jax.jit(lambda g: jc.decode_sum(g, n, d))(jg))
    hs = _t(h)
    ghat, new_h = tc.decode_sum_apply(tg, n, d, hs)
    jghat, jnew_h = jax.jit(lambda g, hh: jc.decode_sum_apply(g, n, d, hh))(jg, jnp.asarray(h))
    assert new_h is hs and _same(jnew_h, h)                     # memoryless
    assert _same(ghat.numpy(), jghat)

    tree = {"a": torch.zeros(1000), "b": torch.zeros(3, 667)}
    tl = t_layout(TCfg(method="identity", bucketed=True), tree)
    jl = j_layout(JCfg(method="identity", bucketed=True),
                  {p: jnp.zeros(x.shape) for p, x in tree.items()})
    assert tl.align == 1 and (tl.sizes, tl.offsets) == (jl.sizes, jl.offsets)
    tbc = bucketed_compressor(TCfg(method="identity", bucketed=True), tl)
    jbc = JBucketed(jc, jl)
    gathered = tbc.gathered(n, "cpu")
    assert gathered.values.shape == (n, d) and gathered.values.stride(0) % 4 == 0
    for w in range(n):
        assert tbc.compress(_t(v[w]), worker_key(key, w), out=gathered.select(w)) is not None
        jp = jbc.compress(jnp.asarray(v[w]), jax.random.fold_in(jax.random.PRNGKey(0), w))
        assert _same(gathered.values[w].numpy(), jp.values)
        assert _same(tbc.decode(gathered.select(w)).numpy(), jax.jit(jbc.decode)(jp))
    assert _same(tbc.decode_sum(gathered, n).numpy(),
                 jax.jit(lambda g: jbc.decode_sum(g, n))(jg))
    ghat, new_h = tbc.decode_sum_apply(gathered, n, d, hs)
    jghat, _ = jax.jit(lambda g, hh: jbc.decode_sum_apply(g, n, d, hh))(jg, jnp.asarray(h))
    assert new_h is hs and _same(ghat.numpy(), jghat)


def test_none_alias_registry_and_accounting():
    assert {"identity", "none"} <= set(available_methods())
    for method in ("identity", "none"):
        c = TCfg(method=method).make()
        assert isinstance(c, IdentityCompressor) and c.name == "identity"
        assert t_bits(TCfg(method=method)) == j_bits(JCfg(method=method)) == 32.0
    j = JIdentity()
    assert (c.carries_state, c.unbiased, c.prefers_allreduce, c.bucket_align()) == \
        (j.carries_state, j.unbiased, j.prefers_allreduce, 1) == (False, True, True, 1)
    assert c.memory_alpha() == j.memory_alpha() == 0.0


# ----------------------------------------------------------- the DIANA round

def _grads(rng, n):
    def draw(shape):
        g = (rng.standard_normal((n, *shape)) * rng.random()).astype(np.float32)
        g.reshape(n, -1)[:, ::9] = -0.0
        return g
    return {"a": draw((3000,)), "blk": {"w": draw((40, 70)), "scale": draw((70,))},
            "emb": draw((5, 130))}


def _flat(tree, layout):
    if isinstance(tree, dict):
        tree = {p: np.asarray(v) for p, v in flatten_nested(tree).items()}
        return np.concatenate([tree[p].reshape(-1) for p in layout.paths])
    return np.asarray(tree)


def _hw(h, layout):
    if isinstance(h, dict):
        h = {p: np.asarray(v) for p, v in flatten_nested(h).items()}
        return np.concatenate([h[p].reshape(h[p].shape[0], -1) for p in layout.paths], axis=1)
    return np.asarray(h)


def _run(bucketed, n, use_kernel, steps=2):
    """``steps`` jitted JAX and port reference steps from the same grads;
    per step both sides' ghat / h_worker / h_server in the flat layout."""
    rng = np.random.default_rng(5 + n)
    grads = [_grads(rng, n) for _ in range(steps)]
    shapes = {p: g.shape[1:] for p, g in flatten_nested(grads[0]).items()}
    tl = t_layout(TCfg(method="none", bucketed=True),
                  {p: torch.zeros(s) for p, s in shapes.items()})
    tcfg = TCfg(method="none", bucketed=bucketed)
    ts = t_init({p: torch.zeros(s) for p, s in shapes.items()}, tcfg, n)
    jcfg = JCfg(method="none", bucketed=bucketed, use_kernel=use_kernel)
    js = j_init(jax.tree_util.tree_map(lambda g: jnp.zeros(g.shape[1:]), grads[0]), jcfg, n)
    jstep = jax.jit(lambda g, s, kk: j_step(g, s, kk, jcfg))
    out = []
    for s in range(steps):
        jv, js = jstep(jax.tree_util.tree_map(jnp.asarray, grads[s]), js,
                       jax.random.fold_in(jax.random.PRNGKey(0), s))
        tv, ts = t_step({p: _t(g) for p, g in flatten_nested(grads[s]).items()}, ts,
                        prng.fold_in(prng.PRNGKey(0), s), tcfg)
        out.append({"jghat": _flat(flatten_nested(jax.tree_util.tree_map(np.asarray, jv)), tl),
                    "jhw": _hw(js.h_worker, tl), "jhs": _flat(js.h_server, tl),
                    "tghat": _flat({p: v.numpy() for p, v in tv.items()}, tl),
                    "thw": _hw(ts.h_worker, tl), "ths": _flat(ts.h_server, tl)})
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_reference_step_matches_jitted_jax(bucketed, n, use_kernel):
    for r in _run(bucketed, n, use_kernel):
        for side in ("ghat", "hw", "hs"):
            assert _same(r["t" + side], r["j" + side]), side
        assert not np.any(r["thw"]) and not np.any(r["ths"])     # memoryless: zeros


@pytest.mark.parametrize("bucketed", [True, False])
def test_reference_step_n3_division(bucketed, monkeypatch):
    """n = 3: ghat within 1 ulp of the jitted reference's ``s * f32(1/3)``;
    with the port's division swapped for XLA's product, bitwise."""
    for use_kernel in (False, True):
        for r in _run(bucketed, 3, use_kernel):
            assert _same(r["thw"], r["jhw"]) and _same(r["ths"], r["jhs"])
            fin = np.isfinite(r["jghat"])
            assert np.array_equal(fin, np.isfinite(r["tghat"]))
            ulp = np.abs(_bits(r["tghat"][fin]).astype(np.int64) - _bits(r["jghat"][fin]))
            assert np.all(ulp <= 1)

    def xla_div(s, n):
        return s * torch.tensor(np.float32(1.0 / n), dtype=s.dtype, device=s.device)

    monkeypatch.setattr(ref, "div_n", xla_div)
    for use_kernel in (False, True):
        for r in _run(bucketed, 3, use_kernel):
            assert _same(r["tghat"], r["jghat"])


def test_port_bucketed_equals_perleaf_bitwise():
    for n in (3, 4):
        b = _run(True, n, False, steps=1)
        p = _run(False, n, False, steps=1)
        for rb, rp in zip(b, p):
            for key in ("tghat", "thw", "ths"):
                assert _same(rb[key], rp[key]), (n, key)


def test_trainer_cli_runs_none_on_cpu():
    # One torch thread: the test suite runs several workers on the CPU.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
         "--reduced", "--device", "cpu", "--mesh", "2x1", "--steps", "2",
         "--batch", "4", "--seq", "32", "--compression", "none"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
