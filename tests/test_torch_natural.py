"""Natural compression in the port against the JAX package, on the same
numpy-seeded inputs.

What is bitwise and what is not, and why:

* Codes are bitwise the JAX package's on every finite input.  The JAX
  package's CPU build treats a subnormal input as zero (``x == 0.0`` holds
  for it and ``frexp`` misreads it), so its code for a subnormal is 0; the
  port codes a subnormal as 0 explicitly.
* A decoded value is the exact power of two in the port.  The JAX package
  decodes with ``exp2(|code| - 160)``, which XLA's CPU build computes with a
  polynomial that misses the exact power of two at most integer arguments
  (relative error at most 4.05e-6, at k = 104) and reads 0 for k <= -126.
  So decoded values, sums, memories and ``ghat`` are held to the JAX
  package's within a relative ``EXP2_RTOL = 4.1e-6`` of the magnitudes that
  were summed (a sum of powers of two of mixed signs cancels, so the error
  is relative to the sum of the terms' magnitudes, not to the result), plus
  one f32 rounding per addition, where the two sides may round differently.
* Inside the port everything is bitwise: the bucketed layout against the
  per-leaf one, the fused hooks against the base class's composition, and a
  state converted from the JAX package stepping on as the port's own.
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
from repro.core.compressors.base import Payload as JPayload
from repro.core.compressors.natural import NaturalCompressor as JNatural
from repro.core.diana import bucket_layout as j_layout
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro.kernels import ref as jref
from repro.kernels.nat_pack import (nat_decode_sum as j_nat_decode_sum,
                                    nat_decode_sum_apply as j_nat_decode_sum_apply,
                                    nat_decode_sum_mean as j_nat_decode_sum_mean,
                                    nat_pack as j_nat_pack)
from repro_torch.core import prng
from repro_torch.core.bucket import bucketed_compressor
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.compressors import NaturalCompressor, Payload
from repro_torch.core.compressors.base import Compressor
from repro_torch.core.diana import (bucket_layout as t_layout, reference_init as t_init,
                                    reference_step as t_step, worker_key)
from repro_torch.core.tree import flatten_nested
from repro_torch.kernels import ops, ref

EXP2_RTOL = 4.1e-6  # XLA CPU exp2 at integer arguments: worst 4.05e-6 (k = 104)
F32_EPS = 2.0 ** -23
ALPHA = 1.0 / (1.0 + 1.0 / 8.0)
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _special_values():
    """Zeros, +-2^k, the float just below each 2^k, subnormals, FLT_MIN and
    FLT_MAX."""
    f32 = np.float32
    pows = np.ldexp(f32(1.0), np.arange(-126, 128)).astype(f32)
    below = np.nextafter(pows, f32(0.0))
    tiny = np.array([1e-45, 3e-39, 1.1754942e-38, np.finfo(f32).smallest_subnormal], f32)
    big = np.array([np.finfo(f32).max, np.finfo(f32).tiny, 0.0, -0.0], f32)
    v = np.concatenate([pows, below, tiny, big])
    return np.concatenate([v, -v])


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(d) * 10.0 ** rng.uniform(-30, 30, d)).astype(np.float32)
    sp = _special_values()
    pos = rng.choice(d, size=min(d, sp.size), replace=False)
    x[pos] = sp[:pos.size]
    bits = rng.integers(0, 2**32, size=d, dtype=np.uint32)
    return x, bits


@pytest.mark.parametrize("d", [1, 3, 1031, 4097])
def test_nat_pack_matches_jax_bitwise(d):
    x, bits = _inputs(d, seed=d)
    want = np.asarray(jref.ref_nat_pack(jnp.asarray(x), jnp.asarray(bits)))
    assert np.array_equal(np.asarray(j_nat_pack(jnp.asarray(x), jnp.asarray(bits),
                                                interpret=True)), want)
    got = ops.nat_pack_op(_t(x), _t(bits.view(np.int32)))
    assert got.dtype == torch.int16 and got.shape == (d,)
    assert np.array_equal(got.numpy(), want)
    out = torch.full((d,), 7, dtype=torch.int16)
    assert ops.nat_pack_op(_t(x), _t(bits.view(np.int32)), out=out) is out
    assert np.array_equal(out.numpy(), want)


def test_nat_pack_special_values_all_present():
    """Every special value at once, against both JAX formulations."""
    x = _special_values()
    bits = np.random.default_rng(0).integers(0, 2**32, size=x.size, dtype=np.uint32)
    want = np.asarray(jref.ref_nat_pack(jnp.asarray(x), jnp.asarray(bits)))
    got = ref.ref_nat_pack(_t(x), _t(bits.view(np.int32))).numpy()
    assert np.array_equal(got, want)
    sub = (np.abs(x) < np.finfo(np.float32).tiny)
    assert np.all(got[sub] == 0)                      # subnormals and zeros code to 0
    assert np.all(np.abs(got[x == np.finfo(np.float32).max]) >= 287)


def _exact(codes):
    k = np.abs(codes.astype(np.int64)) - 160
    with np.errstate(over="ignore"):
        mag = np.ldexp(np.float32(1.0), k).astype(np.float32)
    return np.where(codes < 0, -mag, mag).astype(np.float32)


def test_nat_decode_exact_and_within_exp2_tolerance_of_jax():
    codes = np.concatenate([np.arange(-288, 0), np.arange(0, 289)]).astype(np.int16)
    got = ref.ref_nat_decode(_t(codes)).numpy()
    want = _exact(codes)                       # np.ldexp, with the code's sign on zeros
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    jdec = np.asarray(jax.jit(lambda c: JNatural(use_kernel=False).decode(
        JPayload(packed=c), c.shape[0]))(jnp.asarray(codes)))
    k = np.abs(codes.astype(np.int64)) - 160
    normal = (k >= -125) & (k <= 127) & (codes != 0)
    np.testing.assert_allclose(got[normal], jdec[normal], rtol=EXP2_RTOL, atol=0)
    assert np.all(jdec[(k <= -126) & (codes != 0)] == 0)  # XLA reads 2^-126 and below as 0
    assert np.array_equal(np.isinf(got), np.isinf(jdec))  # k = 128: inf on both


def _codes_batch(n, d, seed):
    """Random codes over the whole range, with columns where every worker's
    code is a small negative one (each decodes to -0.0) and zero codes."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-288, 289, size=(n, d)).astype(np.int16)
    codes[:, ::7] = rng.integers(-10, 0, size=(n, codes[:, ::7].shape[1]))
    codes[rng.random((n, d)) < 0.05] = 0
    return codes


def _sum_tol(codes, extra=0.0, scale=1.0):
    """|port - JAX| bound: the exp2 error on every term plus one rounding per
    addition, relative to the summed magnitudes."""
    a = np.sum(np.abs(_exact(codes).astype(np.float64)), axis=0) * scale + extra
    return (EXP2_RTOL + (codes.shape[0] + 1) * F32_EPS) * a


@pytest.mark.parametrize("n", [1, 3, 4])
def test_nat_decode_sum_family_matches_pallas(n):
    d = 2053
    codes = _codes_batch(n, d, seed=n)
    # Codes with k in [-120, 100]: JAX's exp2 decodes them to normal floats,
    # and every sum, mean and update of them stays normal and finite (the JAX
    # package's CPU build also flushes subnormal results to zero; the
    # subnormal decode is held to np.ldexp above).  Codes below 11 stay: they
    # are the -0.0 case.
    codes = np.where((np.abs(codes) >= 40) & (np.abs(codes) <= 260), codes,
                     np.where(np.abs(codes) <= 10, codes, 0)).astype(np.int16)
    jc = jnp.asarray(codes)
    exact = _exact(codes).astype(np.float64)
    small = np.all((codes < 0) & (codes >= -10), axis=0)  # every worker decodes to -0.0

    js = np.asarray(j_nat_decode_sum(jc, interpret=True))
    ts = ops.nat_decode_sum_op(_t(codes)).numpy()
    assert np.array_equal(ts, ref.ref_nat_decode_sum(_t(codes)).numpy())
    assert np.all(np.abs(ts - js) <= _sum_tol(codes))
    assert np.all(np.signbit(ts[small])) and np.array_equal(ts[small].view(np.int32),
                                                             js[small].view(np.int32))

    jm = np.asarray(j_nat_decode_sum_mean(jc, interpret=True))
    tm = ops.nat_decode_sum_mean_op(_t(codes)).numpy()
    assert np.all(np.abs(tm - jm) <= _sum_tol(codes, scale=1.0 / n))
    assert np.array_equal(tm[small].view(np.int32), jm[small].view(np.int32))

    h = (np.random.default_rng(9).standard_normal(d)
         * np.maximum(np.abs(exact).max(axis=0), 2.0 ** -100)).astype(np.float32)
    jg, jh = jax.jit(lambda c, hh: j_nat_decode_sum_apply(c, hh, alpha=ALPHA,
                                                          interpret=True))(jc, jnp.asarray(h))
    tg, th = ops.nat_decode_sum_apply_op(_t(codes), _t(h), alpha=ALPHA)
    hmag = np.abs(h).astype(np.float64)
    assert np.all(np.abs(tg.numpy() - np.asarray(jg)) <= _sum_tol(codes, hmag, 1.0 / n))
    assert np.all(np.abs(th.numpy() - np.asarray(jh)) <= _sum_tol(codes, hmag, ALPHA / n))


def test_fused_hooks_equal_base_composition():
    """Natural's one-kernel decode_sum / decode_sum_apply equal the base
    class's sequential recurrence and literal composition, bitwise; a
    -0.0 from worker 0 survives."""
    n, d = 4, 999
    codes = _t(_codes_batch(n, d, seed=5))
    h = _t(np.random.default_rng(6).standard_normal(d).astype(np.float32))
    comp = NaturalCompressor()
    gathered = Payload(packed=codes)
    base_sum = Compressor.decode_sum(comp, gathered, n, d)
    assert torch.equal(comp.decode_sum(gathered, n, d).view(torch.int32),
                       base_sum.view(torch.int32))
    for memory in (True, False):
        c = NaturalCompressor(memory=memory)
        got = c.decode_sum_apply(gathered, n, d, h)
        want = Compressor.decode_sum_apply(c, gathered, n, d, h)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))
    assert comp.bits_per_dim() == 9.0 and comp.memory_alpha() == ALPHA


def test_payload_stack_select_skip_none():
    a = Payload(packed=torch.arange(5, dtype=torch.int16))
    b = Payload(packed=torch.arange(5, 10, dtype=torch.int16))
    s = Payload.stack([a, b])
    assert s.scales is None and s.indices is None and s.values is None
    assert s.packed.shape == (2, 5) and torch.equal(s.select(1).packed, b.packed)


def test_registry_config_and_layout_match_jax():
    from repro.core.compression import payload_bits_per_dim as j_bits
    from repro_torch.core.compression import payload_bits_per_dim as t_bits

    assert t_bits(TCfg(method="natural")) == j_bits(JCfg(method="natural")) == 9.0
    assert TCfg(method="natural").make().memory_alpha() == \
        JCfg(method="natural").make().memory_alpha()
    tree = {p: torch.zeros(g.shape[1:]) for p, g in flatten_nested(_grads(
        np.random.default_rng(0), 1)).items()}
    tl = t_layout(TCfg(method="natural", bucketed=True), tree)
    jl = j_layout(JCfg(method="natural", bucketed=True),
                  {p: jnp.zeros(v.shape) for p, v in tree.items()})
    assert tl.align == 1 and tl.padded_size == tl.size == jl.padded_size
    assert (tl.sizes, tl.offsets) == (jl.sizes, jl.offsets)
    assert bucketed_compressor(TCfg(method="natural", bucketed=True), tl).bits_per_dim() == \
        JBucketed(JNatural(use_kernel=False), jl).bits_per_dim() == 9.0
    for method in ("identity", "none"):   # every registry method is ported
        assert TCfg(method=method).make().name == "identity"
        assert t_bits(TCfg(method=method)) == j_bits(JCfg(method=method)) == 32.0


# --------------------------------------------------------- the DIANA round

def _grads(rng, n):
    """Per-coordinate magnitudes over 2^-100..2^100 (shared by the workers,
    so their decodes meet and cancel), signs and noise per worker."""
    def draw(shape):
        scale = 2.0 ** rng.integers(-100, 100, size=shape)
        return (rng.standard_normal((n, *shape)) * scale).astype(np.float32)
    return {"a": draw((3000,)), "blk": {"w": draw((40, 70)), "scale": draw((70,))},
            "emb": draw((5, 130))}


def _flat_rows(h, layout):
    """The worker memories as (n, D) in the bucket layout (per-leaf trees are
    concatenated in leaf order; the natural layout has no padding)."""
    if isinstance(h, dict):
        h = {p: np.asarray(v) for p, v in flatten_nested(h).items()}
        return np.concatenate([h[p].reshape(h[p].shape[0], -1) for p in layout.paths], axis=1)
    return np.asarray(h)


def _flat(tree, layout):
    if isinstance(tree, dict):
        tree = {p: np.asarray(v) for p, v in flatten_nested(tree).items()}
        return np.concatenate([tree[p].reshape(-1) for p in layout.paths])
    return np.asarray(tree)


def _run_round(bucketed, n, steps=3):
    """``steps`` jitted JAX reference steps and port reference steps from the
    same grads; per step, each side's own codes (its compressor on its own
    ``g - h_worker``) and states."""
    rng = np.random.default_rng(11 + n)
    grads = [_grads(rng, n) for _ in range(steps)]
    shapes = {p: g.shape[1:] for p, g in flatten_nested(grads[0]).items()}
    jcfg = JCfg(method="natural", bucketed=bucketed, use_kernel=False)
    tcfg = TCfg(method="natural", bucketed=bucketed)
    jparams = jax.tree_util.tree_map(lambda g: jnp.zeros(g.shape[1:]), grads[0])
    js = j_init(jparams, jcfg, n)
    ts = t_init({p: torch.zeros(s) for p, s in shapes.items()}, tcfg, n)
    tl = t_layout(TCfg(method="natural", bucketed=True), {p: torch.zeros(s)
                                                          for p, s in shapes.items()})
    jl = j_layout(JCfg(method="natural", bucketed=True), jparams)
    jbc = JBucketed(JNatural(use_kernel=False), jl)
    tbc = bucketed_compressor(TCfg(method="natural", bucketed=True), tl)
    jstep = jax.jit(lambda g, s, k: j_step(g, s, k, jcfg))
    jenc = jax.jit(lambda x, k: jbc.compress(x, k).packed)
    out = []
    for s in range(steps):
        gflat = np.stack([tl.flatten({p: _t(g[w]) for p, g in
                                      flatten_nested(grads[s]).items()}).numpy()
                          for w in range(n)])
        jkey = jax.random.fold_in(jax.random.PRNGKey(0), s)
        tkey = prng.fold_in(prng.PRNGKey(0), s)
        jh, th = _flat_rows(js.h_worker, tl), _flat_rows(ts.h_worker, tl)
        jcodes = np.stack([np.asarray(jenc(jnp.asarray(gflat[w] - jh[w]),
                                           jax.random.fold_in(jkey, w))) for w in range(n)])
        tcodes = np.stack([tbc.compress(_t(gflat[w]) - _t(th[w]),
                                        worker_key(tkey, w)).packed.numpy()
                           for w in range(n)])
        jv, js = jstep(jax.tree_util.tree_map(jnp.asarray, grads[s]), js, jkey)
        tv, ts = t_step({p: _t(g) for p, g in flatten_nested(grads[s]).items()}, ts, tkey,
                        tcfg)
        out.append(dict(jcodes=jcodes, tcodes=tcodes,
                        jghat=_flat(flatten_nested(jax.tree_util.tree_map(np.asarray, jv)), tl),
                        tghat=_flat({p: v.numpy() for p, v in tv.items()}, tl),
                        jhw=_flat_rows(js.h_worker, tl), thw=_flat_rows(ts.h_worker, tl),
                        jhs=_flat(js.h_server, tl), ths=_flat(ts.h_server, tl)))
    return out


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("n", [1, 4])
def test_reference_step_matches_jitted_jax(bucketed, n):
    """Step-0 codes bitwise.  Later steps encode ``g - h`` with each side's
    own memories, which differ within the exp2 tolerance, so a code whose
    uniform falls between the two rounding probabilities flips: at most 1e-5
    of the codes, each by one power of two.  Memories and ``ghat`` agree to
    rtol 1e-5 of the magnitudes summed into them over the steps (a memory
    that cancels to ~0 keeps the absolute error of what it summed), at every
    coordinate no flip has touched."""
    rounds = _run_round(bucketed, n)
    assert np.array_equal(rounds[0]["tcodes"], rounds[0]["jcodes"])
    n_flip = n_all = 0
    touched = np.zeros(rounds[0]["jcodes"].shape[1], bool)
    hw_scale = np.zeros(rounds[0]["jcodes"].shape, np.float64)
    hs_scale = np.zeros(rounds[0]["jcodes"].shape[1], np.float64)
    for r in rounds:
        diff = r["tcodes"] != r["jcodes"]
        n_flip += int(diff.sum())
        n_all += diff.size
        tc, jc = r["tcodes"][diff].astype(int), r["jcodes"][diff].astype(int)
        assert np.all((np.sign(tc) == np.sign(jc)) & (np.abs(tc - jc) == 1)), (tc, jc)
        touched |= diff.any(axis=0)
        dmag = np.abs(_exact(r["tcodes"]).astype(np.float64))
        ghat_scale = hs_scale + dmag.sum(axis=0) / n
        hw_scale += ALPHA * dmag
        hs_scale += ALPHA * dmag.sum(axis=0) / n
        ok = ~touched
        assert np.all(np.abs(r["thw"] - r["jhw"])[:, ok] <= 1e-5 * hw_scale[:, ok])
        assert np.all(np.abs(r["tghat"] - r["jghat"])[ok] <= 1e-5 * ghat_scale[ok])
        assert np.all(np.abs(r["ths"] - r["jhs"])[ok] <= 1e-5 * hs_scale[ok])
    assert n_flip <= 1e-5 * n_all, (n_flip, n_all)


def test_port_bucketed_equals_perleaf_bitwise():
    b, p = _run_round(True, 4, steps=2), _run_round(False, 4, steps=2)
    for rb, rp in zip(b, p):
        for k in ("tcodes", "tghat", "thw", "ths"):
            assert np.array_equal(rb[k].view(np.int32) if rb[k].dtype == np.float32 else rb[k],
                                  rp[k].view(np.int32) if rp[k].dtype == np.float32 else rp[k]), k


def test_state_from_jax_continues_bitwise():
    """A natural JAX ReferenceState (its shapes follow align = 1) converted
    with ``convert.state_from_jax`` steps on exactly as the port's own state
    holding the same values."""
    from repro_torch.convert import state_from_jax
    from repro_torch.core.diana import ReferenceState

    rng = np.random.default_rng(12)
    grads = [_grads(rng, 4) for _ in range(2)]
    params = jax.tree_util.tree_map(lambda g: jnp.zeros(g.shape[1:]), grads[0])
    for bucketed in (True, False):
        jcfg = JCfg(method="natural", bucketed=bucketed, use_kernel=False)
        tcfg = TCfg(method="natural", bucketed=bucketed)
        _, js = jax.jit(lambda g, s, k: j_step(g, s, k, jcfg))(
            jax.tree_util.tree_map(jnp.asarray, grads[0]), j_init(params, jcfg, 4),
            jax.random.PRNGKey(1))
        npst = jax.tree_util.tree_map(np.asarray, js)
        conv = state_from_jax(npst, "cpu")
        if bucketed:
            d = sum(int(np.prod(g.shape[1:])) for g in flatten_nested(grads[0]).values())
            assert tuple(conv.h_worker.shape) == (4, d) and tuple(conv.h_server.shape) == (d,)
        own = ReferenceState(*(
            _t(x).clone() if not isinstance(x, dict) else
            {p: _t(v).clone() for p, v in flatten_nested(x).items()}
            for x in (npst.h_worker, npst.h_server, npst.v)))
        g1 = {p: _t(g) for p, g in flatten_nested(grads[1]).items()}
        va, sa = t_step(g1, conv, prng.PRNGKey(2), tcfg)
        vb, sb = t_step(g1, own, prng.PRNGKey(2), tcfg)
        assert all(torch.equal(va[p], vb[p]) for p in va)
        for a, b in ((sa.h_worker, sb.h_worker), (sa.h_server, sb.h_server)):
            if isinstance(a, dict):
                assert all(torch.equal(a[p], b[p]) for p in a)
            else:
                assert torch.equal(a, b)


def test_trainer_cli_runs_natural_on_cpu():
    # One torch thread: the test suite runs several workers on the CPU.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
         "--reduced", "--device", "cpu", "--mesh", "2x1", "--steps", "2",
         "--batch", "4", "--seq", "32", "--compression", "natural"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
