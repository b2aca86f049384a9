"""The port's DIANA ``reference_step`` against the JAX package's (jitted) over
3 steps, same grads: p = inf is bitwise in ``ghat``, ``h_worker`` and
``h_server``, in both layouts.  (The JAX round is jitted because that is how
it runs in training: XLA then contracts every ``h + alpha * x`` into one FMA,
in both layouts alike, which is what the port reproduces.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import reference_init as j_init, reference_step as j_step
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig as TCfg
from repro_torch.core.diana import reference_init as t_init, reference_step as t_step
from repro_torch.core.tree import flatten_nested

def _grads(rng, n):
    def draw(shape):
        return (rng.standard_normal((n, *shape)) * rng.random()).astype(np.float32)
    return {"a": draw((3000,)), "blk": {"w": draw((40, 70)), "scale": draw((70,))},
            "emb": draw((5, 130))}


def _np(tree):
    return {p: np.asarray(v) for p, v in flatten_nested(tree).items()}


def _run(method, bucketed, n, beta, steps=3, block=256):
    rng = np.random.default_rng(7)
    grads = [_grads(rng, n) for _ in range(steps)]
    params = jax.tree_util.tree_map(lambda g: jnp.zeros(g.shape[1:]), grads[0])
    jcfg = JCfg(method=method, block_size=block, bucketed=bucketed, use_kernel=False)
    tcfg = TCfg(method=method, block_size=block, bucketed=bucketed)
    js = j_init(params, jcfg, n)
    ts = t_init({p: torch.zeros(v.shape[1:]) for p, v in flatten_nested(grads[0]).items()},
                tcfg, n)
    jstep = jax.jit(lambda g, s, k: j_step(g, s, k, jcfg, beta=beta))
    out = []
    for s in range(steps):
        jv, js = jstep(jax.tree_util.tree_map(jnp.asarray, grads[s]), js,
                       jax.random.fold_in(jax.random.PRNGKey(0), s))
        tv, ts = t_step({p: torch.from_numpy(g) for p, g in flatten_nested(grads[s]).items()},
                        ts, prng.fold_in(prng.PRNGKey(0), s), tcfg, beta=beta)
        out.append((jv, js, tv, ts))
    return out


def _assert_state_equal(jv, js, tv, ts, bucketed):
    for p, a in _np(jv).items():
        assert np.array_equal(tv[p].numpy(), a), p
    if bucketed:
        assert np.array_equal(ts.h_worker.numpy(), np.asarray(js.h_worker))
        assert np.array_equal(ts.h_server.numpy(), np.asarray(js.h_server))
    else:
        for p, a in _np(js.h_worker).items():
            assert np.array_equal(ts.h_worker[p].numpy(), a), p
        for p, a in _np(js.h_server).items():
            assert np.array_equal(ts.h_server[p].numpy(), a), p


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("n", [1, 4])
def test_reference_step_bitwise_pinf(bucketed, n):
    for jv, js, tv, ts in _run("diana", bucketed, n, beta=0.0):
        _assert_state_equal(jv, js, tv, ts, bucketed)


def test_reference_step_memoryless_bitwise():
    """The memoryless alias: the ``unpack_reduce_mean`` epilogue, ghat = the
    mean of the decodes, memories untouched."""
    for jv, js, tv, ts in _run("terngrad", True, 4, beta=0.0):
        _assert_state_equal(jv, js, tv, ts, True)


def test_reference_step_momentum():
    """beta > 0: the memories stay bitwise; ``v = beta*v + ghat`` agrees to
    rtol=atol=1e-6, because XLA contracts it into an FMA for some leaves and
    not for others (here the 70-element one), a choice of its fusion, not of
    the algorithm; the 1-ulp steps compound over the steps.  The port always
    takes the FMA."""
    for jv, js, tv, ts in _run("diana", True, 4, beta=0.9):
        assert np.array_equal(ts.h_worker.numpy(), np.asarray(js.h_worker))
        assert np.array_equal(ts.h_server.numpy(), np.asarray(js.h_server))
        for p, a in _np(jv).items():
            np.testing.assert_allclose(tv[p].numpy(), a, rtol=1e-6, atol=1e-6, err_msg=p)


def test_port_bucketed_equals_perleaf():
    b = _run("diana", True, 4, beta=0.0, steps=2)
    p = _run("diana", False, 4, beta=0.0, steps=2)
    for (_, _, tvb, tsb), (_, _, tvp, tsp) in zip(b, p):
        for k in tvb:
            assert torch.equal(tvb[k], tvp[k]), k


def test_bucket_layout_and_bits_per_dim_match_jax():
    from repro.core.compression import payload_bits_per_dim as j_bits
    from repro.core.diana import bucket_layout as j_layout
    from repro_torch.core.compression import payload_bits_per_dim as t_bits
    from repro_torch.core.diana import bucket_layout as t_layout

    rng = np.random.default_rng(8)
    grads = _grads(rng, 1)
    jcfg, tcfg = JCfg(block_size=256, bucketed=True), TCfg(block_size=256, bucketed=True)
    jl = j_layout(jcfg, jax.tree_util.tree_map(lambda g: jnp.asarray(g[0]), grads))
    tree = {p: torch.from_numpy(g[0]) for p, g in flatten_nested(grads).items()}
    tl = t_layout(tcfg, tree)
    assert (tl.sizes, tl.padded_sizes, tl.offsets) == (jl.sizes, jl.padded_sizes, jl.offsets)
    jflat = np.asarray(jl.flatten(jax.tree_util.tree_map(lambda g: jnp.asarray(g[0]), grads)))
    tflat = tl.flatten(tree)
    assert np.array_equal(tflat.numpy(), jflat)
    for a, b in zip(tl.split_padded(tflat), jl.split_padded(jnp.asarray(jflat))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert all(torch.equal(tl.unflatten(tflat)[p], tree[p]) for p in tree)
    for method in ("diana", "qsgd"):
        assert t_bits(TCfg(method=method)) == j_bits(JCfg(method=method))


def test_state_from_jax_continues_bitwise():
    """A JAX ReferenceState converted mid-run (convert.state_from_jax) and
    stepped by the port equals the JAX package's next step."""
    from repro_torch.convert import state_from_jax

    rng = np.random.default_rng(9)
    grads = [_grads(rng, 4) for _ in range(2)]
    params = jax.tree_util.tree_map(lambda g: jnp.zeros(g.shape[1:]), grads[0])
    for bucketed in (True, False):
        jcfg = JCfg(block_size=256, bucketed=bucketed, use_kernel=False)
        tcfg = TCfg(block_size=256, bucketed=bucketed)
        jstep = jax.jit(lambda g, s, k: j_step(g, s, k, jcfg))
        js = j_init(params, jcfg, 4)
        _, js = jstep(jax.tree_util.tree_map(jnp.asarray, grads[0]), js, jax.random.PRNGKey(1))
        ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
        jv, js = jstep(jax.tree_util.tree_map(jnp.asarray, grads[1]), js, jax.random.PRNGKey(2))
        tv, ts = t_step({p: torch.from_numpy(g) for p, g in flatten_nested(grads[1]).items()},
                        ts, prng.PRNGKey(2), tcfg)
        _assert_state_equal(jv, js, tv, ts, bucketed)
