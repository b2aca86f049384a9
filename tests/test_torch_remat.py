"""``remat="dots"`` in the port (``repro_torch.models.transformer``): each
block under a selective checkpoint whose policy is JAX's
``dots_with_no_batch_dims_saveable``.

* The loss and every gradient are bitwise the same under ``remat`` =
  ``none``, ``full`` and ``dots`` for reduced llama (also with query-chunked
  attention, a checkpoint inside the block's), granite-moe, mamba2 and
  jamba: a saved product is the tensor the recompute would give.
* The JAX loss and gradients under ``remat="dots"`` agree with the port's
  within the model tolerance of ``tests/test_torch_model_families.py``
  (rtol 1e-5, atol 1e-6; the Mamba-2 archs' loss only, their gradients
  being held normwise there).
* What each block saves.  The port saves the output of every ``aten.mm``
  (the products with no batch dimension; the batched einsums reach
  ``aten.bmm``); those are, in number, order and size, the no-batch
  ``dot_general`` outputs of the JAX block's jaxpr.  XLA keeps a product as
  a residual only where the backward reads it
  (``jax.ad_checkpoint.print_saved_residuals``): the same set, less the
  block's last product when the block ends in one (llama's MLP ``w_out``,
  mamba2's ``out_proj``: they feed only the residual add).  The port holds
  that one until the block's recompute reaches it (the recompute runs to
  the last op that saves a tensor for the backward, the product itself).
"""

import contextlib
import io
import re
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import init_model as j_init_model
from repro.models import transformer as JT
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.models import transformer as T
from test_torch_model_families import ATOL, RTOL, _case, _one_torch_thread

__all__ = ["_one_torch_thread"]   # the autouse fixture, imported to apply here

CASES = [("llama3.2-1b", 64, {}), ("llama3.2-1b", 64, {"attn_q_chunk": 16}),
         ("granite-moe-3b-a800m", 64, {}), ("mamba2-130m", 128, {}),
         ("jamba-v0.1-52b", 64, {})]
IDS = ["llama", "llama-qchunk", "granite-moe", "mamba2", "jamba"]


def _port(arch, seq, over):
    cfg = replace(reduced(get_config(arch)), **over)
    params = T.init_model(cfg, "cpu", seed=1)
    batch = {k: torch.from_numpy(v)
             for k, v in make_lm_batch(cfg, ShapeConfig("t", seq, 2, "train"), 0).items()}
    return cfg, params, batch


@pytest.mark.parametrize("arch,seq,over", CASES, ids=IDS)
def test_gradients_bitwise_under_none_full_dots(arch, seq, over):
    cfg, params, batch = _port(arch, seq, over)
    out = {}
    for remat in ("none", "full", "dots"):
        loss = T.train_loss(params, batch, replace(cfg, remat=remat))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(params.values())))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for p, a, b in zip(params, out[remat][1], out["none"][1]):
            assert torch.equal(a, b), (remat, p)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_dots_matches_jax(arch):
    tcfg, jloss, jg, port = _case(arch, remat="dots")
    assert tcfg.remat == "dots"
    loss, grads = port(torch.float32)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
    if not tcfg.has_mamba():
        for p, g in jg.items():
            np.testing.assert_allclose(grads[p].numpy(), g, rtol=RTOL, atol=ATOL, err_msg=p)


def _port_saved(cfg, params, batch):
    """(rows, columns) of each product the port's policy saves in the
    original forward of the first block."""
    saved = []

    def counting(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2], args[-1]          # mm(a, b) / addmm(bias, a, b)
            saved.append((a.shape[0], b.shape[1]))
        return decision

    policy = T.dots_policy
    T.dots_policy = counting
    try:
        T.train_loss(params, batch, replace(cfg, remat="dots"))
    finally:
        T.dots_policy = policy
    assert len(saved) % cfg.n_blocks == 0
    return saved[:len(saved) // cfg.n_blocks]


def _jax_block(arch, seq, over):
    cfg = replace(j_reduced(j_get_config(arch)), **over)
    bp = jax.tree_util.tree_map(lambda a: a[0], j_init_model(cfg, jax.random.PRNGKey(0))["blocks"])
    x = jax.random.normal(jax.random.PRNGKey(1), (2, seq, cfg.d_model)).astype(cfg.compute_dtype)
    pos = jnp.broadcast_to(jnp.arange(seq, dtype=jnp.int32)[None], (2, seq))
    return cfg, partial(JT._block_apply, cfg=cfg, window=None, positions=pos, bcaches=None), bp, x


def _rows_cols(shape):
    return (int(np.prod(shape[:-1])), int(shape[-1]))


def _jaxpr_dots(jaxpr, out):
    """The no-batch ``dot_general`` output shapes, sub-jaxprs included."""
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (_, _), (lb, rb) = e.params["dimension_numbers"]
            if not lb and not rb:
                out.append(_rows_cols(e.outvars[0].aval.shape))
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _jaxpr_dots(inner, out)
    return out


def _jax_residuals(block, bp, x):
    """The shapes ``print_saved_residuals`` lists for the dots-policy block,
    other than its arguments and constants."""
    def f(bp, x):
        body = jax.checkpoint(lambda p, h: block(p, h),
                              policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
        y, aux, _ = body(bp, x)
        return jnp.sum(y.astype(jnp.float32)) + aux

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(f, bp, x)
    out = []
    for line in buf.getvalue().splitlines():
        m = re.match(r"\w+\[([\d,]*)\] (.*)", line)
        if m and "from the argument" not in m.group(2) and "from a constant" not in m.group(2):
            out.append(_rows_cols(tuple(int(d) for d in m.group(1).split(","))))
    return out


@pytest.mark.parametrize("arch,seq,over", CASES, ids=IDS)
def test_saved_products_are_the_jax_blocks(arch, seq, over):
    cfg, params, batch = _port(arch, seq, over)
    saved = _port_saved(cfg, params, batch)
    jcfg, block, bp, x = _jax_block(arch, seq, over)
    dots = _jaxpr_dots(jax.make_jaxpr(block)(bp, x).jaxpr, [])
    assert saved == dots
    last = cfg.pattern[-1]
    ends_in_product = last.mlp in ("dense", "none")
    assert sorted(_jax_residuals(block, bp, x)) == sorted(saved[:-1] if ends_in_product
                                                          else saved)
