"""Three steps of the port's trainer (``build_train_step``) on
``reduced(llama3.2-1b)``, 4 workers, on the CPU, against the JAX composition
the trainer stands for: ``value_and_grad(train_loss)`` per worker shard ->
jitted ``reference_step`` (bucketed) -> momentum -> ``(p + u)`` write-back.
Loss per step and the parameters agree at rtol=1e-5, atol=1e-6 (f32 matrix
products and reductions sum in other orders; the aggregation itself is
bitwise given equal gradients, ``test_torch_diana.py``).

The one exception is stochastic rounding: where a gradient coordinate's
1e-7-level difference moves ``|delta| / scale`` across the drawn uniform, the
two sides keep different signs (a few coordinates in 3.3 M here).  Such a flip
moves that worker's decode by one block scale ``s``, ``ghat`` by ``s / n``,
and the parameter by at most ``LR * (1 + beta + beta^2) * s / n`` per step.
So at most 1e-5 of the coordinates may miss the tolerance, and none by more
than that bound.

The sparse operators run the same comparison (``--compression randk`` /
``topk_ef``, ``--comp-k``, 2 steps): rand-k selects from the same tags on
both sides; top-k selects by magnitude, so a 1e-7-level gradient difference
can swap the k-th and (k+1)-th coordinate of a leaf, which moves ghat and the
parameters at those coordinates by at most the same bound.
"""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.compression import CompressionConfig as JCfg
from repro.core.diana import reference_init, reference_step
from repro.data import make_lm_batch as j_make_lm_batch
from repro.models import init_model as j_init_model, train_loss as j_train_loss
from repro.optim.optimizers import momentum as j_momentum
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.core.tree import flatten_nested
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch.train import build_train_step, make_optimizer

RTOL, ATOL = 1e-5, 1e-6
N_WORKERS, STEPS, LR = 4, 3, 3e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several pytest
    workers on one CPU, and torch's own thread pool in each of them
    oversubscribes the cores (these model tests then take 10x their time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_composition(jcfg, jparams, batches, method="diana", k=64):
    ccfg = JCfg(method=method, p=jcfg.comp_p, block_size=jcfg.comp_block, k=k, bucketed=True,
                use_kernel=False)
    state = reference_init(jparams, ccfg, N_WORKERS)
    inner = j_momentum(0.9)
    v = inner.init(jparams)
    vg = jax.jit(jax.value_and_grad(lambda p, b: j_train_loss(p, b, jcfg)))
    agg = jax.jit(lambda g, s, k: reference_step(g, s, k, ccfg))
    losses, s_max = [], 0.0
    params = jparams
    for step, batch in enumerate(batches):
        rows = batch["tokens"].shape[0] // N_WORKERS
        out = [vg(params, {k: jnp.asarray(a[w * rows:(w + 1) * rows]) for k, a in batch.items()})
               for w in range(N_WORKERS)]
        losses.append(float(np.mean([float(l) for l, _ in out])))
        grads = jax.tree_util.tree_map(lambda *g: jnp.stack(g), *[g for _, g in out])
        g_max = max(float(jnp.max(jnp.abs(g))) for g in jax.tree_util.tree_leaves(grads))
        s_max = max(s_max, g_max + float(jnp.max(jnp.abs(state.h_worker))))  # >= |g - h|
        ghat, state = agg(grads, state, jax.random.fold_in(jax.random.PRNGKey(0), step))
        updates, v = inner.update(ghat, v, params, jnp.float32(LR))
        params = jax.tree_util.tree_map(
            lambda p, u: (p.astype(jnp.float32) + u).astype(p.dtype), params, updates)
    return losses, params, s_max


def test_train_steps_match_jax_composition():
    jcfg = j_reduced(j_get_config("llama3.2-1b"))
    tcfg = reduced(get_config("llama3.2-1b"))
    jshape, tshape = JShape("t", 32, 8, "train"), ShapeConfig("t", 32, 8, "train")
    batches = [make_lm_batch(tcfg, tshape, s) for s in range(STEPS)]
    for s, b in enumerate(batches):  # the port's data pipeline is the JAX one
        jb = j_make_lm_batch(jcfg, jshape, s)
        assert all(np.array_equal(b[k], jb[k]) for k in jb)
    _check_against_jax(jcfg, tcfg, batches)


@pytest.mark.parametrize("method", ["randk", "topk_ef"])
def test_train_steps_match_jax_composition_sparse(method):
    jcfg = j_reduced(j_get_config("llama3.2-1b"))
    tcfg = replace(reduced(get_config("llama3.2-1b")), compression=method, comp_k=4096)
    batches = [make_lm_batch(tcfg, ShapeConfig("t", 32, 8, "train"), s) for s in range(2)]
    _check_against_jax(jcfg, tcfg, batches, method=method, k=4096)


def _check_against_jax(jcfg, tcfg, batches, method="diana", k=64):
    jparams = j_init_model(jcfg, jax.random.PRNGKey(0))
    j_losses, j_final, s_max = _jax_composition(jcfg, jparams, batches, method, k)

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    opt = make_optimizer(tcfg, lr=LR)
    opt_state = opt.init(params, N_WORKERS)
    step_fn = build_train_step(tcfg, opt, N_WORKERS, "cpu")
    t_losses = []
    for s, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(
            params, opt_state, {k: torch.from_numpy(v) for k, v in batch.items()},
            prng.fold_in(prng.PRNGKey(0), s))
        t_losses.append(float(metrics["loss"]))
        assert np.isfinite(t_losses[-1])
    assert opt_state.step == len(batches)

    np.testing.assert_allclose(t_losses, j_losses, rtol=RTOL, atol=ATOL)
    flip_bound = len(batches) * LR * (1 + 0.9 + 0.81) * s_max / N_WORKERS + ATOL
    n_miss = n_all = 0
    for p, a in flatten_nested(jax.tree_util.tree_map(np.asarray, j_final)).items():
        diff = np.abs(params[p].detach().numpy() - a)
        n_miss += int(np.sum(diff > ATOL + RTOL * np.abs(a)))
        n_all += a.size
        assert diff.max() <= flip_bound, (p, diff.max(), flip_bound)
    assert n_miss <= 1e-5 * n_all, (n_miss, n_all)


def test_trainer_cli_runs_on_cpu():
    # One torch thread: the test suite runs several workers on the CPU.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
         "--reduced", "--device", "cpu", "--mesh", "2x1", "--steps", "2",
         "--batch", "4", "--seq", "32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
