"""The port's trainers resume bit for bit from a checkpoint: the five
operators bucketed and ``--per-leaf-agg`` (the policy, VR with a downlink,
adamw, an elastic run, a world of one and the CLI's ``--checkpoint-dir``
are in ``tests/test_torch_checkpoint_train.py``).

Resume: 3 steps, then ``save_checkpoint`` of ``{"params", "opt_state"}``
with the policy in the metadata, ``restore_checkpoint`` into a template
built from another seed (fresh parameters and a zero state), and a 4th
step with a freshly built step function.  The 4th step's loss, the
parameters and every leaf of the optimizer state (the step counter, the
inner optimizer, the DIANA memories, the VR slot, ``h_down``) equal those
of the uninterrupted run's 4th step (the same state stepped on in memory)
bit for bit.  The JAX
package's own resume test (``tests/test_system.py::test_checkpoint_resume_bitwise``)
fails on jax 0.9.0 inside the JAX trainer, so the port is held to its own
uninterrupted run.

The model is reduced llama3.2-1b narrowed to d_model 128 (as in
``tests/test_torch_perleaf_train.py``); torch runs one thread.
"""

from dataclasses import replace

import pytest
import torch

from repro_torch.checkpoint import (participation_restore_hint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import prng
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import train
from repro_torch.models.transformer import init_model

N = 2
SHAPE = ShapeConfig("t", 16, 4, "train")
METHODS = ("diana", "natural", "randk", "topk_ef", "none")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**over):
    return replace(reduced(get_config("llama3.2-1b")), d_model=128, n_heads=4, n_kv_heads=2,
                   head_dim=32, d_ff=256, comp_k=512, **over)


def _steps(cfg, step_fn, params, state, start, stop):
    losses = []
    for s in range(start, stop):
        batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, SHAPE, s).items()}
        params, state, met = step_fn(params, state, batch, prng.fold_in(prng.PRNGKey(0), s))
        losses.append(met["loss"])
    return losses, params, state


def _same(a, b):
    """Two state trees (tensors, ints, dicts, lists, NamedTuples) equal bit
    for bit."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.detach().view(torch.uint8) if a.dim() else a.detach(),
                                b.detach().view(torch.uint8) if b.dim() else b.detach()))
    if isinstance(a, int):
        return type(b) is int and a == b
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _resume_bitwise(tmp_path, cfg, opt, build, rows):
    """3 steps and a save, then the 4th step twice: continuing in memory
    (the uninterrupted run: saving reads and changes nothing) and from the
    checkpoint restored into a template of another seed."""
    params = init_model(cfg, "cpu", seed=1)
    _, params, state = _steps(cfg, build(), params, opt.init(params, rows), 0, 3)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, {"params": params, "opt_state": state},
                    metadata={"policy": opt.policy.to_json_dict()})
    ref_losses, ref_params, ref_state = _steps(cfg, build(), params, state, 3, 4)
    tmpl_params = init_model(cfg, "cpu", seed=7)
    tree, step = restore_checkpoint(d, {"params": tmpl_params,
                                        "opt_state": opt.init(tmpl_params, rows)})
    assert step == 3 and tree["opt_state"].step == 3
    assert all(isinstance(p, torch.nn.Parameter) for p in tree["params"].values())
    assert participation_restore_hint(d, opt.policy) is None
    losses, params, state = _steps(cfg, build(), tree["params"], tree["opt_state"], 3, 4)
    assert torch.equal(losses[0], ref_losses[0])
    assert _same(params, ref_params)
    assert _same(state, ref_state)
    return state


@pytest.mark.parametrize("method", METHODS)
def test_resume_bitwise_bucketed(tmp_path, method):
    cfg = _config(compression=method)
    opt = train.make_optimizer(cfg)
    _resume_bitwise(tmp_path, cfg, opt, lambda: train.build_train_step(cfg, opt, N, "cpu"), N)


@pytest.mark.parametrize("method", ["diana", "topk_ef"])
def test_resume_bitwise_per_leaf(tmp_path, method):
    cfg = _config(compression=method, comp_bucketed=False)
    opt = train.make_optimizer(cfg)
    state = _resume_bitwise(tmp_path, cfg, opt,
                            lambda: train.build_train_step(cfg, opt, N, "cpu"), N)
    assert isinstance(state.diana.h_worker, dict)
