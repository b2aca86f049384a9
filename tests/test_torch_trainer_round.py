"""The trainer's in-place round against the port's ``reference_step`` on
the same gradients, for every ported operator, on ``reduced(llama3.2-1b)``
with 4 workers on the CPU.  ``reference_step`` is held to the jitted JAX
round in ``tests/test_torch_diana.py``, ``test_torch_natural.py`` and
``test_torch_sparse.py``; this closes the chain to the trainer bit for bit.
"""

from dataclasses import replace

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import prng
from repro_torch.core.diana import reference_init, reference_step
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch.train import build_train_step, make_optimizer
from repro_torch.models.transformer import init_model, train_loss

N_WORKERS = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several pytest
    workers on one CPU, and torch's own thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["diana", "natural", "randk", "topk_ef", "identity"])
def test_trainer_round_equals_reference_step(method):
    """The trainer's in-place round (the input written into the gradient
    buffer: ``g - h``, or ``g + h`` for error feedback; payloads encoded
    into the gathered buffer; the operator's memory rule written into the
    state rows) leaves the same DIANA state and ghat as the port's
    ``reference_step`` on the same gradients, bit for bit, over 2 steps."""
    cfg = replace(reduced(get_config("llama3.2-1b")), compression=method, comp_k=4096)
    params = init_model(cfg, "cpu", seed=1)
    opt = make_optimizer(cfg, lr=3e-4)
    opt_state = opt.init(params, N_WORKERS)
    step_fn = build_train_step(cfg, opt, N_WORKERS, "cpu")
    ref = reference_init({p: v.detach() for p, v in params.items()}, opt.compression, N_WORKERS)
    paths = sorted(params)
    for s in range(2):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_lm_batch(cfg, ShapeConfig("t", 16, 4, "train"), s).items()}
        rows = 4 // N_WORKERS
        per_worker = [torch.autograd.grad(
            train_loss(params, {k: v[w * rows:(w + 1) * rows] for k, v in batch.items()}, cfg),
            [params[p] for p in paths]) for w in range(N_WORKERS)]
        grads = {p: torch.stack([g[i] for g in per_worker]) for i, p in enumerate(paths)}
        key = prng.fold_in(prng.PRNGKey(0), s)
        ghat, ref = reference_step(grads, ref, key, opt.compression)
        params, opt_state, metrics = step_fn(params, opt_state, batch, key)
        assert torch.equal(opt_state.diana.h_worker, ref.h_worker)
        assert torch.equal(opt_state.diana.h_server, ref.h_server)
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in ghat.values()))
        assert torch.equal(metrics["ghat_norm"], norm)
