"""The paper's convex harness on the port: regularised logistic regression
through ``reference_step`` (the port's copy of ``benchmarks/common.py``, with
the same names and signatures plus ``device``).

* :func:`run_logreg` — full local gradients, the per-leaf reference round
  driven step by step (the paper's Sec. 6 / M.2 experiments), with an
  optional l1 prox and a compressed downlink;
* :func:`fstar_logreg` — the optimum by uncompressed gradient descent,
  cached per problem;
* :func:`stoch_problem` / :func:`run_logreg_stochastic` — the finite-sum
  regime of VR-DIANA (arXiv:1904.05115): per-step minibatches drawn with
  ``randint(fold_in(step_key, _SAMPLE_FOLD), ...)``, the JAX harness's data
  order, and VR with ``mu^0`` the true local full gradient.

Like every entry point of the port it runs on ``cuda`` unless the caller
passes ``device="cpu"``; on the card the rounds launch the kernels of the
chosen operator (per leaf, on the one leaf ``x``).  Its trajectories agree
with the JAX harness's within the tolerance ``tests/test_torch_convex.py``
states (the reference round's FMAs and the gradients' summation order
differ, which flips a few stochastic roundings), and each reaches the
optimum the paper's laws promise.

    from repro_torch.benchmarks.common import fstar_logreg, run_logreg, stoch_problem
    prob = stoch_problem()
    r = run_logreg("diana", math.inf, steps=200, gamma=1.0, block=8, problem=prob)
    print(r["final_loss"] - fstar_logreg(prob, 400))
"""

from __future__ import annotations

import functools
import math
import time
from typing import Optional

import torch

from repro_torch.configs.diana_paper import LogRegProblem
from repro_torch.core import prng
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.diana import reference_init, reference_step
from repro_torch.core.prox import l1 as l1_reg, none as no_reg
from repro_torch.core.vr import resolve_vr_p
from repro_torch.data.pipeline import logreg_data
from repro_torch.launch.train import resolve_device

__all__ = ["run_logreg", "fstar_logreg", "stoch_problem", "run_logreg_stochastic"]

_SAMPLE_FOLD = 0x534A  # 'SJ': the per-step minibatch draw, folded into no other key


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _data(prob, dev):
    X, y = logreg_data(prob)
    return torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)


def run_logreg(method: str, p: float, *, steps: int, gamma: float, block: int,
               beta: float = 0.0, alpha=None, k: int = 64, l1=0.0,
               n_workers: int = 10, seed: int = 0, problem=None,
               down_method=None, down_k=None, device="cuda"):
    """Distributed (reference-simulated) regularised logistic regression:
    each step the per-worker full local gradients through ``reference_step``
    (per leaf), then ``x <- prox(x - gamma v)``.  ``down_method`` compresses
    the server broadcast too (bidirectional DIANA).  Returns the loss
    trajectory, the final loss, ``x``, the wall time per step and the cfg."""
    dev = resolve_device(device)
    prob = problem or LogRegProblem(n_workers=n_workers, seed=seed)
    X, y = _data(prob, dev)
    l2 = prob.l2
    reg = l1_reg(l1) if l1 > 0 else no_reg()

    def worker_grads(w):
        z = y * torch.einsum("wij,j->wi", X, w)
        sig = torch.sigmoid(-z)
        return -torch.einsum("wij,wi->wj", X, y * sig) / X.shape[1] + l2 * w

    def full_loss(w):
        z = y * torch.einsum("wij,j->wi", X, w)
        return float(torch.mean(torch.log1p(torch.exp(-z))) + 0.5 * l2 * w @ w
                     + reg.tree_value({"w": w}))

    cfg = CompressionConfig(method=method, p=p, block_size=block, alpha=alpha, k=k,
                            down_method=down_method, down_k=down_k)
    params = {"x": torch.zeros(prob.dim, device=dev)}
    state = reference_init(params, cfg, prob.n_workers)
    key = prng.PRNGKey(seed)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(steps):
        key = prng.fold_in(key, t)
        v, state = reference_step({"x": worker_grads(params["x"])}, state, key, cfg, beta=beta)
        params = reg.tree_prox({"x": params["x"] - gamma * v["x"]}, gamma)
        if t % max(1, steps // 50) == 0 or t == steps - 1:
            losses.append((t, full_loss(params["x"])))
    _sync(dev)
    wall = (time.perf_counter() - t0) / steps * 1e6
    return {"losses": losses, "final_loss": losses[-1][1], "x": params["x"],
            "us_per_step": wall, "cfg": cfg}


@functools.lru_cache(maxsize=None)
def fstar_logreg(problem=None, steps: int = 4000, l1: float = 0.0, device="cuda"):
    """The optimum's loss by uncompressed full-gradient descent, cached per
    ``(problem, steps, l1, device)``."""
    res = run_logreg("none", 2.0, steps=steps, gamma=2.0, block=64, l1=l1, problem=problem,
                     device=device)
    return res["final_loss"]


# ---------------------------------------------------------------------------
# Stochastic finite-sum regime (VR-DIANA vs DIANA/QSGD, arXiv:1904.05115)
# ---------------------------------------------------------------------------

def stoch_problem(dim: int = 24, n_workers: int = 4, m_per_worker: int = 32,
                  l2: float = 0.1, seed: int = 3):
    """The seeded strongly-convex fixture of the stochastic runs: small enough
    for a few hundred steps in seconds, convex enough (l2 ~ L/3) that the rate
    laws separate cleanly."""
    return LogRegProblem(name=f"stoch-{dim}d", n_samples=n_workers * m_per_worker,
                         dim=dim, n_workers=n_workers, l2=l2, seed=seed)


def run_logreg_stochastic(method: str, p: float = math.inf, *, steps: int,
                          gamma: float, block: int = 8, batch: int = 1,
                          vr: bool = False, vr_p: Optional[float] = None,
                          alpha=None, k: int = 8, beta: float = 0.0,
                          seed: int = 0, problem=None, record_every: int = 25,
                          device="cuda"):
    """Finite-sum stochastic logistic regression through ``reference_step``:
    each step every worker samples ``batch`` of its ``m`` samples (the JAX
    harness's draws) and feeds its minibatch gradient, control-variated
    against its (snapshot, mu) when ``vr`` (exact L-SVRG: ``mu^0`` and every
    refresh the full local gradient; ``vr_p=None`` is the paper's ``1/m``).
    Returns the loss trajectory, final loss, ``x``, wall time per step, cfg."""
    dev = resolve_device(device)
    prob = problem or stoch_problem()
    X, y = _data(prob, dev)
    w_, m, d = X.shape
    l2 = prob.l2
    cfg = CompressionConfig(method=method, p=p, block_size=block, alpha=alpha, k=k,
                            vr=vr, vr_p=resolve_vr_p(vr_p, m) if vr else None)

    def full_grads(xmat):
        """Per-worker full local gradients at per-worker points (w, d)."""
        z = y * torch.einsum("wij,wj->wi", X, xmat)
        sig = torch.sigmoid(-z)
        return -torch.einsum("wij,wi->wj", X, y * sig) / m + l2 * xmat

    def sampled_grads(xmat, idx):
        """Per-worker minibatch gradients at per-worker points; idx (w, batch)."""
        Xb = torch.gather(X, 1, idx[..., None].expand(-1, -1, d))       # (w, b, d)
        yb = torch.gather(y, 1, idx)                                    # (w, b)
        z = yb * torch.einsum("wbj,wj->wb", Xb, xmat)
        sig = torch.sigmoid(-z)
        return -torch.einsum("wbj,wb->wj", Xb, yb * sig) / idx.shape[1] + l2 * xmat

    def full_loss(xv):
        z = y * torch.einsum("wij,j->wi", X, xv)
        return float(torch.mean(torch.log1p(torch.exp(-z))) + 0.5 * l2 * xv @ xv)

    params = {"x": torch.zeros(d, device=dev)}
    state = reference_init(params, cfg, w_)
    if vr:
        x0 = params["x"].expand(w_, d)
        state = state._replace(vr=state.vr._replace(mu={"x": full_grads(x0)}))

    def step(params, state, kt):
        idx = prng.randint(prng.fold_in(kt, _SAMPLE_FOLD), (w_, batch), 0, m).to(dev)
        xb = params["x"].expand(w_, d)
        g = {"x": sampled_grads(xb, idx)}
        if vr:
            g_snap = {"x": sampled_grads(state.vr.snapshot["x"], idx)}
            v, state = reference_step(g, state, kt, cfg, beta=beta,
                                      vr_aux=(g_snap, {"x": full_grads(xb)}), params=params)
        else:
            v, state = reference_step(g, state, kt, cfg, beta=beta)
        return {"x": params["x"] - gamma * v["x"]}, state

    key = prng.PRNGKey(seed)
    step(params, state, prng.fold_in(key, 0))   # warm-up (first launches), discarded
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(steps):
        params, state = step(params, state, prng.fold_in(key, t))
        if t % record_every == 0 or t == steps - 1:
            losses.append((t, full_loss(params["x"])))
    _sync(dev)
    wall = (time.perf_counter() - t0) / steps * 1e6
    return {"losses": losses, "final_loss": losses[-1][1], "x": params["x"],
            "us_per_step": wall, "cfg": cfg}
