"""Synthetic data, numpy only: the port's copy of ``repro.data.pipeline``'s
LM stream (``LMStream`` / ``make_lm_batch``) and convex problems
(``logreg_data`` / ``logistic_loss_and_grad``).

The LM stream is a deterministic synthetic language with learnable
structure (an order-1 affine-mod grammar plus noise), so losses genuinely
decrease; each worker has its own grammar coefficients (heterogeneous local
data).  The convex data are the same numpy draws as the JAX package's, so the
arrays are identical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.shapes import input_shapes

__all__ = ["LMStream", "make_lm_batch", "logreg_data", "logistic_loss_and_grad"]


@dataclass
class LMStream:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    noise: float = 0.1
    n_workers: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-safe)."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        b, s, v = self.batch, self.seq_len, self.vocab
        worker = rng.integers(0, self.n_workers, size=(b, 1))
        a = 3 + 2 * worker
        c = 7 + 11 * worker
        toks = np.empty((b, s), dtype=np.int64)
        toks[:, 0] = rng.integers(0, v, size=b)
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, size=(b, s))
        for t in range(1, s):
            nxt = (toks[:, t - 1] * a[:, 0] + c[:, 0]) % v
            toks[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks.astype(np.int32)}


def make_lm_batch(cfg, shape, step: int, seed: int = 0,
                  n_workers: int = 1) -> Dict[str, np.ndarray]:
    """One batch of :func:`~repro_torch.configs.shapes.input_shapes`: int32
    tokens (and labels for train shapes), and a frontend model's f32 stub
    embeddings drawn from ``default_rng(seed * 999_983 + step)``, the JAX
    package's arrays."""
    shapes = input_shapes(cfg, shape)
    rng = np.random.default_rng(seed * 999_983 + step)
    b, s = shapes["tokens"]
    stream = LMStream(vocab=cfg.vocab, seq_len=s, batch=b, seed=seed + step,
                      n_workers=n_workers)
    out = {"tokens": stream.batch_at(step)["tokens"]}
    if "labels" in shapes:
        out["labels"] = np.roll(out["tokens"], -1, axis=1)
    for k in ("vision_embeds", "audio_embeds"):
        if k in shapes:
            out[k] = rng.standard_normal(shapes[k]).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Convex problems (paper Sec. 6 / M.2)
# ---------------------------------------------------------------------------

def logreg_data(problem):
    """Synthetic binary classification split across heterogeneous workers
    (a :class:`~repro_torch.configs.diana_paper.LogRegProblem`).

    Each worker's feature distribution is shifted and scaled differently (no
    similarity between the D_i: the paper's setting).  Returns features
    ``(n_workers, m, dim)`` f32 and labels ``(n_workers, m)`` in {-1, +1}."""
    rng = np.random.default_rng(problem.seed)
    n, d, w = problem.n_samples, problem.dim, problem.n_workers
    m = n // w
    true_w = rng.standard_normal(d) / math.sqrt(d)
    feats, labels = [], []
    for i in range(w):
        shift = 0.5 * rng.standard_normal(d) * (i / max(w - 1, 1))
        scale = 1.0 + 0.5 * (i / max(w - 1, 1))
        X = rng.standard_normal((m, d)) * scale + shift
        X /= np.linalg.norm(X, axis=1, keepdims=True).clip(1e-8)   # row-normalised
        logits = X @ true_w + 0.1 * rng.standard_normal(m)
        y = np.where(logits > 0, 1.0, -1.0)
        feats.append(X)
        labels.append(y)
    return np.stack(feats).astype(np.float32), np.stack(labels).astype(np.float32)


def logistic_loss_and_grad(w, X, y, l2: float):
    """One worker's regularised logistic loss and gradient (numpy):
    ``mean log(1 + exp(-y x.w)) + l2/2 ||w||^2``."""
    z = y * (X @ w)
    loss = np.mean(np.log1p(np.exp(-z))) + 0.5 * l2 * float(w @ w)
    sig = 1.0 / (1.0 + np.exp(z))
    grad = -(X * (y * sig)[:, None]).mean(0) + l2 * w
    return loss, grad
