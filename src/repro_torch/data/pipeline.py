"""Synthetic LM token stream (numpy only; the port's copy of
``repro.data.pipeline``'s ``LMStream`` / ``make_lm_batch``).

A deterministic synthetic language with learnable structure — an order-1
affine-mod grammar plus noise — so losses genuinely decrease; each worker
has its own grammar coefficients (heterogeneous local data).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.shapes import input_shapes

__all__ = ["LMStream", "make_lm_batch"]


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
    """One int32 batch (tokens, and labels for train shapes)."""
    shapes = input_shapes(cfg, shape)
    b, s = shapes["tokens"]
    stream = LMStream(vocab=cfg.vocab, seq_len=s, batch=b, seed=seed + step,
                      n_workers=n_workers)
    out = {"tokens": stream.batch_at(step)["tokens"]}
    if "labels" in shapes:
        out["labels"] = np.roll(out["tokens"], -1, axis=1)
    return out
