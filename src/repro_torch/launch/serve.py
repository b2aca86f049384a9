"""Serving: batched prefill and the cached single-token decode (the port of
``repro/launch/serve.py``), with no compression.

``decode_32k`` decodes one token per sequence for 128 sequences against
caches of 32,768 positions; ``long_500k`` serves one sequence of 524,288
positions, an attention model through its sliding window (a ring-buffer
cache of ``cfg.sliding_window`` rows), an SSM or hybrid model through its
recurrent state.  The step updates the caches in place, the counterpart of
the JAX step's donated caches: a functional update would hold the cache
twice and copy it every token.  The position stays on the device, so the
decode loop never waits for the host.

Usage::

    python -m repro_torch.launch.serve --arch llama3.2-1b --shape long_500k --tokens 16
    python -m repro_torch.launch.serve --arch llama3.2-1b --reduced --device cpu --tokens 4

The JAX package's ``serve_cache_shardings`` and the ``mesh`` argument of its
builders are GSPMD shardings over a model axis; the port serves on one
device (serving over the model axis is ROADMAP.md queue 1 item 12(d)).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import (ShapeConfig, get_config, get_shape, list_archs, reduced,
                                 shape_applicable)
from repro_torch.core import prng
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import decode_step, forward, head_logits, init_caches, init_model

__all__ = ["decode_window", "build_serve_step", "build_prefill", "main"]


def decode_window(cfg, shape) -> Optional[int]:
    """long_500k engages the sliding window on attention archs (hybrids keep
    full attention: their Mamba layers carry the long context)."""
    if shape.name == "long_500k" and not cfg.has_mamba():
        return cfg.sliding_window
    return None


def build_serve_step(cfg, shape):
    """``step(params, caches, tokens (B, 1)) -> (logits (B, 1, V_pad) f32,
    caches)``, the caches (:func:`~repro_torch.models.transformer.init_caches`
    with ``window=decode_window(cfg, shape)``) updated in place."""
    window = decode_window(cfg, shape)

    def step(params, caches, tokens):
        with torch.inference_mode():
            return decode_step(params, tokens, caches, cfg, window)

    return step


def build_prefill(cfg, shape):
    """``prefill(params, batch) -> next-token logits (B, 1, V_pad) f32``:
    the forward over the whole prompt, the head applied to the last
    position alone (the (B, S, V) logits are never formed)."""

    def prefill(params, batch):
        with torch.inference_mode():
            x, _ = forward(params, batch, cfg, last_token_only=True)
            return head_logits(params, x, cfg)

    return prefill


def main(argv=None):
    ap = argparse.ArgumentParser(description="serving demo (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--tokens", type=int, default=16, help="tokens to decode")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="sequences (with --reduced)")
    ap.add_argument("--cache-len", type=int, default=256, help="cache length (with --reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        shape = ShapeConfig("reduced-decode", args.cache_len, args.batch, "decode")
    else:
        shape = get_shape(args.shape)
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            ap.error(why)
    dev = resolve_device(args.device)

    params = init_model(cfg, dev, seed=0)
    caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                         window=decode_window(cfg, shape), device=dev)
    step_fn = build_serve_step(cfg, shape)
    tokens = prng.randint(prng.PRNGKey(0), (shape.global_batch, 1), 0, cfg.vocab).to(dev)
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        logits, caches = step_fn(params, caches, tokens)
        tokens = torch.argmax(logits[:, -1:], dim=-1) % cfg.vocab
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x {shape.global_batch} seqs in {dt:.2f}s "
          f"({args.tokens * shape.global_batch / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
