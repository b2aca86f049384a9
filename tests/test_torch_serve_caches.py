"""Serving's shapes, caches and CLI against the JAX package, without
allocating a full-size cache.

* ``SHAPES``, ``get_shape`` (``KeyError`` for an unknown name),
  ``shape_applicable``, ``decode_window`` and the decode branch of
  ``input_shapes`` equal the JAX package's for every architecture and shape.
* ``init_caches`` for all ten full configs, at each shape's batch and
  length with and without the shape's window, has the leaves of
  ``jax.eval_shape(init_caches)`` (the port's on ``meta`` tensors): the same
  tree, shapes and dtypes exactly, a uint16 KV leaf of the JAX package read
  as the bf16 it stores.
* ``caches_from_jax`` carries a JAX cache tree after decode steps across bit
  for bit (uint16 as bf16, ``pos`` included).
* The CLI (``python -m repro_torch.launch.serve --reduced --device cpu``)
  decodes from ``jax.random.randint``'s first tokens (bitwise), each next
  token the first maximum of the logits modulo the vocabulary.
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
from repro.configs.shapes import SHAPES as J_SHAPES, get_shape as j_get_shape
from repro.configs.shapes import input_specs, shape_applicable as j_applicable
from repro.launch.serve import decode_window as j_decode_window
from repro.models import decode_step as j_decode_step, init_caches as j_init_caches
from repro.models import init_model as j_init_model
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, ShapeConfig, get_config, get_shape,
                                 input_shapes, reduced, shape_applicable)
from repro_torch.convert import caches_from_jax
from repro_torch.launch import serve
from repro_torch.models.transformer import init_caches

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_equal_jax():
    assert set(SHAPES) == set(J_SHAPES)
    for name, s in SHAPES.items():
        j = J_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
        assert get_shape(name) == s
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("decode_1m")
    with pytest.raises(KeyError):
        j_get_shape("decode_1m")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_applicability_window_and_decode_inputs_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        shape, jshape = SHAPES[name], J_SHAPES[name]
        assert shape_applicable(cfg, shape) == j_applicable(jcfg, jshape)
        assert serve.decode_window(cfg, shape) == j_decode_window(jcfg, jshape)
        specs = input_specs(jcfg, jshape)
        if shape.kind == "decode":
            assert input_shapes(cfg, shape) == {k: tuple(v.shape) for k, v in specs.items()}
            assert str(specs["tokens"].dtype) == "int32"


def _leaf_sig(a):
    """(shape, dtype name) of a cache leaf, uint16 read as bf16."""
    name = str(a.dtype).replace("torch.", "")
    return tuple(a.shape), "bfloat16" if name == "uint16" else name


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_init_caches_equal_jax_eval_shape(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        windows = {None, serve.decode_window(cfg, shape)}
        for window in windows:
            mine = init_caches(cfg, shape.global_batch, shape.seq_len, window=window,
                               device="meta")
            ref = jax.eval_shape(lambda: j_init_caches(jcfg, shape.global_batch, shape.seq_len,
                                                       window=window))
            assert len(mine) == len(ref) == len(cfg.pattern)
            for m, r in zip(mine, ref):
                assert type(m).__name__ == type(r).__name__
                assert m._fields == r._fields
                assert [_leaf_sig(a) for a in m] == [_leaf_sig(a) for a in r], (name, window)
                assert all(a.device.type == "meta" for a in m)


@pytest.mark.parametrize("arch,dtype", [("llama3.2-1b", "bfloat16"), ("jamba-v0.1-52b", "float32"),
                                        ("jamba-v0.1-52b", "bfloat16")])
def test_caches_from_jax_bitwise(arch, dtype):
    """A JAX cache tree after three decode steps -> the port's, bit for bit:
    the uint16-stored bf16 KV leaves, the bf16 or f32 conv history, the f32
    state and ``pos``."""
    dt = getattr(jnp, dtype)
    jcfg = replace(j_reduced(j_get_config(arch)), param_dtype=dt, compute_dtype=dt)
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    caches = j_init_caches(jcfg, 2, 8)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (2, 1)), jnp.int32)
    step = jax.jit(lambda p, t, c: j_decode_step(p, t, c, jcfg))
    for _ in range(3):
        _, caches = step(params, tokens, caches)
    np_caches = jax.tree_util.tree_map(np.asarray, caches)
    mine = caches_from_jax(np_caches, "cpu")
    for m, r in zip(mine, np_caches):
        assert m._fields == r._fields
        for a, b in zip(m, r):
            if b.dtype == np.uint16:
                assert a.dtype == torch.bfloat16
                assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16), b)
            elif b.dtype.name == "bfloat16":
                assert a.dtype == torch.bfloat16
                assert np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
            else:
                assert str(a.dtype).replace("torch.", "") == b.dtype.name
                assert np.array_equal(a.numpy(), b)
    assert int(mine[0].pos[0]) == 3


def test_cli_first_tokens_are_jax_randint(monkeypatch, capsys):
    """The CLI's loop: the first tokens bitwise ``jax.random.randint(
    PRNGKey(0), (B, 1), 0, vocab)``, then each token the first maximum of
    the last step's logits modulo the vocabulary."""
    seen = []
    build = serve.build_serve_step

    def spy(cfg, shape):
        step = build(cfg, shape)

        def wrapped(params, caches, tokens):
            logits, caches = step(params, caches, tokens)
            seen.append((tokens.clone(), logits.clone()))
            return logits, caches
        return wrapped

    monkeypatch.setattr(serve, "build_serve_step", spy)
    serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--tokens", "4",
                "--batch", "3", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "decoded 4 tokens x 3 seqs in" in out and "tok/s" in out
    vocab = reduced(get_config("llama3.2-1b")).vocab
    first = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (3, 1), 0, vocab))
    assert len(seen) == 4
    assert np.array_equal(seen[0][0].numpy(), first)
    for (_, logits), (nxt, _) in zip(seen, seen[1:]):
        want = np.argmax(logits[:, -1:].numpy(), axis=-1) % vocab
        assert np.array_equal(nxt.numpy(), want)


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "llama3.2-1b", "--reduced", "--device", "cpu", "--tokens", "4"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "decoded 4 tokens x 4 seqs in" in res.stdout


def test_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--reduced", "--tokens", "1"])


def test_long_context_needs_a_sub_quadratic_path():
    """Every registered arch has one; without its window an attention
    model is refused as the JAX package refuses it, and a hybrid is not."""
    for arch in ("llama3.2-1b", "jamba-v0.1-52b"):
        cfg = replace(get_config(arch), sliding_window=None)
        jcfg = replace(j_get_config(arch), sliding_window=None)
        got = shape_applicable(cfg, SHAPES["long_500k"])
        assert got == j_applicable(jcfg, J_SHAPES["long_500k"])
        assert got[0] == cfg.has_mamba()


def test_trainer_refuses_a_decode_shape():
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--shape",
                    "decode_32k", "--steps", "1"])


def test_decode_input_shapes_of_a_frontend_model_are_tokens_only():
    cfg = reduced(get_config("internvl2-2b"))
    assert input_shapes(cfg, ShapeConfig("d", 64, 3, "decode")) == {"tokens": (3, 1)}
    assert "vision_embeds" in input_shapes(cfg, ShapeConfig("p", 64, 3, "prefill"))
