"""Serving over a ``(2, 2)`` mesh: 4 gloo ranks of CPU processes (2 data x 2
model ranks) against the JAX package's GSPMD serve step
(``build_serve_step(cfg, mesh, shape)`` / ``build_prefill``) on an
Auto-axis ``(2, 2)`` host mesh (a JAX subprocess with 4 host devices; the
parameters placed by ``param_specs``, the caches by
``serve_cache_shardings``, the prefill batch by ``batch_specs``).

The JAX subprocess writes every case's weights (``init_model``), tokens,
starting caches and prompts first; the ranks load their shards
(``params_shard_from_jax``, ``caches_shard_from_jax``) while the JAX side
compiles and serves.  Each decode case runs four teacher-forced steps
(f32, reduced configs):

* ``llama-rows``: reduced llama3.2-1b at batch 4, each data rank its 2
  rows;
* ``llama-ring``: batch 1 through the long_500k sliding window (cut to 8
  slots, ``sliding_window`` 8), the ring buffer split 4 slots per data
  rank and started from a filled cache at position 6, so that the writes
  wrap from rank 1's rows to rank 0's (slots 6, 7, 0, 1);
* ``llama-seq``: batch 1 against a 16-row cache, 8 rows per data rank;
* ``mamba-rows`` / ``mamba-one`` and ``jamba-rows`` / ``jamba-seq``:
  reduced mamba2-130m and the Jamba hybrid at batch 4 and at batch 1.

Checks, per case: every step's logits within ``RTOL`` (1e-5) of the JAX
step's largest logit, normwise (the port sums the tensor-parallel halves,
the chunks and the ranks' softmax parts in its own order); each rank's
caches within ``RTOL`` of each JAX leaf's largest entry plus ``ATOL``
(1e-6) of the rank's shard of the final JAX caches (the Mamba-2 ``conv`` /
``ssm`` whole over the model ranks), ``pos`` exactly, and the ranks'
caches gathered back (``caches_to_global``) the JAX caches; the tagged
collectives (``"seq"`` only when the cache's sequence is split; no
``"mamba"`` gather in a step, three of each Mamba-2 pattern position's
stacked leaves when the step is built); the prefill of reduced llama3.2-1b (4 x 32) and of the two frontend
models, internvl2-2b and musicgen-large (4 x (16 + 16)), within ``RTOL``.
The CLI runs under ``torchrun`` on four gloo processes and prints its
tokens/s line; a model axis the reduced llama's KV heads do not divide
exits with ROADMAP.md's item named.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_round import ROOT, finish_jax, init_gloo, spawn, start_jax

RTOL, ATOL = 1e-5, 1e-6
WORLD = 4

CASES = [
    {"tag": "llama-rows", "arch": "llama3.2-1b", "kind": "decode", "batch": 4, "len": 16,
     "name": "decode", "steps": 4, "seed": 1},
    {"tag": "llama-ring", "arch": "llama3.2-1b", "kind": "decode", "batch": 1, "len": 16,
     "name": "long_500k", "steps": 4, "seed": 2, "over": {"sliding_window": 8}, "fill": 6},
    {"tag": "llama-seq", "arch": "llama3.2-1b", "kind": "decode", "batch": 1, "len": 16,
     "name": "decode", "steps": 4, "seed": 3},
    {"tag": "mamba-rows", "arch": "mamba2-130m", "kind": "decode", "batch": 4, "len": 16,
     "name": "decode", "steps": 4, "seed": 4},
    {"tag": "mamba-one", "arch": "mamba2-130m", "kind": "decode", "batch": 1, "len": 16,
     "name": "decode", "steps": 4, "seed": 5},
    {"tag": "jamba-rows", "arch": "jamba-v0.1-52b", "kind": "decode", "batch": 4, "len": 16,
     "name": "decode", "steps": 4, "seed": 6},
    {"tag": "jamba-seq", "arch": "jamba-v0.1-52b", "kind": "decode", "batch": 1, "len": 16,
     "name": "decode", "steps": 4, "seed": 7},
    {"tag": "llama-prefill", "arch": "llama3.2-1b", "kind": "prefill", "batch": 4, "seq": 32,
     "seed": 8},
    {"tag": "internvl-prefill", "arch": "internvl2-2b", "kind": "prefill", "batch": 4,
     "seq": 32, "seed": 9},
    {"tag": "musicgen-prefill", "arch": "musicgen-large", "kind": "prefill", "batch": 4,
     "seq": 32, "seed": 10},
]

# Per case: the weights ("{tag}/params/{path}"), the tokens ("{tag}/tokens",
# (B, steps)), the starting caches' leaves ("{tag}/cache0/{i}") or the
# prompt ("{tag}/batch/{key}") into init.npz first; then the JAX serve
# step's logits ("{tag}/logits", (steps, B, 1, V_pad)) and final caches
# ("{tag}/cache/{i}"), or the prefill's logits, into jax.npz.
JAX_SERVE = r"""
import json, os, sys
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.data import make_lm_batch
from repro.launch.serve import build_prefill, build_serve_step, serve_cache_shardings
from repro.launch.sharding_rules import batch_specs, param_specs
from repro.models import init_caches, init_model

cases, tmp = json.loads(sys.argv[1]), sys.argv[2]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
tmap, leaves = jax.tree_util.tree_map, jax.tree_util.tree_leaves


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def cfg_of(c):
    cfg = reduced(get_config(c["arch"]))
    over = dict(c.get("over", {}))
    if "cf" in over:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=over.pop("cf")))
    return replace(cfg, **over)


def place(tree, specs):
    return tmap(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)


init, work = {}, []
for c in cases:
    tag, cfg = c["tag"], cfg_of(c)
    params = init_model(cfg, jax.random.PRNGKey(c["seed"]))
    for p, v in flat(tmap(np.asarray, params)).items():
        init[f"{tag}/params/{p}"] = v
    rng = np.random.default_rng(c["seed"])
    if c["kind"] == "decode":
        shape = ShapeConfig(c["name"], c["len"], c["batch"], "decode")
        shard, _, window = serve_cache_shardings(cfg, mesh, shape)
        caches = init_caches(cfg, c["batch"], c["len"], window=window)
        if c.get("fill") is not None:
            pos, filled = c["fill"], []
            for cache in caches:
                # rows past pos stay empty; positive values keep the sums
                # as well conditioned as a real cache's
                k = rng.standard_normal(cache.k.shape).astype(np.float32)
                v = rng.uniform(0.5, 1.5, cache.v.shape).astype(np.float32)
                k[:, :, pos:], v[:, :, pos:] = 0, 0
                filled.append(type(cache)(k=jnp.asarray(k), v=jnp.asarray(v),
                                          pos=jnp.full(cache.pos.shape, pos, jnp.int32)))
            caches = tuple(filled)
        toks = rng.integers(0, cfg.vocab, (c["batch"], c["steps"])).astype(np.int32)
        init[f"{tag}/tokens"] = toks
        for i, leaf in enumerate(leaves(caches)):
            init[f"{tag}/cache0/{i}"] = np.asarray(leaf)
        work.append((c, cfg, params, shape, tmap(jax.device_put, caches, shard), toks))
    else:
        shape = ShapeConfig("prefill", c["seq"], c["batch"], "prefill")
        batch = make_lm_batch(cfg, shape, c["seed"])
        for k, v in batch.items():
            init[f"{tag}/batch/{k}"] = np.asarray(v)
        work.append((c, cfg, params, shape, batch, None))
np.savez(os.path.join(tmp, "init.tmp.npz"), **init)
os.replace(os.path.join(tmp, "init.tmp.npz"), os.path.join(tmp, "init.npz"))

out = {}
for c, cfg, params, shape, state, toks in work:
    tag = c["tag"]
    params = place(params, param_specs(params, cfg, mesh))
    if c["kind"] == "decode":
        step, caches, logits = build_serve_step(cfg, mesh, shape), state, []
        for i in range(toks.shape[1]):
            lg, caches = step(params, caches, jnp.asarray(toks[:, i:i + 1]))
            logits.append(np.asarray(lg))
        out[f"{tag}/logits"] = np.stack(logits)
        for i, leaf in enumerate(leaves(caches)):
            out[f"{tag}/cache/{i}"] = np.asarray(leaf)
    else:
        batch = place({k: jnp.asarray(v) for k, v in state.items()}, batch_specs(state, mesh))
        out[f"{tag}/logits"] = np.asarray(build_prefill(cfg, mesh, shape)(params, batch))
np.savez(os.path.join(tmp, "jax.npz"), **out)
"""


def cfg_of(c):
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(c["arch"]))
    over = dict(c.get("over", {}))
    if "cf" in over:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=over.pop("cf")))
    return replace(cfg, **over)


def nest(fl):
    out = {}
    for path, v in fl.items():
        d = out
        *head, last = path.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def np_caches(cfg, arrays):
    """The JAX caches' flat leaves as the tuple ``caches_from_jax`` reads."""
    from repro_torch.models.layers import AttnCache
    from repro_torch.models.mamba2 import MambaCache

    kinds = [AttnCache if spec.mixer == "attn" else MambaCache for spec in cfg.pattern]
    return tuple(kind(*arrays[3 * i:3 * i + 3]) for i, kind in enumerate(kinds))


def wait_for(path, timeout=600):
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)


def tagged(stats):
    """``{tag or collective: calls}`` from ``transport.STATS``."""
    return {k[0]: v for k, v in stats.items() if k[1] == "calls"}


def serve_case(c, data, mesh, rank, out, summary):
    """One case on this rank: the logits per step and the final caches (a
    decode), or the prefill's logits, into ``out``; the collectives into
    ``summary``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.convert import caches_shard_from_jax, caches_to_global, params_shard_from_jax
    from repro_torch.core import transport
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.launch.serve import build_prefill, build_serve_step, serve_layout

    tag, cfg = c["tag"], cfg_of(c)
    pre = f"{tag}/params/"
    tree = nest({k[len(pre):]: data[k] for k in data.files if k.startswith(pre)})
    params = params_shard_from_jax(tree, cfg, "cpu", mesh.model, rank % mesh.model)
    if c["kind"] == "decode":
        shape = ShapeConfig(c["name"], c["len"], c["batch"], "decode")
        n = len([k for k in data.files if k.startswith(f"{tag}/cache0/")])
        start = np_caches(cfg, [data[f"{tag}/cache0/{i}"] for i in range(n)])
        caches = caches_shard_from_jax(start, cfg, mesh, rank)
        lay = serve_layout(cfg, shape, mesh)
        transport.STATS.clear()
        step = build_serve_step(cfg, shape, mesh, params=params)
        summary[f"{tag}/build"] = tagged(transport.STATS)
        transport.STATS.clear()
        toks = lay.rows(torch.from_numpy(data[f"{tag}/tokens"]).long())
        logits = []
        for i in range(toks.shape[1]):
            lg, caches = step(params, caches, toks[:, i:i + 1])
            logits.append(lg.clone().numpy())
        summary[f"{tag}/steps"] = tagged(transport.STATS)
        summary[f"{tag}/split"] = lay.data.split if lay.data else None
        out[f"{tag}/logits"] = np.stack(logits)
        for i, t in enumerate(t for cache in caches for t in cache):
            out[f"{tag}/cache/{i}"] = t.numpy()
        whole = caches_to_global(caches, cfg, mesh, mesh_groups(mesh), shape)
        for i, t in enumerate(t for cache in whole for t in cache):
            out[f"{tag}/global/{i}"] = t.numpy()
    else:
        shape = ShapeConfig("prefill", c["seq"], c["batch"], "prefill")
        lay = serve_layout(cfg, shape, mesh)
        batch = {k[len(f"{tag}/batch/"):]: lay.rows(torch.from_numpy(data[k]))
                 for k in data.files if k.startswith(f"{tag}/batch/")}
        out[f"{tag}/logits"] = build_prefill(cfg, shape, mesh, params=params)(params, batch).numpy()


def _rank_main(rank, tmp, cases):
    tmp = Path(tmp)
    init_gloo(rank, WORLD, str(tmp / "store"))
    from repro_torch.launch.mesh import parse_mesh

    mesh = parse_mesh("2x2")
    wait_for(tmp / "init.npz")
    data = np.load(tmp / "init.npz")
    out, summary = {}, {}
    for c in cases:
        serve_case(c, data, mesh, rank, out, summary)
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(summary))
    dist.destroy_process_group()


def run_cases(tmp, cases, rank_main=_rank_main):
    """The JAX subprocess and the 4 gloo ranks over ``cases``: ``(jax
    arrays, init arrays, per-rank arrays, per-rank summaries)``."""
    proc = start_jax(JAX_SERVE, [json.dumps(cases), tmp])
    try:
        spawn(rank_main, WORLD, (str(tmp), cases))
    finally:
        finish_jax(proc)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    summaries = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return dict(np.load(tmp / "jax.npz")), np.load(tmp / "init.npz"), ranks, summaries


def rank_rows(c, split, rank, x):
    """The rows of a global (.., B, ..) array (batch axis 0) a rank holds."""
    if split != "batch":
        return x
    return np.split(x, 2, axis=0)[rank // 2]


def check_logits(c, jax_out, ranks, summaries, rtol=RTOL):
    tag = c["tag"]
    want = jax_out[f"{tag}/logits"]
    errs = []
    for r in range(WORLD):
        got = ranks[r][f"{tag}/logits"]
        if c["kind"] == "decode":
            split = summaries[r][f"{tag}/split"]
            for s in range(c["steps"]):
                w = rank_rows(c, split, r, want[s])
                assert got[s].shape == w.shape, (tag, got[s].shape, w.shape)
                scale = np.abs(want[s]).max()
                errs.append(np.abs(got[s] - w).max() / scale)
        else:
            w = rank_rows(c, "batch", r, want)
            assert got.shape == w.shape
            errs.append(np.abs(got - w).max() / np.abs(want).max())
    assert max(errs) <= rtol, (tag, max(errs))
    return max(errs)


def check_caches(c, jax_out, init, ranks):
    """Each rank's caches against its shard of the final JAX caches."""
    from repro_torch.convert import caches_shard_from_jax
    from repro_torch.launch.mesh import parse_mesh

    tag, cfg = c["tag"], cfg_of(c)
    mesh = parse_mesh("2x2")
    n = len([k for k in init.files if k.startswith(f"{tag}/cache0/")])
    final = np_caches(cfg, [jax_out[f"{tag}/cache/{i}"] for i in range(n)])
    for r in range(WORLD):
        want = [t for cache in caches_shard_from_jax(final, cfg, mesh, r) for t in cache]
        for i, w in enumerate(want):
            got, w = ranks[r][f"{tag}/cache/{i}"], w.numpy()
            assert got.shape == w.shape and got.dtype == w.dtype, (tag, i, got.shape, w.shape)
            if not np.issubdtype(got.dtype, np.floating):
                assert np.array_equal(got, w), (tag, i)
                continue
            scale = RTOL * np.abs(jax_out[f"{tag}/cache/{i}"]).max() + ATOL
            assert np.abs(got - w).max() <= scale, (tag, r, i, np.abs(got - w).max(), scale)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("serve_mesh"), CASES)


DECODES = [c for c in CASES if c["kind"] == "decode"]
PREFILLS = [c for c in CASES if c["kind"] == "prefill"]


@pytest.mark.parametrize("case", DECODES, ids=[c["tag"] for c in DECODES])
def test_decode_logits_match_the_jax_serve_step(runs, case):
    jax_out, _, ranks, summaries = runs
    check_logits(case, jax_out, ranks, summaries)


@pytest.mark.parametrize("case", DECODES, ids=[c["tag"] for c in DECODES])
def test_each_ranks_caches_are_its_shard_of_the_jax_caches(runs, case):
    jax_out, init, ranks, _ = runs
    check_caches(case, jax_out, init, ranks)


@pytest.mark.parametrize("case", DECODES, ids=[c["tag"] for c in DECODES])
def test_gathered_caches_are_the_jax_caches(runs, case):
    """``caches_to_global``: every rank gathers the JAX step's global caches."""
    jax_out, init, ranks, _ = runs
    tag = case["tag"]
    n = len([k for k in init.files if k.startswith(f"{tag}/cache0/")])
    for r in range(WORLD):
        for i in range(n):
            got, want = ranks[r][f"{tag}/global/{i}"], jax_out[f"{tag}/cache/{i}"]
            assert got.shape == want.shape, (tag, i)
            if not np.issubdtype(got.dtype, np.floating):
                assert np.array_equal(got, want)
                continue
            assert np.abs(got - want).max() <= RTOL * np.abs(want).max() + ATOL, (tag, r, i)


@pytest.mark.parametrize("case", PREFILLS, ids=[c["tag"] for c in PREFILLS])
def test_prefill_matches_the_jax_prefill(runs, case):
    jax_out, _, ranks, summaries = runs
    check_logits(case, jax_out, ranks, summaries)


def test_the_data_split_follows_the_cache_specs(runs):
    """Batch 4 splits the rows, batch 1 the attention caches' sequence
    (mamba2-130m at batch 1 has none: every rank holds the batch)."""
    _, _, _, summaries = runs
    want = {"llama-rows": "batch", "llama-ring": "seq", "llama-seq": "seq",
            "mamba-rows": "batch", "mamba-one": None, "jamba-rows": "batch",
            "jamba-seq": "seq"}
    for s in summaries:
        assert {t: s[f"{t}/split"] for t in want} == want


def test_the_tagged_collectives(runs):
    """Per step and attention layer, two ``seq`` all-reduces where the cache's
    sequence is split and none elsewhere; one ``head`` gather per step; no
    ``mamba`` gather in a step, three when the step is built per Mamba-2
    position of the pattern (its stacked leaves gathered whole);
    ``serve_moe`` gathers only where the rows split."""
    from repro_torch.configs import get_config, reduced

    _, _, _, summaries = runs
    for c in DECODES:
        cfg = reduced(get_config(c["arch"]))
        attn = sum(s.mixer == "attn" for s in cfg.pattern) * cfg.n_blocks
        mamba = sum(s.mixer == "mamba" for s in cfg.pattern)
        moe = sum(s.mlp == "moe" for s in cfg.pattern) * cfg.n_blocks
        for s in summaries:
            split, steps, build = (s[f"{c['tag']}/split"], s[f"{c['tag']}/steps"],
                                   s[f"{c['tag']}/build"])
            assert steps.get("seq", 0) == (2 * attn * c["steps"] if split == "seq" else 0)
            assert steps.get("head", 0) == c["steps"]
            assert steps.get("mamba", 0) == 0
            assert build.get("mamba", 0) == 3 * mamba
            assert steps.get("serve_moe", 0) == (moe * c["steps"] if split == "batch" else 0)


def _cli(args, nproc=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    if nproc:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.serve", *args]
    return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout,
                          cwd=str(ROOT))


def test_cli_mesh_2x2_under_torchrun():
    res = _cli(["--arch", "jamba-v0.1-52b", "--reduced", "--device", "cpu", "--mesh", "2x2",
                "--tokens", "3", "--batch", "4", "--cache-len", "16"], nproc=4)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("decoded ")]
    assert len(lines) == 1, res.stdout           # rank 0 alone prints it
    assert lines[0].startswith("decoded 3 tokens x 4 seqs in ")
    assert lines[0].endswith("on --mesh 2x2 (data, model)") and "tok/s" in lines[0]


def test_cli_refuses_undivided_kv_heads_naming_the_item():
    """The reduced llama's 2 KV heads on a model axis of 4: the JAX rules
    would split ``Dh``; the CLI refuses before it starts any rank."""
    res = _cli(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "1x4"])
    assert res.returncode != 0
    assert "ROADMAP.md queue 1 item 12(g)" in res.stderr, res.stderr[-2000:]
