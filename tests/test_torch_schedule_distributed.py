"""The wire schedule's ``torch.distributed`` round on 4 gloo ranks of CPU
processes, against the JAX package's ``aggregate_shardmap`` in a ``(4, 1)``
host mesh (a JAX subprocess, as in ``tests/test_torch_distributed.py``;
driven as ``tests/test_schedule.py:569-605`` drives it), on the 1/64 grid
and the tree of ``tests/test_torch_schedule.py`` (``chunk_bytes`` 300: at
least three uneven chunks):

* the chunked round, all five operators, two rounds: ghat, every rank's
  ``h_worker`` row and ``h_server`` bit for bit;
* the hierarchical round (``node_size`` 2, the key folded with the rank's
  node), chunked and not, ``diana`` and ``randk``: the same, and the two
  ranks of a node hold the same row;
* the chunked round under participation (q 0.7, dropout 0.2, a churn leave
  and join, ``min_workers`` 2) with a fault plan (a corrupt in the middle of
  the second chunk of rank 1, a drop of rank 2), three rounds from
  ``PRNGKey(8)``, all five operators: bit for bit, each chunk its own
  checksummed wire;
* the issue order, recorded by wrapping ``dist.all_gather_into_tensor`` and
  the chunk decodes: chunk ``c+1``'s gather is issued before chunk ``c``'s
  ``decode_sum_apply``, and under participation every chunk's gather before
  any decode.
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
import torch.multiprocessing as mp

from repro_torch.core import prng
from repro_torch.core.bucket import BucketedCompressor, ChunkedSchedule
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.diana import PART_FOLD, aggregate_distributed, bucket_layout, init_state
from repro_torch.core.participation import ChurnEvent, FaultEvent, FaultPlan, ParticipationSpec

ROOT = Path(__file__).resolve().parents[1]
N = 4
CHUNK = 300
SEED = 8
SHAPES = {"emb": (24, 16), "w1": (20, 13), "b1": (160,), "w2": (9, 31), "b2": (70,), "s": ()}
CASES = {"diana": dict(block_size=16), "natural": {}, "randk": dict(k=9), "topk_ef": dict(k=9),
         "none": {}}
HIER = ("diana", "randk")
SPEC = dict(q=0.7, dropout=0.2, churn=((1, 3, "leave"), (3, 3, "join")), min_workers=2)
ROUNDS = {"chunked": 2, "hier": 2, "elastic": 3}


def _faults(byte):
    return (dict(step=0, worker=1, kind="corrupt", byte=byte), dict(step=2, worker=2, kind="drop"))


JAX_SCRIPT = """
import sys, math
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import (ChurnEvent, CompressionConfig, DianaState, FaultEvent, FaultPlan,
                        ParticipationSpec, aggregate_shardmap, init_state)
from repro.core.diana import PART_FOLD
from repro.launch.mesh import make_mesh

CASES, HIER, SPEC, FAULTS, ROUNDS = %(cases)r, %(hier)r, %(spec)r, %(faults)r, %(rounds)r
data = np.load(sys.argv[1])
mesh = make_mesh((4, 1), ("data", "model"))
n, tmap = 4, jax.tree_util.tree_map
key = jax.random.PRNGKey(%(seed)d)
shapes = %(shapes)r
params = {p: jnp.zeros(s) for p, s in shapes.items()}
spec = ParticipationSpec(**{**SPEC, "churn": tuple(ChurnEvent(*c) for c in SPEC["churn"])})
plan = FaultPlan(tuple(FaultEvent(**e) for e in FAULTS))
sh = lambda t: tmap(lambda _: P("data"), t)
rep = lambda t: tmap(lambda _: P(), t)
out = {}

def save(prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            save(f"{prefix}/{k}", v)
    else:
        out[prefix] = np.asarray(t)

def round_fn(cfg, st, node_size=1, elastic=False):
    def body(g_st, h_w, h_s, k, step):
        widx = jax.lax.axis_index("data")
        kw = {}
        if elastic:
            kw = dict(part_key=jax.random.fold_in(k, PART_FOLD), step=step, worker_index=widx,
                      faults=plan)
        ghat, ns = aggregate_shardmap(
            tmap(lambda x: x[0], g_st), DianaState(h_w, h_s),
            jax.random.fold_in(k, widx // node_size), cfg, axis_names=("data",),
            n_workers=n, **kw)
        return ghat, ns.h_worker, ns.h_server
    return shard_map(body, mesh=mesh,
        in_specs=(sh(params), sh(st.h_worker), rep(st.h_server), P(), P()),
        out_specs=(rep(params), sh(st.h_worker), rep(st.h_server)),
        axis_names={"data"}, check_vma=False)

def run(tag, cfg, rounds, node_size=1, elastic=False):
    st = init_state(params, cfg, n)
    hw, hs = st.h_worker, st.h_server
    f = jax.jit(round_fn(cfg, st, node_size, elastic))
    for r in range(rounds):
        g = {p: jnp.asarray(data[f"{p}{r}"]) for p in shapes}
        ghat, hw, hs = f(g, hw, hs, jax.random.fold_in(key, r), jnp.int32(r))
        for name, t in (("ghat", ghat), ("hw", hw), ("hs", hs)):
            save(f"{tag}/{r}/{name}", t)

for method, kw in CASES.items():
    base = dict(method=method, p=math.inf, bucketed=True, use_kernel=False, chunk_bytes=%(chunk)d)
    run(f"chunked/{method}", CompressionConfig(**base, **kw), ROUNDS["chunked"])
    run(f"elastic/{method}", CompressionConfig(**base, participation=spec, **kw),
        ROUNDS["elastic"], elastic=True)
    if method in HIER:
        for cb in (0, %(chunk)d):
            cfg = CompressionConfig(**{**base, "chunk_bytes": cb}, topology="hierarchical",
                                    node_size=2, **kw)
            run(f"hier{cb}/{method}", cfg, ROUNDS["hier"], node_size=2)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(21)
    return {f"{p}{r}": (np.round(rng.standard_normal((N, *s)) * 64) / 64).astype(np.float32)
            for r in range(max(ROUNDS.values())) for p, s in SHAPES.items()}


def _mid_second_chunk():
    """A body byte in the middle of the second chunk of diana's wire (one
    byte address for every operator: where it lands differs, the outcome is
    compared)."""
    from repro_torch.core.bucket import fuse_payload
    from repro_torch.core.diana import _chunk_payloads
    cfg = CompressionConfig(method="diana", block_size=16, bucketed=True, chunk_bytes=CHUNK)
    lay = bucket_layout(cfg, {p: torch.zeros(s) for p, s in SHAPES.items()})
    pays = _chunk_payloads(cfg, ChunkedSchedule.for_layout(lay, CHUNK),
                           torch.zeros(lay.padded_size), prng.PRNGKey(0))
    sizes = [fuse_payload(p).numel() for p in pays]
    return sizes[0] + sizes[1] // 2


class _Order:
    """Records the issue order of the round's gathers and decodes, by
    wrapping ``dist.all_gather_into_tensor`` and the chunk decodes."""

    def __init__(self):
        self.events, self._orig = [], {}

    def __enter__(self):
        targets = [(dist, "all_gather_into_tensor", "gather"),
                   (BucketedCompressor, "decode_sum_apply", "decode"),
                   (BucketedCompressor, "decode_sum", "decode")]
        for obj, name, tag in targets:
            orig = getattr(obj, name)
            self._orig[(obj, name)] = orig

            def wrapped(*a, _orig=orig, _tag=tag, **kw):
                self.events.append(_tag + ("_async" if kw.get("async_op") else ""))
                return _orig(*a, **kw)
            setattr(obj, name, wrapped)
        return self

    def __exit__(self, *exc):
        for (obj, name), orig in self._orig.items():
            setattr(obj, name, orig)


def _save(out, prefix, t):
    if isinstance(t, dict):
        for k, v in t.items():
            _save(out, f"{prefix}/{k}", v)
    else:
        out[prefix] = t.detach().numpy()


def _rank_main(rank, tmp, store, byte):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, N), rank=rank, world_size=N)
    tmp = Path(tmp)
    data = np.load(tmp / "inputs.npz")
    params = {p: torch.zeros(s) for p, s in SHAPES.items()}
    spec = ParticipationSpec(**{**SPEC, "churn": tuple(ChurnEvent(*c) for c in SPEC["churn"])})
    plan = FaultPlan(tuple(FaultEvent(**e) for e in _faults(byte)))
    out, order = {}, {}

    def run(tag, cfg, rounds, node_size=1, elastic=False):
        st = init_state(params, cfg, 1)
        for r in range(rounds):
            k = prng.fold_in(prng.PRNGKey(SEED), r)
            g = {p: torch.from_numpy(np.array(data[f"{p}{r}"][rank])) for p in SHAPES}
            kw = dict(part_key=prng.fold_in(k, PART_FOLD), step=r, faults=plan) if elastic else {}
            with _Order() as rec:
                ghat, st = aggregate_distributed(g, st, prng.fold_in(k, rank // node_size), cfg,
                                                 **kw)
            order[f"{tag}/{r}"] = rec.events
            for name, t in (("ghat", ghat), ("hw", st.h_worker), ("hs", st.h_server)):
                _save(out, f"{tag}/{r}/{name}", t)

    for method, kw in CASES.items():
        base = dict(method=method, bucketed=True, chunk_bytes=CHUNK)
        run(f"chunked/{method}", CompressionConfig(**base, **kw), ROUNDS["chunked"])
        run(f"elastic/{method}", CompressionConfig(**base, participation=spec, **kw),
            ROUNDS["elastic"], elastic=True)
        if method in HIER:
            for cb in (0, CHUNK):
                cfg = CompressionConfig(**{**base, "chunk_bytes": cb}, topology="hierarchical",
                                        node_size=2, **kw)
                run(f"hier{cb}/{method}", cfg, ROUNDS["hier"], node_size=2)
    np.savez(tmp / f"rank{rank}.npz", **out)
    (tmp / f"rank{rank}.json").write_text(json.dumps(order))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("schedule_dist")
    np.savez(tmp / "inputs.npz", **_inputs())
    byte = _mid_second_chunk()
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT % dict(cases=CASES, hier=HIER, spec=SPEC, faults=_faults(byte),
                               rounds=ROUNDS, seed=SEED, shapes=SHAPES, chunk=CHUNK)
    jproc = subprocess.Popen([sys.executable, "-c", script, str(tmp / "inputs.npz"),
                              str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        ctx = mp.start_processes(_rank_main, args=(str(tmp), str(tmp / "store"), byte),
                                 nprocs=N, join=False, start_method="spawn")
        deadline = time.monotonic() + 400
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError("the gloo ranks did not finish in 400 s")
    finally:
        jout, jerr = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, f"stdout:\n{jout}\nstderr:\n{jerr[-3000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]
    orders = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(N)]
    return dict(np.load(tmp / "jax.npz")), ranks, orders


def _check(jax_out, ranks, prefix):
    keys = [k for k in jax_out if k.startswith(prefix + "/")]
    assert keys, prefix
    for k in keys:
        name = k.split("/")[3]
        for rank in range(N):
            got = ranks[rank][k]
            want = jax_out[k][rank:rank + 1] if name == "hw" else jax_out[k]
            assert got.dtype == want.dtype and got.shape == want.shape, (k, rank)
            assert got.tobytes() == want.tobytes(), (k, rank, float(np.abs(got - want).max()))


def _n_chunks(method):
    cfg = CompressionConfig(method=method, bucketed=True, **CASES[method])
    return ChunkedSchedule.for_layout(
        bucket_layout(cfg, {p: torch.zeros(s) for p, s in SHAPES.items()}), CHUNK).n_chunks


@pytest.mark.parametrize("method", list(CASES))
def test_chunked_round_bitwise_aggregate_shardmap(runs, method):
    jax_out, ranks, _ = runs
    assert _n_chunks(method) >= 3
    _check(jax_out, ranks, f"chunked/{method}")


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["mono", "chunked"])
@pytest.mark.parametrize("method", HIER)
def test_hierarchical_round_bitwise_aggregate_shardmap(runs, method, chunk):
    jax_out, ranks, _ = runs
    _check(jax_out, ranks, f"hier{chunk}/{method}")
    for r in range(ROUNDS["hier"]):
        rows = [ranks[rank][f"hier{chunk}/{method}/{r}/hw"] for rank in range(N)]
        assert np.array_equal(rows[0], rows[1]) and np.array_equal(rows[2], rows[3])


@pytest.mark.parametrize("method", list(CASES))
def test_chunked_elastic_faults_round_bitwise_aggregate_shardmap(runs, method):
    jax_out, ranks, _ = runs
    _check(jax_out, ranks, f"elastic/{method}")


@pytest.mark.parametrize("method", list(CASES))
def test_chunk_gather_issued_before_previous_decode(runs, method):
    """Chunk c+1's (async) all-gather is issued before chunk c's decode:
    gather 0, gather 1, decode 0, gather 2, decode 1, ...; under
    participation every chunk's gather comes before any decode.  The
    hierarchical round adds its intra-node gather first (in place: the round
    needs its result before it encodes).  (``none`` without
    participation is one all-reduce, as in the JAX package: no gather.)"""
    _, _, orders = runs
    c = _n_chunks(method)
    piped = ["gather_async", "gather_async"]
    for i in range(c - 1):
        piped += ["decode"] + (["gather_async"] if i + 2 < c else [])
    piped += ["decode"]
    for order in orders:
        for r in range(ROUNDS["chunked"]):
            want = [] if method == "none" else piped
            assert order[f"chunked/{method}/{r}"] == want, order[f"chunked/{method}/{r}"]
        for r in range(ROUNDS["elastic"]):
            assert order[f"elastic/{method}/{r}"] == ["gather_async"] * c + ["decode"] * c
        if method in HIER:
            for r in range(ROUNDS["hier"]):
                assert order[f"hier{CHUNK}/{method}/{r}"] == ["gather"] + piped
