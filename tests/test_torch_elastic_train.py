"""The elastic trainers on the CPU: ``--participation-q``,
``--participation-dropout``, ``--min-workers`` and ``--faults``.

* The in-turn trainer (``build_train_step``) against the port's
  ``reference_step`` with the same spec, fault plan and step counter on the
  same gradients (that round is held to the JAX package's in
  ``tests/test_torch_elastic_reference.py``): 3 steps at n = 4, every
  operator, bucketed with a corrupted wire (per leaf in
  ``tests/test_torch_elastic_perleaf.py``); the memories and ghat bit for
  bit.  The knobs q = 0.6, dropout 0.1, ``min_workers`` 3 give
  the trainer's keys ``fold_in(PRNGKey(0), s)`` the masks 1011, 1111 (the
  corrupt on worker 0), then 0101: a non-participant, a checksum exclusion
  and a degraded step.
* VR with a downlink, and a grouped policy, the same way.
* A world of one (a one-rank gloo group in this process) with participation
  and a corrupted wire, bit for bit the in-turn trainer at n = 1.
* The CLI's flags train, and ``--faults`` refuses the per-leaf layout.

The model is reduced llama3.2-1b narrowed to d_model 64, so that the plain
versions of the encodes keep the file inside a minute; torch runs one
thread.
"""

import contextlib
import io
import math
from dataclasses import replace

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import prng
from repro_torch.core.diana import reference_init, reference_step
from repro_torch.core.participation import ParticipationSpec, parse_faults
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import train
from repro_torch.models.transformer import init_model, train_loss

N = 4
STEPS = 3
SHAPE = ShapeConfig("t", 16, 4, "train")
METHODS = ("diana", "natural", "randk", "topk_ef", "none")
SPEC = ParticipationSpec(q=0.6, dropout=0.1, min_workers=3)
MASKS = [([True, False, True, True], True), ([True] * 4, True),
         ([False, True, False, True], False)]
FAULTS = "corrupt:step=1,worker=0"
MIXED = ("scale$=identity,^embed$|^lm_head$=topk_ef:k=256:layout=perleaf/diana:block=256,"
         "*=diana/topk_ef:k=64")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**over):
    return replace(reduced(get_config("llama3.2-1b")), d_model=64, n_heads=2, n_kv_heads=1,
                   head_dim=32, d_ff=128, **over)


def _batch(cfg, s, shape=SHAPE):
    return {k: torch.from_numpy(v) for k, v in make_lm_batch(cfg, shape, s).items()}


def _per_worker_grads(cfg, params, batch, n=N):
    paths = sorted(params)
    rows = batch["tokens"].shape[0] // n
    per_worker = [torch.autograd.grad(
        train_loss(params, {k: v[w * rows:(w + 1) * rows] for k, v in batch.items()}, cfg),
        [params[p] for p in paths]) for w in range(n)]
    return {p: torch.stack([g[i] for g in per_worker]) for i, p in enumerate(paths)}


def _same_state(a, b):
    if b is None:
        return a is None
    if isinstance(b, dict):
        return sorted(a) == sorted(b) and all(_same_state(a[k], b[k]) for k in b)
    if isinstance(b, list):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _against_reference(cfg, opt, faults, vr_aux=False):
    """``STEPS`` in-turn steps against ``reference_step`` on the same
    gradients; returns the per-step metrics."""
    params = init_model(cfg, "cpu", seed=1)
    state = opt.init(params, N)
    step_fn = train.build_train_step(cfg, opt, N, "cpu", faults)
    ref = reference_init({p: v.detach() for p, v in params.items()}, opt.policy, N)
    mets = []
    for s in range(STEPS):
        batch = _batch(cfg, s)
        key = prng.fold_in(prng.PRNGKey(0), s)
        grads = _per_worker_grads(cfg, params, batch)
        kw = {}
        if vr_aux:
            gsnap = dict(zip(sorted(params), _snap_grads(cfg, ref.vr.snapshot, batch)))
            kw = dict(vr_aux=(gsnap, grads), params={p: v.detach() for p, v in params.items()},
                      vr_force_refresh=s == 0)
        ghat, ref = reference_step(grads, ref, key, opt.policy, step=s, faults=faults, **kw)
        params, state, met = step_fn(params, state, batch, key)
        for name in ("h_worker", "h_server", "h_down"):
            assert _same_state(getattr(state.diana, name), getattr(ref, name)), (s, name)
        if vr_aux:
            assert _same_state(state.diana.vr.snapshot, ref.vr.snapshot), s
            assert _same_state(state.diana.vr.mu, ref.vr.mu), s
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in ghat.values()))
        assert torch.equal(met["ghat_norm"], norm), s
        mets.append(met)
    return mets


def _snap_grads(cfg, snapshot, batch):
    """Each worker's gradient at its snapshot on its rows of the batch."""
    rows = batch["tokens"].shape[0] // N
    out = []
    paths = sorted(snapshot)
    per = []
    for w in range(N):
        snap = {p: snapshot[p][w].clone().requires_grad_() for p in paths}
        wb = {k: v[w * rows:(w + 1) * rows] for k, v in batch.items()}
        per.append(torch.autograd.grad(train_loss(snap, wb, cfg), [snap[p] for p in paths]))
    for i in range(len(paths)):
        out.append(torch.stack([g[i] for g in per]))
    return out


@pytest.mark.parametrize("method", METHODS)
def test_elastic_trainer_equals_reference_step(method):
    """Bucketed, with the corrupted wire (``tests/test_torch_elastic_perleaf.py``
    runs this per leaf, without faults)."""
    cfg = _config(compression=method, comp_k=512)
    opt = train.make_optimizer(cfg, lr=3e-4, participation=SPEC)
    assert opt.compression.bucketed
    mets = _against_reference(cfg, opt, parse_faults(FAULTS))
    assert [(m["mask"], m["ok"]) for m in mets] == MASKS
    assert [m["valid"] for m in mets] == [[True] * 4, [False, True, True, True], [True] * 4]
    assert float(mets[2]["ghat_norm"]) == 0.0   # the degraded step


def test_elastic_vr_downlink_trainer_equals_reference_step():
    cfg = _config(vr=True, vr_p=0.5, comp_down_method="topk_ef", comp_down_k=256)
    opt = train.make_optimizer(cfg, lr=3e-4, participation=SPEC)
    _against_reference(cfg, opt, parse_faults(FAULTS), vr_aux=True)


@pytest.mark.parametrize("policy", ["default", MIXED], ids=["curated", "mixed"])
def test_elastic_grouped_trainer_equals_reference_step(policy):
    """llama3.2-1b's curated policy and a mixed one with a per-leaf group
    and downlinks: one mask for every group, identity summed from the
    masked rows."""
    cfg = _config()
    opt = train.make_optimizer(cfg, lr=3e-4, policy=policy, participation=SPEC)
    assert opt.policy.participation == SPEC and not opt.policy.is_uniform
    _against_reference(cfg, opt, None)
    with pytest.raises(ValueError, match="bucketed"):
        train.build_train_step(cfg, opt, N, "cpu", parse_faults("checksum"))


@pytest.fixture(scope="module")
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("method", ["diana", "none"])
def test_world_of_one_elastic_bitwise_in_turn(world_of_one, method):
    """The wire crosses the all-gather: a corrupt on worker 0 at step 1
    excludes the only payload (scale 1/max(0, 1)), at world 1 as in turn."""
    cfg = _config(compression=method)
    opt = train.make_optimizer(cfg, lr=3e-4, participation=ParticipationSpec(q=0.6,
                                                                             dropout=0.1))
    faults = parse_faults(FAULTS)
    shape = ShapeConfig("t", 16, 2, "train")
    runs = []
    for build in (lambda: train.build_train_step(cfg, opt, 1, "cpu", faults),
                  lambda: train.build_distributed_step(cfg, opt, faults)):
        params = init_model(cfg, "cpu", seed=1)
        state, step_fn, losses = opt.init(params, 1), build(), []
        for s in range(2):
            params, state, met = step_fn(params, state, _batch(cfg, s, shape),
                                         prng.fold_in(prng.PRNGKey(0), s))
            losses.append(met["loss"])
        runs.append((losses, params, state))
    (t_loss, t_params, t_state), (d_loss, d_params, d_state) = runs
    assert all(torch.equal(a, b) for a, b in zip(d_loss, t_loss))
    assert all(torch.equal(d_params[p], t_params[p]) for p in t_params)
    for name in ("h_worker", "h_server"):
        assert _same_state(getattr(d_state.diana, name), getattr(t_state.diana, name)), name


def _cli(*flags):
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "4x1",
            "--steps", "2", "--batch", "4", "--seq", "16", *flags]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    lines = [l for l in buf.getvalue().splitlines() if l.startswith("step")]
    assert len(lines) == 2 and all(math.isfinite(float(l.split()[3])) for l in lines)
    return lines


def test_cli_elastic_flags(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    lines = _cli("--compression", "none", "--participation-q", "0.6",
                 "--participation-dropout", "0.1", "--min-workers", "3", "--faults", FAULTS)
    assert "mask [True, False, True, True] ok True" in lines[0]
    assert "valid [False, True, True, True]" in lines[1]
    with pytest.raises(SystemExit):
        _cli("--faults", "checksum", "--per-leaf-agg")
    with pytest.raises(SystemExit):
        _cli("--faults", "drop:step=1,worker=0", "--comp-policy", "default")
