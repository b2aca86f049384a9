"""The port's trainers resume bit for bit from a checkpoint under the
curated grouped policy, VR with a ``diana`` downlink, adamw, an elastic run
whose resumed step is a churn join, and in a world of one (a one-rank gloo
group in this process), as ``tests/test_torch_checkpoint_resume.py`` holds
the five operators; and the CLI's ``--checkpoint-dir`` writes the JAX
trainer's manifest (its keys and dtypes, and its metadata: the policy and
the controller's state).
"""

import contextlib
import io
import json
import os
from dataclasses import replace

import jax
import pytest
import torch.distributed as dist

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import BudgetController as JController
from repro.core import controller_metadata as j_controller_metadata
from repro.core import init_controller_state as j_init_controller_state
from repro.core.participation import ParticipationSpec as JSpec
from repro.core.policy import CompressionPolicy as JPolicy
from repro.launch.train import make_optimizer as j_make_optimizer
from repro.models import init_model as j_init_model
from repro_torch.checkpoint import (controller_restore_hint, load_metadata,
                                    participation_restore_hint, restore_checkpoint)
from repro_torch.configs import get_config, reduced
from repro_torch.core.controller import BudgetController
from repro_torch.core.participation import ChurnEvent, ParticipationSpec
from repro_torch.launch import train
from repro_torch.models.transformer import init_model
from test_torch_checkpoint_resume import N, _config, _one_torch_thread, _resume_bitwise

__all__ = ["_one_torch_thread"]   # the autouse fixture, imported to apply here


@pytest.mark.parametrize("case", ["policy", "vr-down", "adamw", "elastic"])
def test_resume_bitwise_variants(tmp_path, case):
    """The curated grouped policy; VR with a diana downlink; adamw (its
    ``count``); an elastic run (worker 1 leaves at step 1 and rejoins at
    step 3, the resumed step, whose mask is keyed by the restored step
    counter)."""
    cfg, kw = _config(), {}
    if case == "policy":
        kw["policy"] = "default"
    elif case == "vr-down":
        cfg = _config(vr=True, vr_p=0.5, comp_down_method="diana")
    elif case == "adamw":
        kw["inner"] = "adamw"
    else:
        kw["participation"] = ParticipationSpec(
            q=0.7, dropout=0.1, min_workers=1,
            churn=(ChurnEvent(1, 1, "leave"), ChurnEvent(3, 1, "join")))
    opt = train.make_optimizer(cfg, **kw)
    state = _resume_bitwise(tmp_path, cfg, opt,
                            lambda: train.build_train_step(cfg, opt, N, "cpu"), N)
    if case == "policy":
        assert sorted(state.diana.h_worker) == ["g00_identity", "g01_topk_ef", "g02_ternary"]
    elif case == "vr-down":
        assert state.diana.vr is not None and state.diana.h_down is not None
    elif case == "adamw":
        assert state.inner.count == 4


@pytest.fixture(scope="module")
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["diana", "vr-down"])
def test_resume_bitwise_world_of_one(tmp_path, world_of_one, case):
    cfg = _config() if case == "diana" else _config(vr=True, vr_p=0.5,
                                                    comp_down_method="diana")
    opt = train.make_optimizer(cfg)
    _resume_bitwise(tmp_path, cfg, opt, lambda: train.build_distributed_step(cfg, opt), 1)


# ------------------------------------------------------------ --checkpoint-dir


def _cli(*flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "2x1",
                    "--steps", "2", "--batch", "4", "--seq", "16", *flags])
    return buf.getvalue()


def _jax_params_manifest(jcfg):
    shapes = jax.eval_shape(lambda: j_init_model(jcfg, jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path({"params": shapes})[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): str(leaf.dtype)
            for path, leaf in flat}


@pytest.mark.parametrize("flags", [(), ("--comp-policy", "default", "--per-leaf-agg"),
                                   ("--participation-q", "0.5", "--min-workers", "1")],
                         ids=["flat", "policy", "elastic"])
def test_cli_checkpoint_dir_writes_the_jax_manifest(tmp_path, monkeypatch, flags):
    """The manifest's step, keys, dtypes and file are the JAX trainer's for
    the same arch (read from ``jax.eval_shape`` of its ``init_model``), and
    its metadata is the JAX trainer's ``{"policy": opt.policy.to_json_dict()}``
    for the same flags (the JAX-only ``worker_axes`` aside); the saved
    parameters restore, and the participation hint is silent."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    d = str(tmp_path / "ck")
    out = _cli(*flags, "--checkpoint-dir", d)
    assert f"checkpoint written to {d}" in out
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    jcfg = j_reduced(j_get_config("llama3.2-1b"))
    want = _jax_params_manifest(jcfg)
    assert manifest["step"] == 2 and manifest["file"] == "ckpt_00000002.npz"
    assert manifest["keys"] == sorted(want) and manifest["dtypes"] == want
    jkw = {}
    if "--comp-policy" in flags:
        jcfg = replace(jcfg, comp_bucketed=False)
        jkw["policy"] = "default"
    if "--participation-q" in flags:
        jkw["participation"] = JSpec(q=0.5, min_workers=1)
    jdoc = j_make_optimizer(jcfg, **jkw).policy.to_json_dict()
    jdoc.pop("worker_axes")
    assert manifest["metadata"] == {"policy": jdoc}
    pol = train.make_optimizer(reduced(get_config("llama3.2-1b")),
                               **({"policy": "default"} if jkw.get("policy") else {}),
                               **({"participation": ParticipationSpec(q=0.5, min_workers=1)}
                                  if "participation" in jkw else {}))
    assert participation_restore_hint(d, pol.policy) is None
    tree, step = restore_checkpoint(d, {"params": init_model(reduced(get_config("llama3.2-1b")),
                                                              "cpu", seed=3)})
    assert step == 2 and sorted(tree["params"]) == sorted(k[len("params/"):] for k in want)


def test_cli_checkpoint_dir_with_the_controller(tmp_path, monkeypatch):
    """With the budget controller the metadata also carries its state, with
    the JAX package's ``controller_metadata`` keys; the policy document
    parses in the JAX package; the controller hint is silent for the same
    budget."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    d = str(tmp_path / "ck")
    _cli("--comp-policy", "default", "--budget-bits-per-dim", "1.0",
         "--controller-interval", "1", "--warmup-dense-steps", "1", "--checkpoint-dir", d)
    meta = load_metadata(d)
    jpol = j_make_optimizer(j_reduced(j_get_config("llama3.2-1b")), policy="default").policy
    jctl = JController(base=jpol, budget_bits_per_dim=1.0, interval=1, warmup_dense_steps=1)
    jmeta = j_controller_metadata(jctl, j_init_controller_state(
        jctl, j_init_model(j_reduced(j_get_config("llama3.2-1b")), jax.random.PRNGKey(0))))
    assert sorted(meta["controller"]) == sorted(jmeta)
    assert meta["controller"]["step"] == 2 and meta["controller"]["budget_bits_per_dim"] == 1.0
    assert isinstance(JPolicy.from_json_dict(meta["policy"]), JPolicy)
    base = train.make_optimizer(reduced(get_config("llama3.2-1b")), policy="default").policy
    assert controller_restore_hint(d, BudgetController(base=base, budget_bits_per_dim=1.0,
                                                       interval=1)) is None
    assert controller_restore_hint(d, None) is not None
    assert meta["controller"]["interval"] == 1
