"""The Jamba hybrid over the model axis: reduced jamba-v0.1-52b's ``--mesh
2x2`` trainer against the JAX package's ``build_train_step`` on an Auto-axis
``(2, 2)`` host mesh, with ``tests/test_torch_mesh_families.py``'s JAX script
and checks on batch 4 x 64 (the reduced SSD chunk is 64), per leaf, lr 3e-4.

One pattern period of 8 layers runs under one model group: the attention
(position 3) tensor-parallel, the seven Mamba-2 mixers each gathering the
JAX shards of its ``in_proj``, ``conv_w`` and ``out_proj``, the dense MLPs
tensor-parallel and the four expert-partitioned MoE layers (4 experts, 2 a
rank) on the JAX nested path.  The DIANA memories are bf16 (``h_dtype``).
The JAX side sets ``comp_worker_axes=("pod", "data")``: the config's
``("pod",)`` leaves a ``(data, model)`` mesh with no worker axis.

* every rank's initial shards are the bits of the JAX trainer's shards on
  its devices;
* ``none`` with ``sgd``: the losses, ``ghat_norm`` and every parameter shard
  within ``SSM_NORMWISE`` (1e-4 of the array's largest entry plus atol
  1e-6, ``tests/test_torch_model_families.py``'s bound for the Mamba-2
  archs);
* ``diana`` with momentum: each round bitwise the JAX nested round fed the
  port's gradient shards (the bf16 memories too), the losses within
  ``SSM_NORMWISE``, the parameters within the flip bound (its share of
  flipped coordinates ten times the dense families', ``SSM_FLIPS``: the
  gradients may differ ten times as much; 1.6e-5 of them flip here);
* ``gather_train_state`` -> ``shard_train_state`` bitwise.
"""

import pytest

from test_torch_mesh_families import (check_diana_flip_bound, check_diana_rounds,
                                      check_jax_shards, check_none_sgd, check_round_trip,
                                      SSM_FLIPS, run_families, ssm_close)

ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(tmp_path_factory.mktemp("mesh_hybrid"), (ARCH,), seq=64)


def test_initial_shards_are_the_jax_shards(runs):
    check_jax_shards(runs, ARCH)


def test_none_sgd_matches_the_jax_trainer(runs):
    check_none_sgd(runs, ARCH, close=ssm_close)


def test_diana_rounds_bitwise_the_jax_round_on_the_ports_gradients(runs):
    check_diana_rounds(runs, ARCH)


def test_diana_losses_and_parameters_within_the_flip_bound(runs):
    check_diana_flip_bound(runs, ARCH, close=ssm_close, flips=SSM_FLIPS)


def test_gathered_state_shards_back_bitwise(runs):
    check_round_trip(runs, ARCH)
