"""The port's ``--mesh 2x1`` trainers against the JAX package's
``build_train_step`` on an Auto-axis ``(2, 1)`` host mesh, per leaf: the
checks of ``tests/test_torch_mesh_workers.py`` (which holds the bucketed
layout and states them), on ``--per-leaf-agg``'s layout, whose JAX round is
the nested per-leaf one over a model axis of 1.
"""

import pytest

from test_torch_mesh_workers import (check_diana_flip_bound, check_diana_rounds,
                                     check_none_sgd, run_layout)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_layout(tmp_path_factory.mktemp("mesh_workers_perleaf"), "perleaf")


def test_none_sgd_both_trainers_match_the_jax_trainer(runs):
    check_none_sgd(runs, "perleaf")


def test_diana_rounds_bitwise_the_jax_round_and_in_turn(runs):
    check_diana_rounds(runs, "perleaf")


def test_diana_parameters_within_the_flip_bound(runs):
    check_diana_flip_bound(runs, "perleaf")
