"""The port's ``--mesh 2x2`` trainer on the frontend models, reduced
internvl2-2b (vision) and musicgen-large (audio), against the JAX
package's ``build_train_step`` on an Auto-axis ``(2, 2)`` host mesh: the
frontend projection's ``w`` column-parallel (its D columns gathered before
the replicated bias), the rest as the dense transformers.  The JAX script
and the checks are ``tests/test_torch_mesh_families.py``'s: ``none`` /
``sgd`` within rtol 1e-5 / atol 1e-6, ``diana`` rounds bitwise the JAX
round on the port's gradient shards, its parameters within the flip bound,
and ``gather_train_state`` -> ``shard_train_state`` bitwise.
"""

import pytest

from test_torch_mesh_families import (check_diana_flip_bound, check_diana_rounds,
                                      check_jax_shards, check_none_sgd, check_round_trip,
                                      run_families)

ARCHS = ("internvl2-2b", "musicgen-large")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(tmp_path_factory.mktemp("mesh_frontends"), ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_initial_shards_are_the_jax_shards(runs, arch):
    check_jax_shards(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_none_sgd_matches_the_jax_trainer(runs, arch):
    check_none_sgd(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_diana_rounds_bitwise_the_jax_round_on_the_ports_gradients(runs, arch):
    check_diana_rounds(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_diana_losses_and_parameters_within_the_flip_bound(runs, arch):
    check_diana_flip_bound(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_state_shards_back_bitwise(runs, arch):
    check_round_trip(runs, arch)
