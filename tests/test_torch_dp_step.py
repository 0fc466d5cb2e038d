"""One data-parallel fp32 train step (two gloo ranks) of the flagship_word losses
(``df_gan_damsm.yml`` with WORD, B_GLOBAL and SPEC_NORM, MAGP and RMIS on)
against the JAX package's single-device step, against each other and
against the port's one-process step (``tests/torch_dp_step_parity.py``:
the sizes, the weights and the tolerances): the word scores as row blocks,
the RMIS pair across the rank boundary."""

import pytest

from torch_dp_step_parity import (
    check_dp_vs_jax_metrics,
    check_dp_vs_jax_params,
    check_dp_vs_one_process,
    check_replicas_bit_equal,
    run_dp_step,
)
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def run(one_torch_thread, tmp_path_factory):
    return run_dp_step("flagship_word", tmp_path_factory.mktemp("dp_flagship_word"))


def test_dp_step_metrics_match_jax(run):
    check_dp_vs_jax_metrics(run)


def test_dp_step_params_and_vectors_match_jax(run):
    check_dp_vs_jax_params(run)


def test_dp_replicas_are_bit_equal(run):
    check_replicas_bit_equal(run)


def test_dp_step_matches_the_one_process_step(run):
    check_dp_vs_one_process(run)
