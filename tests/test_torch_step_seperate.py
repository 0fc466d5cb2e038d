"""One fp32 train step of ``xmc_gan_tpu/cfg/df_gan_sbert_seperate.yml`` in the
port against the JAX package (``tests/torch_step_parity.py``: the sizes, the
weights and the tolerances): DF_GEN + DF_DISC with DISC.SEPERATE: D is
conditioned on the raw sentence (48 wide here, 768 in the file), not on G's
projection (``xmc_gan_tpu/train.py:253-256``), and its head projects it to
NEF; MAGP."""

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_step_parity import check_metrics, check_params, run_step


@pytest.fixture(scope="module")
def run(one_torch_thread):
    return run_step("df_gan_sbert_seperate.yml")


def test_metrics_match_jax(run):
    check_metrics(run)


def test_params_and_vectors_match_jax(run):
    check_params(run)
