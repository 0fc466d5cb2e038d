"""One fp32 train step of ``xmc_gan_tpu/cfg/concept_out_df_gan.yml`` in the port
against the JAX package (``tests/torch_step_parity.py``: the sizes, the
weights and the tolerances): CONCEPT_OUT_DF_GEN + CONCEPT_NETD + SENT_MATCH,
SENT + DISC losses, MAGP through the concept D (the epilogue's double
backward), spectral norm, no GroupNorm."""

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_step_parity import check_metrics, check_params, run_step


@pytest.fixture(scope="module")
def run(one_torch_thread):
    return run_step("concept_out_df_gan.yml")


def test_metrics_match_jax(run):
    check_metrics(run)


def test_params_and_vectors_match_jax(run):
    check_params(run)
