"""One fp32 train step of
``xmc_gan_tpu/cfg/concept_in_df_gan_sbert_n2_damsm.yml`` in the port against
the JAX package (``tests/torch_step_parity.py``: the sizes, the weights and
the tolerances): CONCEPT_IN_DF_GEN (GroupNorm on) + DF_DISC with IMG_MATCH,
SENT + DISC losses, MAGP, N_CRITIC 2: the first step leaves G alone, the
second (run from the JAX state after the first) updates it."""

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_step_parity import check_metrics, check_params, run_step


@pytest.fixture(scope="module")
def run(one_torch_thread):
    return run_step("concept_in_df_gan_sbert_n2_damsm.yml")


def test_metrics_match_jax(run):
    check_metrics(run)


def test_params_and_vectors_match_jax(run):
    check_params(run)
