"""One fp32 train step of ``xmc_gan_tpu/cfg/concept_in_df_gan.yml`` with
``GEN.ENCODER_NAME`` = CONCEPT_INATTN_GEN (the JAX package's
``tests/test_integration_cfgs.py`` builds the word-attention configs the same
way) in the port against the JAX package (``tests/torch_step_parity.py``:
the sizes, the weights and the tolerances), words and their mask in the
batch: G's update crosses the masked word attention, which the port
differentiates through the plain version on the CPU (the card's backward
kernel is held to it in ``tests/test_torch_cuda.py``).  Then the same step
with ``TEXT.MAX_LENGTH`` past 256 words, where the card's backward streams
the words (``attn_bwd_long``) and the JAX package's Pallas forward tiles T."""

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_step_parity import check_metrics, check_params, run_step

# captions longer than attn_bwd's 256 words (a 260-word one, a 130-word one)
LONG_MAX_LENGTH = 260


@pytest.fixture(scope="module")
def run(one_torch_thread):
    return run_step("concept_in_df_gan.yml", {"GEN": {"ENCODER_NAME": "CONCEPT_INATTN_GEN"}},
                    words=True)


@pytest.fixture(scope="module")
def run_long(one_torch_thread):
    return run_step("concept_in_df_gan.yml", {"GEN": {"ENCODER_NAME": "CONCEPT_INATTN_GEN"}},
                    words=True, max_length=LONG_MAX_LENGTH)


def test_metrics_match_jax(run):
    check_metrics(run)


def test_params_and_vectors_match_jax(run):
    check_params(run)


def test_long_captions_metrics_match_jax(run_long):
    assert run_long["cfg"].TEXT.MAX_LENGTH == LONG_MAX_LENGTH
    check_metrics(run_long)


def test_long_captions_params_and_vectors_match_jax(run_long):
    check_params(run_long)
