"""One fp32 train step of the flagship_word config (``df_gan_damsm.yml`` with
the word loss, B_GLOBAL and spectral norm, as ``chip_smoke.TRAIN_OVERRIDES``)
with word features wider than 1,024 (``TEXT.EMBEDDING_DIM`` = 1040) in the
port against the JAX package (``tests/torch_step_parity.py``: the sizes, the
weights and the tolerances).  D's region head projects to 1,040 channels,
G projects the sentence to NEF (``xmc_gan_tpu/models/df_gan.py:163-166``),
and the word-region scores take D = 1040: on the card the feature-streamed
damsm kernels (``ops/cuda/damsm_score.route``), here their plain version."""

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_step_parity import check_metrics, check_params, run_step
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds

WIDE = 1040
OVERRIDES = {"TRAIN": {"ENCODER_LOSS": {"WORD": True, "B_GLOBAL": True}},
             "DISC": {"SPEC_NORM": True}, "TEXT": {"EMBEDDING_DIM": WIDE}}


@pytest.fixture(scope="module")
def run(one_torch_thread):
    return run_step("df_gan_damsm.yml", OVERRIDES, words=True)


def test_metrics_match_jax(run):
    assert run["cfg"].TEXT.EMBEDDING_DIM == WIDE and run["cfg"].TRAIN.ENCODER_LOSS.WORD
    assert ds.route("fwd", 256, WIDE, None) == ds.STREAMED_FEATURES
    check_metrics(run)
    metrics = run["steps"][0]["port"]["metrics"]
    assert metrics["ds_word"] != 0.0 and metrics["gs_word"] != 0.0  # the word loss ran


def test_params_and_vectors_match_jax(run):
    check_params(run)
