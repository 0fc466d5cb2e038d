"""The port's config copy and registry against the JAX package's."""

import glob
import os

import pytest

from xmc_gan_tpu.config import cfg_from_file as jax_cfg_from_file
from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.registry import get_generator, get_text_encoder

CFG_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "xmc_gan_tpu", "cfg")
ALL_CFGS = sorted(glob.glob(os.path.join(CFG_DIR, "*.yml")))


def test_all_thirteen_yamls_found():
    assert len(ALL_CFGS) == 13


@pytest.mark.parametrize("path", ALL_CFGS, ids=os.path.basename)
def test_cfg_from_file_equals_jax(path):
    assert cfg_from_file(path).to_dict() == jax_cfg_from_file(path).to_dict()


def test_strict_merge_semantics():
    with pytest.raises(KeyError):
        cfg_from_dict({"TRAIN": {"NOT_A_KEY": 1}})
    with pytest.raises(ValueError):
        cfg_from_dict({"TRAIN": {"NCH": "32"}})
    with pytest.raises(ValueError):
        cfg_from_dict({"TRAIN": {"HE_INIT": 1}})
    assert cfg_from_dict({"TRAIN": {"SMOOTH": {"SENT": 2}}}).TRAIN.SMOOTH.SENT == 2.0


def test_registry_resolves_ported_and_names_later_slices():
    from xmc_gan_tpu_torch.models.df_gan import NetG
    from xmc_gan_tpu_torch.models.encoder import RNNEncoder

    assert get_generator("DF_GEN") is NetG
    assert get_text_encoder("RNN") is RNNEncoder
    with pytest.raises(NotImplementedError, match="concept-family slice"):
        get_generator("CONCEPT_IN_DF_GEN")
    with pytest.raises(NotImplementedError, match="SBERT"):
        get_text_encoder("SBERT")
    with pytest.raises(KeyError):
        get_generator("NO_SUCH_GEN")
