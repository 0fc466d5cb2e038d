"""Every config the JAX package ships (``xmc_gan_tpu/cfg/*.yml``) trains in
the port: its encoder, G and D build through the registry, a synthetic batch
goes through the encoder, and ``N_CRITIC`` steps (so that G updates once)
give finite metrics, on the CPU at tiny width (NCH=8, NEF=32, 64², batch 4,
EMBEDDING_DIM=48, MAX_LENGTH=6, every switch of the file kept).  PyTorch
only: the parity of each module and of three whole steps is held against
JAX elsewhere (``test_torch_step_*.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from xmc_gan_tpu_torch import registry
from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from xmc_gan_tpu_torch.train import create_train_state, make_train_step
from xmc_gan_tpu_torch.trainer import make_encode_fn

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG_DIR = Path(__file__).resolve().parents[1] / "xmc_gan_tpu" / "cfg"
CFGS = sorted(p.name for p in CFG_DIR.glob("*.yml"))
TINY = {"TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": 16, "BATCH_SIZE": 4, "HE_INIT": True},
        "IMG": {"SIZE": 64},
        "TEXT": {"EMBEDDING_DIM": 48, "MAX_LENGTH": 6, "VOCA_SIZE": 50, "ENCODER_DIR": ""}}


@pytest.mark.parametrize("name", CFGS)
def test_every_config_takes_a_finite_cpu_step(name):
    cfg = cfg_from_dict(TINY, base=cfg_from_file(str(CFG_DIR / name)))
    encode = make_encode_fn(cfg, device="cpu", synthetic=True)
    batch = DataLoader(SyntheticDataset(cfg, 4), 4, shuffle=False, drop_last=True, seed=0,
                       num_threads=1).first_batch()
    words, sent, mask = encode(batch)
    assert sent.shape == (4, 48) and words.shape == (4, 6, 48) and mask.shape == (4, 6)
    state = create_train_state(cfg, device="cpu", seed=0)
    assert type(state.g) is registry.get_generator(cfg.GEN.ENCODER_NAME or "DF_GEN")
    assert type(state.d) is registry.get_discriminator(cfg.DISC.ENCODER_NAME or "DF_DISC")
    step = make_train_step(cfg)
    rng = np.random.RandomState(0)
    for _ in range(cfg.TRAIN.N_CRITIC):
        metrics = step(state, {"imgs": batch["imgs"], "sent_embs": sent, "words_embs": words,
                               "mask": mask}, rng.randn(4, 16).astype(np.float32))
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v.float()))]
    assert not bad, (name, bad)
    assert state.step == cfg.TRAIN.N_CRITIC and float(metrics["g_updated"]) == 1.0
