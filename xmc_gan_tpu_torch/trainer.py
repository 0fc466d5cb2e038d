"""The frozen text-encoder forward (port of ``make_encode_fn``,
``xmc_gan_tpu/trainer.py:42-72``, RNN branch).  The train step is
``train.make_train_step``; the training loop around it (data, checkpoints,
logging) comes with the trainer slice."""

from __future__ import annotations

import os
import warnings
from typing import Callable

import numpy as np
import torch

from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.device import resolve_device
from xmc_gan_tpu_torch.registry import get_text_encoder
from xmc_gan_tpu_torch.utils.convert import load_state_dict

__all__ = ["make_encode_fn"]


def make_encode_fn(cfg: Config, *, device: str | torch.device | None = None,
                   weights: str | None = None) -> Callable:
    """Frozen text-encoder forward: ``batch -> (words, sent, mask)``.

    ``batch`` holds ``caps`` ``[B, T]`` token ids and ``cap_lens`` ``[B]``
    (numpy arrays or tensors).  The weights come from ``weights``, else from
    ``TEXT.ENCODER_DIR`` when that file exists (reference ``train_gan.py:461-468``:
    a reference ``RNN_ENCODER`` ``state_dict`` loads directly); otherwise the
    encoder is randomly initialized from seed 0 (a ``torch.Generator``, so
    not the JAX package's random weights).  Runs on ``device`` (default
    ``cuda``; see ``device.resolve_device``).
    """
    dev = resolve_device(device)
    enc_cls = get_text_encoder(cfg.TEXT.ENCODER_NAME)
    enc = enc_cls(cfg, gen=torch.Generator().manual_seed(0))
    path = weights or cfg.TEXT.ENCODER_DIR
    if weights and not os.path.isfile(weights):
        raise FileNotFoundError(weights)
    if path and os.path.isfile(path):
        enc.load_state_dict(load_state_dict(path))
    elif path:
        warnings.warn(f"text encoder weights {path!r} not found; using random weights "
                      "(seed 0)", stacklevel=2)
    enc = enc.to(dev).eval().requires_grad_(False)

    @torch.inference_mode()
    def encode(batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        caps = torch.as_tensor(np.asarray(batch["caps"]), dtype=torch.int64).to(dev)
        lens = torch.as_tensor(np.asarray(batch["cap_lens"]), dtype=torch.int64)
        return enc(caps, lens)

    return encode
