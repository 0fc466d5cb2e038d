"""The generator half of ``make_models`` and the sampler (port of
``xmc_gan_tpu/train.py:61-64,505-514``).  The train step comes with the
training slice."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.device import resolve_device
from xmc_gan_tpu_torch.registry import get_generator
from xmc_gan_tpu_torch.utils.convert import load_state_dict

__all__ = ["make_generator", "make_sample_fn"]


def make_generator(cfg: Config, dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None, *,
                   weights: str | None = None, seed: int = 0,
                   fuse_upsample: bool = True) -> nn.Module:
    """``GEN.ENCODER_NAME`` (default ``DF_GEN``) with fp32 parameters and
    ``dtype`` activations, in eval mode on ``device`` (default ``cuda``).
    ``weights`` is a reference-named ``state_dict`` file (``.pth``), loaded
    strictly; without it the parameters are drawn from ``seed``."""
    dev = resolve_device(device)
    g_cls = get_generator(cfg.GEN.ENCODER_NAME or "DF_GEN")
    g = g_cls(cfg, dtype=dtype, fuse_upsample=fuse_upsample,
              gen=torch.Generator().manual_seed(seed))
    if weights:
        g.load_state_dict(load_state_dict(weights))
    return g.to(dev).eval().requires_grad_(False)


def make_sample_fn(cfg: Config, g_model: nn.Module | None = None,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None) -> Callable:
    """Sampling function ``(noise, sent, words=None, mask=None) -> images``
    (reference ``eval`` G forward, ``train_gan.py:361-365``).

    Without ``g_model`` a generator is built by :func:`make_generator` with
    ``dtype`` on ``device``; with one, its own dtype and device are used.
    Inputs are moved to the model's device.  The result is ``[B, H, W, 3]``
    fp32 in ``[-1, 1]`` (NHWC, as the JAX sampler returns).

    Building the sampler turns TF32 off once, process-wide
    (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``), so fp32 convolutions on the
    card are full fp32, as in the JAX package; calls leave the flags alone.
    """
    if g_model is None:
        g_model = make_generator(cfg, dtype, device)
    dev = next(g_model.parameters()).device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    @torch.inference_mode()
    def sample(noise, sent, words=None, mask=None) -> torch.Tensor:
        to = lambda t: None if t is None else torch.as_tensor(t).to(dev)
        img = g_model(to(noise).float(), to(sent).float(), to(words), to(mask))
        return img.permute(0, 2, 3, 1)

    return sample
