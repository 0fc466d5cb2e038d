"""VGG-19 image features for the VGG perceptual contrastive loss (port of
``xmc_gan_tpu/models/vgg.py``).

``ENCODER_LOSS.VGG`` adds to G's loss the image-image InfoNCE
(``losses.img_loss``) between frozen VGG-19 features of the real and the
fake images (the JAX package's objective; the reference leaves the flag
unimplemented).  ``VGG19Features`` is the 'E' configuration's conv tower up
to one tap (``reluN_M``, default ``relu5_4``, the deepest conv activation),
globally average-pooled to fp32 ``[B, C]``.  Its parameters carry
torchvision's names (``features.{i}.weight`` / ``.bias``; the whole tower,
whatever the tap), so a torchvision ``vgg19`` state_dict's ``features.*``
tensors load as they are; ``utils/convert.vgg_state_dict_from_jax`` maps
the JAX package's ``conv{i}`` trees.  The convolutions and pools stay on
cuDNN (the JAX package leaves them to XLA; no Pallas kernel is involved).
Activations are NCHW in ``channels_last`` memory in ``dtype``; parameters
are fp32 and frozen.  ``vgg19_params_from_torch`` (``cli
convert-vgg-weights``) maps a torchvision state_dict the other way, onto the
JAX package's ``conv{i}`` tree, for the ``.npz`` that both packages read.
"""

from __future__ import annotations

import math
import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VGG19_CFG", "TAPS", "VGG19Features", "preprocess", "make_vgg",
           "vgg19_params_from_torch"]

# torchvision vgg19 'E' configuration: conv channels per layer, 'M' = maxpool
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def _taps() -> dict[str, int]:
    """reluN_M (after the M-th conv of block N) -> its conv's dense index."""
    taps, block, idx = {}, 1, 1
    for v in VGG19_CFG:
        if v == "M":
            block, idx = block + 1, 1
        else:
            taps[f"relu{block}_{idx}"] = len(taps)
            idx += 1
    return taps


TAPS = _taps()
# ImageNet normalization (torchvision transforms convention)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def preprocess(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW RGB -> ImageNet-normalized fp32; ``mean`` and ``std`` are
    ``[1, 3, 1, 1]`` on the images' device (``VGG19Features``' buffers)."""
    return ((images.float() + 1.0) / 2.0 - mean) / std


class VGG19Features(nn.Module):
    """VGG-19 conv tower; ``forward`` returns the globally average-pooled
    activation of ``tap`` (fp32, ``[B, C]``).  A frozen encoder: in eval
    mode, no parameter requires grad (gradients reach the input only)."""

    def __init__(self, tap: str = "relu5_4", dtype: torch.dtype = torch.float32):
        super().__init__()
        if tap not in TAPS:
            raise KeyError(f"unknown VGG tap {tap!r}; one of {list(TAPS)}")
        self.tap, self.dtype = tap, dtype
        layers, cin = [], 3
        for v in VGG19_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        # not in the state_dict (torchvision's names only); on the device with
        # the module, so a step copies nothing from the host
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1), persistent=False)
        convs = [i for i, m in enumerate(self.features) if isinstance(m, nn.Conv2d)]
        self._stop = convs[TAPS[tap]] + 1  # the tap's ReLU
        self.requires_grad_(False).eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = preprocess(images, self.mean, self.std).to(self.dtype).contiguous(memory_format=torch.channels_last)
        for i in range(self._stop + 1):
            m = self.features[i]
            if isinstance(m, nn.Conv2d):
                x = F.conv2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), padding=1)
            elif isinstance(m, nn.ReLU):
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
        return x.float().mean(dim=(2, 3))


def _random_init(model: VGG19Features) -> None:
    """Weights ~ N(0, 1/fan_in) from a ``torch.Generator`` seeded 19 (the
    LeCun scale and seed of the JAX trainer's init, not its draw), zero
    biases."""
    gen = torch.Generator().manual_seed(19)
    with torch.no_grad():
        for m in model.features:
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(fan_in))
                m.bias.zero_()


def vgg19_params_from_torch(state_dict: dict) -> dict:
    """Map a torchvision ``vgg19`` (or ``vgg19.features``) state_dict onto the
    JAX package's ``VGG19Features`` params (``xmc_gan_tpu/models/vgg.py:93``),
    nested dicts of float32 numpy arrays: conv kernels OIHW -> HWIO, in
    configuration order (torchvision indexes convs at features.{0,2,5,...};
    they are indexed densely as conv0..conv15)."""
    from xmc_gan_tpu_torch.models.inception import f32_array

    feat_keys = sorted(
        (k for k in state_dict if k.endswith(".weight")
         and (".features." in k or k.startswith("features."))
         and getattr(state_dict[k], "ndim", 0) == 4),
        key=lambda k: int(k.split("features.")[-1].split(".")[0]),
    )
    params = {}
    for i, wk in enumerate(feat_keys):
        bk = wk[: -len("weight")] + "bias"
        params[f"conv{i}"] = {"kernel": f32_array(state_dict[wk]).transpose(2, 3, 1, 0),
                              "bias": f32_array(state_dict[bk])}
    return {"params": params}


def make_vgg(dtype: torch.dtype = torch.float32, device: str | torch.device = "cpu",
             path: str | None = None, *,
             log: Callable[[str], None] | None = None) -> VGG19Features:
    """The frozen VGG-19 of ``ENCODER_LOSS.VGG`` on ``device`` with ``dtype``
    activations.  Weights from ``path`` (default ``VGG_WEIGHTS_PATH``): a
    ``.npz`` (``convert-vgg-weights``' output, either package's: '/'-joined
    ``params/conv{i}/{kernel,bias}``) or a torchvision ``vgg19`` state_dict
    (``.pth``; its ``features.*`` tensors).  Without a file, a seeded random
    init, which ``log`` reports (a relative objective only, as in the JAX
    trainer)."""
    from xmc_gan_tpu_torch.eval import load_fid_weights_npz
    from xmc_gan_tpu_torch.utils.convert import load_state_dict, vgg_state_dict_from_jax

    say = log or (lambda msg: None)
    model = VGG19Features(dtype=dtype)
    path = os.environ.get("VGG_WEIGHTS_PATH", "") if path is None else path
    if path and os.path.isfile(path):
        if path.endswith(".npz"):
            sd = vgg_state_dict_from_jax(load_fid_weights_npz(path))
        else:
            raw = load_state_dict(path)
            sd = {k[k.index("features."):]: v for k, v in raw.items() if "features." in k}
        model.load_state_dict(sd, strict=True)
        say(f"VGG loss: loaded weights from {path}")
    else:
        _random_init(model)
        say("VGG loss: VGG_WEIGHTS_PATH unset - random-init VGG features (relative "
            "objective only)")
    return model.to(device)
