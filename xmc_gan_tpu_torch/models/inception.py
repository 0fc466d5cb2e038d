"""InceptionV3 feature extractor for FID (port of ``xmc_gan_tpu/models/inception.py``).

The reference computes FID with ``pytorch_fid.calculate_fid_given_paths``
(``train_gan.py:389``), whose backbone is InceptionV3 truncated at the
2048-dim ``pool3`` features.  The module names are torchvision's
``inception_v3`` (and pytorch_fid's, which uses the same), so such a
``state_dict`` loads with ``load_state_dict`` once its ``AuxLogits.*`` (and,
without ``num_classes``, ``fc.*``) tensors are dropped.  ``fid_variant=True``
gives the two switches of pytorch_fid's ``pt_inception-2015-12-05`` graph:
the average pools exclude padding, and the last Inception-E block pools with
max instead of average.

Inference only (BatchNorm from its running statistics, eps 1e-3).  NCHW in
and out, as the port's other modules; the convolutions stay on cuDNN, as the
JAX package left them to XLA.

``inception_params_from_torch`` (``cli convert-fid-weights``) maps such a
``state_dict`` onto the JAX package's variable tree, numpy only, for the
torch-free ``.npz`` that ``eval.save_fid_weights_npz`` writes and both
packages read.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InceptionV3", "preprocess", "inception_params_from_torch", "f32_array"]


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm(eps=1e-3) + relu."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor, fid_variant: bool) -> torch.Tensor:
    """3x3/s1/p1 average pool; the FID variant divides by the valid taps."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not fid_variant)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for layer in (self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg3(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for layer in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_mode``: ``avg`` (torchvision; FID block 1) or ``max`` (FID
    block 2, pytorch_fid's ``FIDInceptionE_2``)."""

    def __init__(self, c_in: int, pool_mode: str, fid_variant: bool):
        super().__init__()
        self.pool_mode, self.fid_variant = pool_mode, fid_variant
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg3(x, self.fid_variant)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[-1, 1] NCHW at any resolution -> ``size`` squared, bilinear with
    half-pixel centres and, when shrinking, a widened (antialiasing) filter:
    ``jax.image.resize(..., "bilinear")`` of the JAX package's ``preprocess``
    (pytorch_fid's ``resize_input`` up to the antialiasing)."""
    if tuple(images.shape[-2:]) == (size, size):
        return images
    return F.interpolate(images, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


class InceptionV3(nn.Module):
    """The trunk to the 2048-dim pool3 features; with ``num_classes`` also
    the ``fc`` head, whose logits ``forward(x, return_logits=True)`` gives."""

    def __init__(self, fid_variant: bool = True, num_classes: int = 0):
        super().__init__()
        fid = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fid)
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg", fid)
        self.fc = nn.Linear(2048, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        feats = x.mean(dim=(2, 3))
        if self.fc is not None and return_logits:
            return self.fc(feats)
        return feats


def f32_array(value) -> np.ndarray:
    """A ``state_dict`` value (tensor or array) as a float32 numpy array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().float().numpy()
    return np.asarray(value, dtype=np.float32)


def inception_params_from_torch(state_dict: Mapping) -> dict:
    """torchvision/pytorch_fid ``inception_v3`` state_dict -> the JAX
    package's variables ``{'params': ..., 'batch_stats': ...}`` as nested
    dicts of float32 numpy arrays (``xmc_gan_tpu/models/inception.py:217``).
    Tensor names map 1:1; conv weights transpose OIHW -> HWIO; ``AuxLogits``
    and ``num_batches_tracked`` drop; any other name raises ``KeyError``."""
    params: dict = {}
    batch_stats: dict = {}

    def put(tree: dict, path: Sequence[str], leaf: np.ndarray) -> None:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    for name, value in state_dict.items():
        arr = f32_array(value)
        parts = name.split(".")
        if parts[0].startswith("AuxLogits"):
            continue
        if parts[-2] == "conv" and parts[-1] == "weight":
            put(params, parts[:-1] + ["kernel"], np.transpose(arr, (2, 3, 1, 0)))
        elif parts[-2] == "bn":
            if parts[-1] == "weight":
                put(params, parts[:-1] + ["scale"], arr)
            elif parts[-1] == "bias":
                put(params, parts[:-1] + ["bias"], arr)
            elif parts[-1] == "running_mean":
                put(batch_stats, parts[:-1] + ["mean"], arr)
            elif parts[-1] == "running_var":
                put(batch_stats, parts[:-1] + ["var"], arr)
            # num_batches_tracked: dropped
        elif parts[0] == "fc":
            put(params, ["fc", "kernel" if parts[-1] == "weight" else "bias"],
                arr.T if parts[-1] == "weight" else arr)
        elif parts[-1] == "num_batches_tracked":
            continue
        else:
            raise KeyError(f"Unrecognized inception tensor {name}")
    return {"params": params, "batch_stats": batch_stats}
