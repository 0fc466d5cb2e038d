"""Grouped (per-concept) ops for the concept-GAN model families.

Port of ``xmc_gan_tpu/ops/grouped.py`` plus the group normalization those
models apply.  The reference implements per-concept-group projections as
grouped 1x1 convolutions on ``[B, C*d, 1, 1]`` tensors
(``df_concept_gan.py:178-200,266-268``); the JAX package turned them into
batched einsums over an explicit group axis.  The port keeps the reference's
weight layout ``[groups*d_out, d_in, 1, 1]``, so reference ``state_dict``s load
by name, and offers both forms: :meth:`GroupedDense.forward` on ``[B, groups,
d_in]`` vectors and :meth:`GroupedDense.conv` on a whole NCHW feature map,
where it is the grouped 1x1 convolution itself (the map is never regrouped in
memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xmc_gan_tpu_torch.ops.initializers import Init, torch_default_kernel_init
from xmc_gan_tpu_torch.ops.modules import _SNBase

__all__ = ["GroupedDense", "GroupNorm"]


class GroupedDense(_SNBase):
    """Per-group dense layer ``[B, groups, d_in] -> [B, groups, d_out]``
    (``xmc_gan_tpu/ops/grouped.py:26-58``): a grouped 1x1 convolution with
    weight ``[groups*d_out, d_in, 1, 1]`` (output channels group-major) and
    bias ``[groups*d_out]``.  With ``spec_norm`` (the concept discriminator)
    the weight is divided by ``sigma`` from its ``weight_u``/``weight_v``
    buffers on the ``(groups*d_out, d_in)`` matricization, PyTorch's and the
    JAX package's, which ``train.refresh_spectral`` refreshes like any other
    spectral-normalized layer."""

    def __init__(self, groups: int, d_in: int, features: int, *, use_bias: bool = True,
                 spec_norm: bool = False, weight_init: Init = torch_default_kernel_init,
                 bias_init: Init | None = None, gen: torch.Generator):
        super().__init__((groups * features, d_in, 1, 1), use_bias, spec_norm, weight_init,
                         bias_init, gen)
        self.groups, self.features = groups, features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[B, groups, d_in]`` -> ``[B, groups, d_out]``."""
        if self.shard is not None:  # the output features as one axis, group-major
            y = self.shard(self, x, self._einsum, -1)
            return y.unflatten(-1, (self.groups, self.features))
        w, b = self._params(x.dtype)
        return self._einsum(x, w, b, self.groups).unflatten(-1, (self.groups, -1))

    @staticmethod
    def _einsum(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                groups: int) -> torch.Tensor:
        """``[B, groups, d_in]`` -> ``[B, groups * d_out]`` (``w`` holds
        ``d_out`` rows of each group)."""
        y = torch.einsum("bgi,goi->bgo", x, w.to(x.dtype).view(groups, -1, w.shape[1]))
        if b is not None:
            y = y + b.view(groups, -1)
        return y.flatten(-2)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The same projection at every pixel of an NCHW map ``[B,
        groups*d_in, H, W]`` -> ``[B, groups*d_out, H, W]`` (a channels_last
        map's memory is ``[B, HW, groups, d]``, the JAX package's grouped
        layout)."""
        if self.shard is not None:
            return self.shard(self, x, self._conv, 1)
        w, b = self._params(x.dtype)
        return self._conv(x, w, b, self.groups)

    @staticmethod
    def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
              groups: int) -> torch.Tensor:
        return F.conv2d(x, w.to(x.dtype), b, groups=groups)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` (eps 1e-5) as ``F.group_norm``: statistics per
    sample and group over every other axis of an ``[N, C, *]`` tensor, then a
    per-channel ``weight``/``bias`` (Flax's ``scale``/``bias``; the reference's
    ``nn.GroupNorm`` names).  The fp32 parameters are cast to the input's type."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)
