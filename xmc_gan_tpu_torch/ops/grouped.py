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

from xmc_gan_tpu_torch.ops.initializers import Init, torch_default_kernel_init, zeros_init

__all__ = ["GroupedDense", "GroupNorm"]


class GroupedDense(nn.Module):
    """Per-group dense layer ``[B, groups, d_in] -> [B, groups, d_out]``
    (``xmc_gan_tpu/ops/grouped.py:26-58``): a grouped 1x1 convolution with
    weight ``[groups*d_out, d_in, 1, 1]`` (output channels group-major) and
    bias ``[groups*d_out]``.  Spectral norm comes with ``CONCEPT_NETD``: no
    generator uses it."""

    def __init__(self, groups: int, d_in: int, features: int, *, use_bias: bool = True,
                 weight_init: Init = torch_default_kernel_init, bias_init: Init | None = None,
                 gen: torch.Generator):
        super().__init__()
        self.groups, self.features = groups, features
        self.weight = nn.Parameter(torch.empty(groups * features, d_in, 1, 1))
        weight_init(self.weight, gen)
        if use_bias:
            self.bias = nn.Parameter(torch.empty(groups * features))
            (bias_init or zeros_init)(self.bias, gen)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[B, groups, d_in]`` -> ``[B, groups, d_out]``."""
        w = self.weight.to(x.dtype).view(self.groups, self.features, -1)
        y = torch.einsum("bgi,goi->bgo", x, w)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(self.groups, self.features)
        return y

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The same projection at every pixel of an NCHW map ``[B,
        groups*d_in, H, W]`` -> ``[B, groups*d_out, H, W]`` (a channels_last
        map's memory is ``[B, HW, groups, d]``, the JAX package's grouped
        layout)."""
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, groups=self.groups)


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
