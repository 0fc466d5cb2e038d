"""Core neural-net ops: spectral-norm conv/dense and the pooling/upsampling helpers.

Port of ``xmc_gan_tpu/ops/modules.py`` in PyTorch layouts: activations are
NCHW tensors kept in ``channels_last`` memory, conv weights ``[O, I, kH, kW]``,
dense weights ``[out, in]``, so reference ``state_dict``s load by name.

Spectral norm applies the stored power-iteration vectors ``weight_u`` /
``weight_v`` (fp32 buffers): ``sigma = u . (W v)`` on the ``(out, -1)``
matricization in PyTorch's order ``(O, I*kH*kW)`` (the JAX package flattens
HWIO as ``(O, kH*kW*I)``; ``utils/convert.py`` permutes ``v`` between the two).
This is the JAX package's non-mutable branch (``ops/modules.py:67-103``); the
train step refreshes the vectors explicitly, once per step
(``train.refresh_spectral``).

Parameters are kept fp32 and cast to the activation dtype at each call, as the
JAX modules do (``kernel.astype(x.dtype)``).

Tensor parallelism: ``parallel.tensor.shard_model`` sets a layer's ``shard``
(a ``ColumnShard``) where the JAX rule splits its weight; the layer then
holds its output rows only and its forward runs through the shard, which
calls the layer's own op on them (``_op``, ``_conv``) and gathers the output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from xmc_gan_tpu_torch.ops.initializers import Init, torch_default_kernel_init, zeros_init

__all__ = [
    "SNConv",
    "SNDense",
    "fold_upsample_kernel",
    "upsample_nearest_2x",
    "avg_pool",
    "global_avg_pool",
    "leaky_relu",
]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def avg_pool(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """Average pooling of an NCHW tensor, no padding (reference ``F.avg_pool2d``)."""
    return F.avg_pool2d(x, window, stride or window)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Adaptive average pool to 1x1, returned as ``[B, C]``."""
    return x.mean(dim=(2, 3))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NCHW tensor (reference
    ``F.interpolate(scale_factor=2)``); keeps the input's memory format."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


# Per-axis fold of nearest-2x upsampling into a 3x3/pad-1 convolution:
# _UPFOLD_TAPS[m, a] = 1 where 3x3 tap ``a`` reaches output phase ``m`` of a
# stride-2, padding-1, 4-tap transposed conv (same table as the JAX package).
_UPFOLD_TAPS = ((0.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 0.0), (1.0, 0.0, 0.0))


def fold_upsample_kernel(weight: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Fold ``conv3x3(pad=1) o upsample_nearest_2x`` into one transposed conv.

    ``weight`` is a Conv2d weight ``[O, I/groups, 3, 3]``.  The result is a
    ``conv_transpose2d`` weight ``[I, O/groups, 4, 4]`` such that
    ``F.conv_transpose2d(x, result, stride=2, padding=1, groups=groups)``
    equals ``F.conv2d(upsample_nearest_2x(x), weight, padding=1,
    groups=groups)`` exactly.  Unlike the JAX package's fold (pre-flipped for
    an input-dilated conv), the taps are not flipped: the transposed conv
    scatters rather than gathers.  A grouped weight cannot simply swap its
    first two axes (that gives ``[I/groups, O, 4, 4]``): group ``j``'s output
    rows ``j*O/g ...`` pair with its input rows ``j*I/g ...``, so the folded
    taps are regrouped per group.
    """
    # non_blocking: a blocking copy from host memory would wait for the card's queue
    taps = torch.tensor(_UPFOLD_TAPS, dtype=weight.dtype).to(weight.device, non_blocking=True)
    w4 = torch.einsum("ma,nb,oiab->oimn", taps, taps, weight)  # [O, I/g, 4, 4]
    o, ig = w4.shape[:2]
    return (w4.reshape(groups, o // groups, ig, 4, 4).transpose(1, 2)
            .reshape(groups * ig, o // groups, 4, 4))


def _spectral_normalize(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``weight / sigma`` with ``sigma = u . (W v)`` on the ``(out, -1)`` view."""
    w32 = weight.float()
    sigma = u @ (w32.reshape(w32.shape[0], -1) @ v)
    return (w32 / sigma).to(weight.dtype)


class _SNBase(nn.Module):
    """Weight/bias parameters plus the optional spectral-norm buffers;
    ``shard``: this model rank's output rows under tensor parallelism."""

    shard = None

    def __init__(self, wshape: tuple[int, ...], use_bias: bool, spec_norm: bool,
                 weight_init: Init, bias_init: Init | None, gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(wshape))
        weight_init(self.weight, gen)
        if use_bias:
            self.bias = nn.Parameter(torch.empty(wshape[0]))
            (bias_init or zeros_init)(self.bias, gen)
        else:
            self.register_parameter("bias", None)
        self.spec_norm = spec_norm
        if spec_norm:
            # unit vectors, as torch's spectral_norm initializes them
            u = torch.randn(wshape[0], generator=gen)
            v = torch.randn(math.prod(wshape[1:]), generator=gen)
            self.register_buffer("weight_u", u / u.norm())
            self.register_buffer("weight_v", v / v.norm())

    def _params(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
        w = self.weight
        if self.spec_norm:
            w = _spectral_normalize(w, self.weight_u, self.weight_v)
        b = None if self.bias is None else self.bias.to(dtype)
        return w, b


class SNConv(_SNBase):
    """2-D convolution with optional spectral norm (reference ``conv2d_nxn``,
    ``model/modules.py:13-18``).

    ``pre_upsample`` folds a nearest-2x upsample of the input into the conv
    (:func:`fold_upsample_kernel`): the parameter stays an ordinary 3x3
    weight, the upsampled input is never materialized, and the conv runs as a
    stride-2 transposed conv.  ``groups`` is the JAX ``feature_group_count``
    (``xmc_gan_tpu/ops/modules.py:147,156,170,185``): the weight is
    ``[O, I/groups, kH, kW]``, as in a grouped ``nn.Conv2d``.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 groups: int = 1, spec_norm: bool = False, pre_upsample: bool = False,
                 weight_init: Init = torch_default_kernel_init,
                 bias_init: Init | None = None, gen: torch.Generator):
        if pre_upsample and (kernel_size != 3 or stride != 1 or padding != 1):
            raise ValueError("pre_upsample folds only a 3x3/stride-1/pad-1 conv")
        if in_features % groups or features % groups:
            raise ValueError(f"groups={groups} must divide {in_features} and {features}")
        super().__init__((features, in_features // groups, kernel_size, kernel_size),
                         use_bias, spec_norm, weight_init, bias_init, gen)
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.pre_upsample = pre_upsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is not None:
            return self.shard(self, x, self._op, 1)
        w, b = self._params(x.dtype)
        return self._op(x, w, b, self.groups)

    def _op(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            groups: int) -> torch.Tensor:
        if self.pre_upsample:
            return F.conv_transpose2d(x, fold_upsample_kernel(w, groups).to(x.dtype), b,
                                      stride=2, padding=1, groups=groups)
        return F.conv2d(x, w.to(x.dtype), b, stride=self.stride, padding=self.padding,
                        groups=groups)


class SNDense(_SNBase):
    """Dense layer with optional spectral norm (reference ``linear``,
    ``model/modules.py:28-33``)."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True,
                 spec_norm: bool = False, weight_init: Init = torch_default_kernel_init,
                 bias_init: Init | None = None, gen: torch.Generator):
        super().__init__((features, in_features), use_bias, spec_norm,
                         weight_init, bias_init, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is not None:
            return self.shard(self, x, self._op, -1)
        w, b = self._params(x.dtype)
        return self._op(x, w, b, 1)

    @staticmethod
    def _op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, groups: int) -> torch.Tensor:
        return F.linear(x, w.to(x.dtype), b)
