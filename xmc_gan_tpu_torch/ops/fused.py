"""Text-conditional modulation epilogue: the seam between the models and the kernel.

The generator's hot elementwise path is ``leaky_relu(gamma * x + beta)``
applied twice before each conv (reference ``df_gan.py:212-224,250-263``).  On
the TPU, XLA fused it into the producing convs, so the JAX package ships plain
jnp here.  Eager PyTorch fuses nothing, so on the card the hand-written kernel
(``ops/cuda/fused_affine.py``) is the production epilogue: these functions
launch it (forward, and its backward under autograd) for CUDA tensors and
use its plain versions for CPU tensors.

``x`` is NCHW (``channels_last`` memory for the fused forms), the modulation
vectors ``[B, C]``.
"""

from __future__ import annotations

import torch

from xmc_gan_tpu_torch.ops.cuda.fused_affine import (
    double_modulate_lrelu_kernel,
    modulate_lrelu_kernel,
)

__all__ = ["modulate", "modulate_lrelu", "double_modulate_lrelu"]


def modulate(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Per-channel affine modulation ``gamma * x + beta`` with ``[B, C]`` params
    broadcast over the spatial dims of NCHW ``x``."""
    return gamma[:, :, None, None] * x + beta[:, :, None, None]


def modulate_lrelu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   slope: float = 0.2) -> torch.Tensor:
    """``leaky_relu(gamma * x + beta, slope)`` — the fused modulation epilogue."""
    return modulate_lrelu_kernel(x, gamma, beta, slope)


def double_modulate_lrelu(x: torch.Tensor, g0: torch.Tensor, b0: torch.Tensor,
                          g1: torch.Tensor, b1: torch.Tensor,
                          slope: float = 0.2) -> torch.Tensor:
    """Two chained modulation epilogues (the affine0/affine1 pair of a G_Block
    residual branch, reference ``df_gan.py:213-216``)."""
    return double_modulate_lrelu_kernel(x, g0, b0, g1, b1, slope)
