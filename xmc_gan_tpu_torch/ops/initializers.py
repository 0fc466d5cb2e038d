"""Weight initializers reproducing the reference's init regimes.

Port of ``xmc_gan_tpu/ops/initializers.py`` for PyTorch-layout tensors
(``Linear`` weights ``[out, in]``, conv weights ``[O, I, kH, kW]``).  Two
regimes exist in the reference:

* ``HE_INIT`` (reference ``train_gan.py:65-69,476-478``): every Conv2d/Linear
  weight gets Kaiming-normal fan-in (ReLU gain) and biases are zeroed.  It is
  applied *after* construction in the reference, so it overwrites the special
  zeros/ones init of the affine layers; ``models/common.affine_out_inits``
  keeps that ordering.
* default: PyTorch's layer defaults, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for
  both weight and bias, with the affine special init kept.

Every initializer fills a tensor in place from an explicit ``torch.Generator``
and takes the fan-in from the caller (weights: input channels x receptive
field, as PyTorch computes it).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = [
    "Init",
    "he_normal_fan_in",
    "torch_default_kernel_init",
    "torch_default_bias_init",
    "zeros_init",
    "ones_init",
]

# (tensor, generator) -> None, filling ``tensor`` in place
Init = Callable[[torch.Tensor, torch.Generator], None]


def _fan_in(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:])


@torch.no_grad()
def he_normal_fan_in(t: torch.Tensor, gen: torch.Generator) -> None:
    """Kaiming normal, mode='fan_in', nonlinearity='relu' (gain^2 = 2)."""
    t.normal_(0.0, math.sqrt(2.0 / _fan_in(t)), generator=gen)


@torch.no_grad()
def torch_default_kernel_init(t: torch.Tensor, gen: torch.Generator) -> None:
    """PyTorch default ``kaiming_uniform_(a=sqrt(5))`` == ``U(+-1/sqrt(fan_in))``."""
    bound = 1.0 / math.sqrt(_fan_in(t))
    t.uniform_(-bound, bound, generator=gen)


def torch_default_bias_init(fan_in: int) -> Init:
    """PyTorch default bias init: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0

    @torch.no_grad()
    def init(t: torch.Tensor, gen: torch.Generator) -> None:
        t.uniform_(-bound, bound, generator=gen)

    return init


@torch.no_grad()
def zeros_init(t: torch.Tensor, gen: torch.Generator) -> None:
    t.zero_()


@torch.no_grad()
def ones_init(t: torch.Tensor, gen: torch.Generator) -> None:
    t.fill_(1.0)
