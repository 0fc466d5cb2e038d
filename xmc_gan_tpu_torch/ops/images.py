"""Device-side image dtype/range conversion (port of ``xmc_gan_tpu/ops/images.py``).

The input pipeline ships images as uint8 NHWC; the ``ToTensor +
Normalize(.5, .5)`` mapping to [-1, 1] runs on the device, where the batch
already is.
"""

from __future__ import annotations

import torch

__all__ = ["to_unit_range"]


def to_unit_range(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """uint8 images -> [-1, 1] float; float inputs pass through unchanged.

    The uint8 branch is ``/255 * 2 - 1`` in float32, in that order, and any
    cast to a lower-precision ``dtype`` (e.g. bf16) comes only afterwards.
    """
    if x.dtype == torch.uint8:
        x = x.float() / 255.0 * 2.0 - 1.0
    if dtype is not None and x.dtype != dtype:
        x = x.to(dtype)
    return x
