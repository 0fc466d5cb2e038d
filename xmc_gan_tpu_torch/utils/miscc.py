"""Parameter counting and image saving (port of ``xmc_gan_tpu/utils/miscc.py``;
reference ``utils/miscc.py:4-5`` and ``model/modules.py:7-11``)."""

from __future__ import annotations

import math
import os

import numpy as np

__all__ = ["count_params", "to_uint8", "save_image_grid", "save_images"]


def count_params(module) -> int:
    """Number of parameter scalars of an ``nn.Module`` (reference counts the
    trainable ones; every parameter of the port's G and D is trainable)."""
    return sum(p.numel() for p in module.parameters())


def to_uint8(imgs: np.ndarray) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8 (reference denorm ``(x+1)*127.5``,
    ``train_gan.py:369-371``).  uint8 input passes through."""
    arr = np.asarray(imgs)
    if arr.dtype == np.uint8:
        return arr
    arr = (arr.astype(np.float32) + 1.0) * 127.5
    return np.clip(arr + 0.5, 0, 255).astype(np.uint8)


def save_image_grid(imgs: np.ndarray, path: str, nrow: int = 8, pad: int = 2) -> None:
    """Tile a [-1,1] NHWC batch into one PNG (reference ``vutils.save_image``
    grids, ``train_gan.py:297-298,323-326``)."""
    from PIL import Image

    arr = to_uint8(imgs)
    n, h, w, c = arr.shape
    ncol = min(nrow, n)
    nrows = math.ceil(n / ncol)
    canvas = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        canvas[y : y + h, x : x + w] = arr[i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(canvas.squeeze()).save(path)


def save_images(imgs: np.ndarray, keys: list[str], out_dir: str) -> None:
    """Save each image of a [-1, 1] (or uint8) NHWC batch as
    ``{out_dir}/{key}.png`` (reference eval loop, ``train_gan.py:367-382``)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for img, key in zip(to_uint8(imgs), keys):
        safe = str(key).replace("/", "_")
        Image.fromarray(img).save(os.path.join(out_dir, f"{safe}.png"))
