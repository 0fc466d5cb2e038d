"""Shared model plumbing: architecture tables and init-regime selection.

Port of ``xmc_gan_tpu/models/common.py``.  The tables match the reference
generator and discriminator (``model/df_gan.py:9-61``).  ``concept_gen_arch``
comes with the concept-family slice.
"""

from __future__ import annotations

from xmc_gan_tpu_torch.ops.initializers import (
    Init,
    he_normal_fan_in,
    ones_init,
    torch_default_bias_init,
    torch_default_kernel_init,
    zeros_init,
)

__all__ = ["gen_arch", "disc_arch", "inits", "affine_out_inits", "split_upsample_schedule"]


def split_upsample_schedule(ups: list, fuse: bool) -> tuple[list, list]:
    """(pre, post) per-block upsample schedule for the deferred-upsample fold.

    In fused mode each trailing nearest-2x upsample moves into the *following*
    block, where it folds into that block's first conv as a stride-2
    transposed conv; a trailing upsample on the final block (never present in
    the reference tables) has nowhere to fold, so it stays post.
    """
    pre = [False] + [fuse and u for u in ups[:-1]]
    post = [u and not fuse for u in ups[:-1]] + [ups[-1]]
    return pre, post


def gen_arch(img_size: int, nch: int) -> dict:
    """Generator stage table (reference ``df_gan.py:9-34``)."""
    if img_size not in (64, 128, 256):
        raise ValueError(f"IMG.SIZE must be 64, 128 or 256, got {img_size}")
    if img_size == 256:
        in_ch, out_ch = [8, 8, 8, 8, 8, 4, 2], [8, 8, 8, 8, 4, 2, 1]
        resolution, depth = [8, 16, 32, 64, 128, 256, 256], 7
    elif img_size == 128:
        in_ch, out_ch = [8, 8, 8, 8, 4, 2], [8, 8, 8, 4, 2, 1]
        resolution, depth = [8, 16, 32, 64, 128, 128], 6
    else:
        in_ch, out_ch = [8, 8, 8, 4, 2], [8, 8, 4, 2, 1]
        resolution, depth = [8, 16, 32, 64, 64], 5
    return {
        "in_channels": [i * nch for i in in_ch],
        "out_channels": [i * nch for i in out_ch],
        "upsample": [True] * (depth - 1) + [False],
        "resolution": resolution,
        "depth": depth,
    }


def disc_arch(img_size: int, nch: int) -> dict:
    """Discriminator stage table (reference ``df_gan.py:36-61``)."""
    if img_size not in (64, 128, 256):
        raise ValueError(f"IMG.SIZE must be 64, 128 or 256, got {img_size}")
    if img_size == 256:
        in_ch, out_ch = [1, 2, 4, 8, 16, 16], [1, 2, 4, 8, 16, 16, 16]
        resolution, depth = [128, 64, 32, 16, 8, 4, 4], 7
    elif img_size == 128:
        in_ch, out_ch = [1, 2, 4, 8, 16], [1, 2, 4, 8, 16, 16]
        resolution, depth = [64, 32, 16, 8, 4, 4], 6
    else:
        in_ch, out_ch = [1, 2, 4, 8], [1, 2, 4, 8, 16]
        resolution, depth = [32, 16, 8, 4, 4], 5
    return {
        "in_channels": [3] + [i * nch for i in in_ch],
        "out_channels": [i * nch for i in out_ch],
        "downsample": [True] * depth,
        "resolution": resolution,
        "depth": depth,
    }


def inits(he_init: bool, fan_in: int) -> tuple[Init, Init]:
    """(weight_init, bias_init) for the active init regime.

    ``he_init=True`` reproduces ``weight_init`` (reference ``train_gan.py:65-69``):
    Kaiming-normal fan-in weights, zero biases.  Otherwise PyTorch's layer
    defaults.  ``fan_in`` = input channels x receptive field.
    """
    if he_init:
        return he_normal_fan_in, zeros_init
    return torch_default_kernel_init, torch_default_bias_init(fan_in)


def affine_out_inits(he_init: bool, gamma: bool, fan_in: int) -> tuple[Init, Init]:
    """Init of the affine-MLP output layer (reference ``df_gan.py:244-248``):
    zeros weight, bias=1 for gamma / 0 for beta — unless ``HE_INIT`` later
    overwrote it (reference ``train_gan.py:476-478``), in which case
    Kaiming/zeros wins."""
    if he_init:
        return he_normal_fan_in, zeros_init
    return zeros_init, (ones_init if gamma else zeros_init)
