"""Procedural toy caption/image dataset (the port's copy of
``xmc_gan_tpu/data/toy.py``; numpy only).

Each image shows one colored shape on a black background at a named
horizontal position, and its caption names (color, shape, position).  A
generator can only satisfy the conditional objectives by routing caption
information through the sentence embedding into pixels, so improving
caption->pixel metrics (``classify_color``, ``classify_position``) is direct
evidence that the GAN learns conditioning.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "COLORS",
    "SHAPES",
    "POSITIONS",
    "VOCAB",
    "sample_attrs",
    "render",
    "make_captions",
    "encode_captions",
    "classify_color",
    "classify_position",
]

COLORS = {
    "red": (1.0, 0.1, 0.1),
    "green": (0.1, 1.0, 0.1),
    "blue": (0.1, 0.1, 1.0),
    "yellow": (1.0, 1.0, 0.1),
}
_COLOR_NAMES = list(COLORS)
_COLOR_RGB = np.asarray([COLORS[c] for c in _COLOR_NAMES], np.float32)
SHAPES = ("circle", "square")
POSITIONS = ("left", "right")
# id 0 is the pad token (mask convention: caps == 0 -> padded)
VOCAB = ["<pad>", "a", "on", "the"] + _COLOR_NAMES + list(SHAPES) + list(POSITIONS)
_W2I = {w: i for i, w in enumerate(VOCAB)}


def sample_attrs(rng: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 3] int32 (color, shape, position) indices, uniform."""
    return np.stack(
        [
            rng.randint(0, len(COLORS), n),
            rng.randint(0, len(SHAPES), n),
            rng.randint(0, len(POSITIONS), n),
        ],
        axis=1,
    ).astype(np.int32)


def render(attrs: np.ndarray, size: int = 64) -> np.ndarray:
    """Render [n, size, size, 3] float32 images in [-1, 1]: one colored shape
    on a black background, horizontally placed by the position attribute."""
    n = attrs.shape[0]
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) + 0.5
    cy = size / 2.0
    r = size * 0.18
    cx = np.where(attrs[:, 2] == 0, size * 0.28, size * 0.72).astype(np.float32)
    dx = x[None] - cx[:, None, None]
    dy = (y - cy)[None]
    circle = dx * dx + dy * dy <= r * r
    square = (np.abs(dx) <= r) & (np.abs(dy) <= r)
    inside = np.where((attrs[:, 1] == 0)[:, None, None], circle, square)
    rgb = _COLOR_RGB[attrs[:, 0]]  # [n, 3]
    img01 = inside[..., None].astype(np.float32) * rgb[:, None, None, :]
    return img01 * 2.0 - 1.0


def make_captions(attrs: np.ndarray, max_len: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Token-id captions 'a {color} {shape} on the {position}', zero-padded.
    Returns (caps [n, max_len] int32, cap_lens [n] int32)."""
    n = attrs.shape[0]
    caps = np.zeros((n, max_len), np.int32)
    for i in range(n):
        words = [
            "a",
            _COLOR_NAMES[attrs[i, 0]],
            SHAPES[attrs[i, 1]],
            "on",
            "the",
            POSITIONS[attrs[i, 2]],
        ]
        ids = [_W2I[w] for w in words][:max_len]
        caps[i, : len(ids)] = ids
    lens = (caps != 0).sum(axis=1).astype(np.int32)
    return caps, lens


def encode_captions(
    caps: np.ndarray, dim: int, seed: int = 42
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frozen random-table text encoder (the synthetic-SBERT semantics of
    ``trainer.make_encode_fn``): per-token embeddings from a fixed seeded
    table, sentence embedding = masked mean-pool.  Distinct captions get
    distinct, fixed embeddings — a frozen encoder the GAN must learn to
    condition on, exactly the reference's frozen-pretrained-encoder role.

    Returns (words [n, T, dim] f32, sent [n, dim] f32, mask [n, T] bool)."""
    table = np.random.RandomState(seed).randn(len(VOCAB), dim).astype(np.float32)
    words = table[caps]
    mask = caps == 0
    valid = (~mask)[..., None].astype(np.float32)
    sent = (words * valid).sum(axis=1) / np.maximum(valid.sum(axis=1), 1.0)
    return words, sent, mask


def _lit_weighted_rgb(imgs: np.ndarray) -> np.ndarray:
    """Luminance-weighted mean RGB of each [-1,1] image -> [n, 3] in [0,1]."""
    img01 = np.clip((np.asarray(imgs, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    w = np.maximum(img01.max(axis=-1) - 0.2, 0.0)  # lit pixels only
    den = np.maximum(w.sum(axis=(1, 2)), 1e-6)[:, None]
    return (img01 * w[..., None]).sum(axis=(1, 2)) / den


def classify_color(imgs: np.ndarray) -> np.ndarray:
    """Nearest-palette color index of the lit region of each image."""
    mean_rgb = _lit_weighted_rgb(imgs)
    d = ((mean_rgb[:, None, :] - _COLOR_RGB[None]) ** 2).sum(-1)
    return d.argmin(axis=1).astype(np.int32)


def classify_position(imgs: np.ndarray) -> np.ndarray:
    """0 (left) / 1 (right) by where the luminance mass sits."""
    img01 = np.clip((np.asarray(imgs, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    lum = img01.sum(axis=-1)
    half = lum.shape[2] // 2
    left = lum[:, :, :half].sum(axis=(1, 2))
    right = lum[:, :, half:].sum(axis=(1, 2))
    return (right > left).astype(np.int32)
