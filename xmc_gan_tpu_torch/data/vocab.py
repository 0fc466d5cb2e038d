"""Caption vocabulary and tokenization for WORD configs.

The vocabulary is ``w2i`` from the dataset's ``captions.pickle``
(``(train_caps, test_caps, i2w, w2i)``, written by ``prep-coco``,
``data/coco_prep.py``; read as ``xmc_gan_tpu/data/pipeline.py:225-229`` does).
Tokenization follows the JAX CLI's ``sample`` (``cli.py:360-366``): lower-case,
split on whitespace, drop out-of-vocabulary words, truncate to ``max_length``,
pad with 0.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["load_w2i", "tokenize"]


def load_w2i(data_dir: str) -> dict[str, int]:
    """``w2i`` of ``<data_dir>/captions.pickle`` (a file the dataset tools wrote)."""
    with open(os.path.join(data_dir, "captions.pickle"), "rb") as f:
        return pickle.load(f)[3]


def tokenize(captions: list[str], w2i: dict[str, int], max_length: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """Captions -> (``caps`` int64 ``[N, max_length]``, ``cap_lens`` ``[N]``)."""
    caps = np.zeros((len(captions), max_length), np.int64)
    for i, sent in enumerate(captions):
        toks = [w2i[w] for w in sent.lower().split() if w in w2i]
        if not toks:
            raise ValueError(f"No in-vocabulary words in caption: {sent!r}")
        toks = toks[:max_length]
        caps[i, : len(toks)] = toks
    return caps, (caps != 0).sum(1)
