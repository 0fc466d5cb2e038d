"""Reader of the precomputed Sentence-BERT token-embedding caches (the port's
copy of ``SbertCache`` in ``xmc_gan_tpu/data/text_encode.py:101-125``).

The reference runs ``SentenceTransformer('stsb-roberta-base')`` inside the
train loop (``encoder.py:41-48``); the JAX package encodes every caption once,
offline, into a cache at the dataset root, next to ``bert_captions.pickle``:

    ``sbert_cache_train.npz`` / ``sbert_cache_test.npz``
        token_embs: float16 [N, MAX_LENGTH, 768]
        attn_mask:  uint8   [N, MAX_LENGTH] (1 = real token)

and the train step pools those rows (``models/encoder.SBERTEncoder``).  The
port reads the same files.  Building a cache, and encoding a caption that no
cache holds (``build_sbert_cache``, ``make_hf_sbert_encode``), needs the
RoBERTa transformer and its ``stsb-roberta-base`` weights; neither is in the
repository, so those builders are not ported yet: they wait until the
weights are.  Numpy only.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["SbertCache"]


class SbertCache:
    """One split's cache, read into host memory once (an ``.npz`` member is
    not memory-mapped), indexed by the caption index the datasets compute
    (``cap_idx = idx * CAPTIONS_PER_IMAGE + sent_ix``)."""

    def __init__(self, data_dir: str, mode: str):
        path = os.path.join(data_dir, f"sbert_cache_{mode}.npz")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} not found — build it with the JAX package's "
                "xmc_gan_tpu.data.text_encode.build_sbert_cache() on a machine that has the "
                "RoBERTa weights, or copy a prebuilt cache next to bert_captions.pickle")
        data = np.load(path, mmap_mode="r")
        self.token_embs = data["token_embs"]
        self.attn_mask = data["attn_mask"]

    def __len__(self) -> int:
        return self.token_embs.shape[0]

    def rows(self, cap_idxs) -> tuple[np.ndarray, np.ndarray]:
        """Rows ``cap_idxs`` in the cache's own types (fp16 embeddings,
        uint8 mask): what ``make_encode_fn`` moves to the card, where the
        exact fp16 -> fp32 cast runs (on the host it is the read's largest
        cost, and it doubles the bytes to copy)."""
        idx = np.asarray(cap_idxs)
        return self.token_embs[idx], self.attn_mask[idx]
