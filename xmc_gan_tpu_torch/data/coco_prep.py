"""COCO ingestion: raw ``captions_{train,val}2014.json`` annotations -> the
reference's on-disk dataset layout (the port's copy of
``xmc_gan_tpu/data/coco_prep.py``; plain Python, what it writes is the same
file for file, so either package reads either's datasets).

The reference consumes ``{data_dir}/{mode}/filenames.pickle``,
``captions.pickle`` and ``bert_captions.pickle`` (reference
``dataset.py:24-40,82-113,115-136``) but provides no way to *build* them — it
silently inherits AttnGAN's preprocessed COCO artifacts.  This module is the
missing producer: it parses the official COCO caption annotation files and
writes all three artifacts, following AttnGAN's vocabulary/tokenization rules
(Xu et al. 2018, ``datasets.py``) so that DAMSM text encoders trained against
AttnGAN-style vocabularies remain compatible:

* tokenization: lowercase, ``\\ufffd\\ufffd`` -> space, NLTK
  ``RegexpTokenizer(r'\\w+')`` (== ``re.findall(r'\\w+', ...)``), each token
  ascii-encoded with errors ignored, empty tokens dropped;
* vocabulary: built over train+test tokens in first-appearance order, index 0
  reserved for ``<end>`` — which is why the reference's ``get_caption`` treats
  token 0 as an error (``dataset.py:104-105``);
* layout: caption ``img_idx * caps_per_image + sent_ix`` (the reference's
  fixed ``sent_ix=1`` indexing, ``dataset.py:50-52``).

One deliberate deviation from AttnGAN, recorded: AttnGAN drops captions that
tokenize to nothing (``if len(rev) > 0``), which silently *misaligns* the
``idx * caps_per_image`` layout for every later image.  Here an image's empty
caption slot is filled by repeating its nearest valid caption, and images with
no valid caption at all are dropped from the split — the layout invariant
``len(captions) == len(filenames) * caps_per_image`` always holds.

To reuse an existing AttnGAN/DAMSM vocabulary verbatim (index-exact), pass
``vocab_from=`` an existing ``captions.pickle``: its ``(i2w, w2i)`` are kept
and out-of-vocabulary tokens drop (AttnGAN's ``t in wordtoix`` filter).  A
caption left with zero tokens by that drop counts as *invalid* — validity is
judged on the encoded result, so the written ``captions.pickle`` never
contains an empty caption under either vocabulary mode.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Sequence

__all__ = [
    "tokenize_caption",
    "read_coco_annotations",
    "build_vocabulary",
    "encode_captions",
    "prepare_coco",
]

_WORD_RE = re.compile(r"\w+")


def tokenize_caption(caption: str) -> list[str]:
    """AttnGAN's caption tokenization, dependency-free (NLTK's
    ``RegexpTokenizer(r'\\w+').tokenize`` is ``re.findall`` of the pattern)."""
    cap = caption.replace("��", " ").lower()
    tokens = _WORD_RE.findall(cap)
    out = []
    for t in tokens:
        t = t.encode("ascii", "ignore").decode("ascii")
        if t:
            out.append(t)
    return out


def read_coco_annotations(json_path: str) -> tuple[list[str], dict[str, list[str]]]:
    """Parse an official COCO caption annotation file.

    Returns ``(keys, captions_by_key)`` where keys are image file-name stems
    (``COCO_train2014_000000318556``) in the annotation file's ``images``-array
    order, and each key maps to its captions in ``annotations``-array order.
    """
    with open(json_path, "r") as f:
        data = json.load(f)
    key_by_id: dict[int, str] = {}
    keys: list[str] = []
    for img in data["images"]:
        key = os.path.splitext(img["file_name"])[0]
        key_by_id[img["id"]] = key
        keys.append(key)
    caps: dict[str, list[str]] = {k: [] for k in keys}
    for ann in data["annotations"]:
        key = key_by_id.get(ann["image_id"])
        if key is not None:
            caps[key].append(str(ann["caption"]).strip())
    return keys, caps


def build_vocabulary(
    token_lists: Sequence[list[str]],
) -> tuple[dict[int, str], dict[str, int]]:
    """AttnGAN ``build_dictionary``: ``<end>`` at index 0, then every distinct
    token in first-appearance order across the given (train+test) captions."""
    i2w: dict[int, str] = {0: "<end>"}
    w2i: dict[str, int] = {"<end>": 0}
    for tokens in token_lists:
        for t in tokens:
            if t not in w2i:
                ix = len(w2i)
                w2i[t] = ix
                i2w[ix] = t
    return i2w, w2i


def encode_captions(
    token_lists: Sequence[list[str]], w2i: dict[str, int]
) -> list[list[int]]:
    """Tokens -> int ids, dropping out-of-vocabulary tokens (AttnGAN's
    ``t in wordtoix`` filter; a no-op when the vocab was built over these
    captions)."""
    return [[w2i[t] for t in tokens if t in w2i] for tokens in token_lists]


def _layout_split(
    keys: list[str],
    caps_by_key: dict[str, list[str]],
    caps_per_image: int,
    w2i: dict[str, int] | None = None,
) -> tuple[list[str], list[str], list[list[str]], int]:
    """Flatten to the ``img_idx * caps_per_image + sent_ix`` layout.  Images
    with fewer than ``caps_per_image`` valid captions repeat their last one;
    images with none are dropped.  A caption is *valid* when it still has
    tokens after tokenization — and, when reusing an external vocabulary
    (``w2i`` given), after the OOV drop too: validity must be judged on what
    will actually be encoded, or an all-OOV caption would pass the filter yet
    encode to an empty token list, breaking the no-empty-caption invariant
    the reference's ``get_caption`` relies on (token 0 = ``<end>`` never
    appears mid-caption).  Returns (kept keys, flat captions, flat token
    lists — already OOV-filtered when ``w2i`` was given — dropped-image
    count)."""
    kept: list[str] = []
    flat: list[str] = []
    flat_tokens: list[list[str]] = []
    dropped = 0
    for key in keys:
        cands: list[tuple[str, list[str]]] = []
        for c in caps_by_key.get(key, []):
            toks = tokenize_caption(c)
            if w2i is not None:
                toks = [t for t in toks if t in w2i]
            if toks:
                cands.append((c, toks))
        if not cands:
            dropped += 1
            continue
        kept.append(key)
        padded = (cands + [cands[-1]] * caps_per_image)[:caps_per_image]
        flat.extend(c for c, _ in padded)
        flat_tokens.extend(t for _, t in padded)
    return kept, flat, flat_tokens, dropped


def prepare_coco(
    data_dir: str,
    train_json: str,
    test_json: str,
    caps_per_image: int = 5,
    vocab_from: str | None = None,
) -> dict:
    """Write the reference dataset artifacts under ``data_dir`` from raw COCO
    annotation files (train2014/val2014 -> train/test splits):

    * ``{mode}/filenames.pickle`` — image keys (images expected at
      ``{data_dir}/images/{key}.jpg``)
    * ``captions.pickle`` — ``[train_caps, test_caps, i2w, w2i]`` int tokens
    * ``bert_captions.pickle`` — ``(train_sents, test_sents)`` raw strings

    Returns a summary dict (per-split image counts, vocab size, drops).
    """
    if vocab_from:
        with open(vocab_from, "rb") as f:
            _, _, i2w, w2i = pickle.load(f)[:4]
        vocab_filter: dict[str, int] | None = w2i
    else:
        vocab_filter = None

    splits: dict[str, tuple[list[str], list[str]]] = {}
    tokens: dict[str, list[list[str]]] = {}
    dropped: dict[str, int] = {}
    for mode, path in (("train", train_json), ("test", test_json)):
        keys, caps_by_key = read_coco_annotations(path)
        kept, flat, flat_tokens, ndrop = _layout_split(
            keys, caps_by_key, caps_per_image, vocab_filter)
        splits[mode] = (kept, flat)
        tokens[mode] = flat_tokens
        dropped[mode] = ndrop

    if not vocab_from:
        i2w, w2i = build_vocabulary(tokens["train"] + tokens["test"])

    train_caps = encode_captions(tokens["train"], w2i)
    test_caps = encode_captions(tokens["test"], w2i)

    for mode in ("train", "test"):
        os.makedirs(os.path.join(data_dir, mode), exist_ok=True)
        with open(os.path.join(data_dir, mode, "filenames.pickle"), "wb") as f:
            pickle.dump(splits[mode][0], f)
    with open(os.path.join(data_dir, "captions.pickle"), "wb") as f:
        pickle.dump([train_caps, test_caps, i2w, w2i], f)
    with open(os.path.join(data_dir, "bert_captions.pickle"), "wb") as f:
        pickle.dump((splits["train"][1], splits["test"][1]), f)

    return {
        "train_images": len(splits["train"][0]),
        "test_images": len(splits["test"][0]),
        "voca_size": len(i2w),
        "dropped_train": dropped["train"],
        "dropped_test": dropped["test"],
        "caps_per_image": caps_per_image,
    }
