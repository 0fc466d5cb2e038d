"""Localized Narratives ingestion: LN JSONL annotations -> the reference's
on-disk dataset layout, so LN-COCO / LN-OpenImages (BASELINE configs #4/#5)
train through the unchanged ``SentTextDataset`` path (the port's copy of
``xmc_gan_tpu/data/ln_prep.py``; plain Python, the same files).

Localized Narratives ships per-split JSON-Lines files where each line is one
narration::

    {"dataset_id": "mscoco_train2017", "image_id": "137576",
     "annotator_id": 93, "caption": "In this image we can see ...",
     "timed_caption": [...], "traces": [...], "voice_recording": "..."}

Only ``image_id`` and ``caption`` matter here.  The prep writes the
reference-compatible artifacts (reference ``dataset.py:115-136`` reads them):

* ``{data_dir}/{mode}/filenames.pickle`` — image keys, first-seen order
* ``{data_dir}/bert_captions.pickle``   — ``(train_sents, test_sents)`` raw
  strings, laid out as ``img_idx * caps_per_image + sent_ix``

Images are expected at ``{data_dir}/images/{key}.jpg``; ``key_format`` maps an
LN ``image_id`` to that key (LN-COCO ids are bare COCO ints — e.g.
``COCO_train2014_{:012d}`` for the 2014 naming the reference's COCO metadata
uses, ``{:012d}`` for 2017, ``{}`` identity for OpenImages hex ids).

After prep, the SENT configs read an SBERT token-embedding cache beside these
files (``data/text_encode.SbertCache``; the train loop never tokenizes).
Building that cache needs the RoBERTa transformer and its
``stsb-roberta-base`` weights, which are not in the repository; the JAX
package's ``build_sbert_cache`` writes it where they are.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterable, Sequence

__all__ = ["read_ln_jsonl", "prepare_localized_narratives"]


def read_ln_jsonl(paths: Sequence[str] | str) -> dict[str, list[str]]:
    """Parse LN annotation file(s) into ``{image_id: [captions...]}``,
    preserving first-seen image order (dict insertion order) and per-image
    annotator order."""
    if isinstance(paths, str):
        paths = [paths]
    by_image: dict[str, list[str]] = {}
    for path in paths:
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                cap = str(rec["caption"]).strip()
                if not cap:
                    continue
                by_image.setdefault(str(rec["image_id"]), []).append(cap)
    return by_image


def _layout_captions(
    by_image: dict[str, list[str]], caps_per_image: int
) -> tuple[list[str], list[str]]:
    """(keys, flat captions) with exactly ``caps_per_image`` caption slots per
    image at ``img_idx * caps_per_image + sent_ix`` — images with fewer
    narrations repeat their last one (LN has ~1 narration/image; COCO-style
    configs may still ask for 5 slots), extras beyond the slot count drop."""
    keys: list[str] = []
    flat: list[str] = []
    for image_id, caps in by_image.items():
        keys.append(image_id)
        padded = (caps + [caps[-1]] * caps_per_image)[:caps_per_image]
        flat.extend(padded)
    return keys, flat


def prepare_localized_narratives(
    data_dir: str,
    train_jsonls: Sequence[str] | str,
    test_jsonls: Sequence[str] | str,
    caps_per_image: int = 1,
    key_format: str = "{}",
) -> dict[str, int]:
    """Write ``{mode}/filenames.pickle`` + ``bert_captions.pickle`` under
    ``data_dir`` from LN train/test annotation files.  Returns per-split image
    counts.  ``key_format.format(image_id)`` produces the image key; numeric
    formats (``{:012d}``) get int-converted ids."""

    def to_key(image_id: str) -> str:
        try:
            return key_format.format(int(image_id))
        except ValueError:  # non-numeric id (OpenImages hex) or plain format
            return key_format.format(image_id)

    splits = {"train": read_ln_jsonl(train_jsonls), "test": read_ln_jsonl(test_jsonls)}
    sents: dict[str, list[str]] = {}
    counts: dict[str, int] = {}
    for mode, by_image in splits.items():
        keys, flat = _layout_captions(by_image, caps_per_image)
        keys = [to_key(k) for k in keys]
        os.makedirs(os.path.join(data_dir, mode), exist_ok=True)
        with open(os.path.join(data_dir, mode, "filenames.pickle"), "wb") as f:
            pickle.dump(keys, f)
        sents[mode] = flat
        counts[mode] = len(keys)
    with open(os.path.join(data_dir, "bert_captions.pickle"), "wb") as f:
        pickle.dump((sents["train"], sents["test"]), f)
    return counts
