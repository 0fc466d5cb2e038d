"""COCO-style caption/image input pipeline (the port's copy of
``xmc_gan_tpu/data/pipeline.py``; numpy and PIL only).

The on-disk format is the reference's (``xmc_gan/dataset.py`` +
``train_gan.py:444-457``), so prepared datasets drop in unchanged:

* ``{data_dir}/{mode}/filenames.pickle``  — list of image keys
* ``{data_dir}/images/{key}.jpg``         — JPEG images
* ``{data_dir}/captions.pickle``          — ``(train_caps, test_caps, i2w, w2i)``
  integer captions (``WordTextDataset``, reference ``dataset.py:82-113``)
* ``{data_dir}/bert_captions.pickle``     — ``(train_sents, test_sents)`` raw
  strings (``SentTextDataset``, reference ``dataset.py:115-136``)

As in the JAX package:

* **Sharding**: a loader reads the ``shard=(index, count)`` slice of the
  seeded per-epoch permutation; ``batch_size`` is the global batch.
* **Stateless augmentation**: every example's crop/flip is a pure function of
  ``(seed, epoch, index)``, so a resumed run reads the same examples with the
  same draws as an uninterrupted one; the port's loader yields the JAX
  package's batches bit for bit.
* **Static shapes**: captions pad/truncate to ``TEXT.MAX_LENGTH`` exactly as
  ``get_caption`` (``dataset.py:104-111``); train batches are fixed-size
  (``drop_last``).
* **uint8 NHWC on the wire**: the ``ToTensor + Normalize(.5,.5)`` mapping to
  [-1, 1] (``dataset.py:32-37``) runs on the card
  (``ops.images.to_unit_range``); a 256² batch of 128 crosses as 25 MB, not
  100 MB.
* **Threaded decode**: worker threads decode and augment ahead of the
  consumer (the native decoder releases the GIL).

Reference quirks preserved: fixed ``sent_ix = 1`` (the random choice is
commented out, ``dataset.py:50-52``); the ``b_local`` second-caption path is
dead (``dataset.py:30``) and intentionally not built.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import queue
from typing import Any, Iterator, Sequence

import numpy as np

__all__ = [
    "WordTextDataset",
    "SentTextDataset",
    "SyntheticDataset",
    "DataLoader",
    "index_to_sent",
    "load_image",
    "train_transform",
    "test_transform",
    "decode_route",
]


def index_to_sent(i2w: dict, caps: np.ndarray) -> list[str]:
    """Integer captions -> space-joined strings, skipping padding (reference
    ``dataset.py:17-20``)."""
    return [
        " ".join(i2w[int(w)] for w in cap if int(w) != 0) for cap in np.asarray(caps)
    ]


# --------------------------------------------------------------------------- #
# Augmentation (reference train transform, train_gan.py:444-448: Resize to
# shorter-side size*76/64, RandomCrop, RandomHorizontalFlip; test: exact
# Resize((size, size)), :454).  PIL bilinear matches torchvision defaults.
# --------------------------------------------------------------------------- #


def _example_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    digest = hashlib.blake2b(
        f"{seed}:{epoch}:{index}".encode(), digest_size=8
    ).digest()
    return np.random.default_rng(int.from_bytes(digest, "little"))


def train_transform(img, size: int, rng: np.random.Generator):
    from PIL import Image

    short = int(size * 76 / 64)
    w, h = img.size
    scale = short / min(w, h)
    img = img.resize(
        (max(short, round(w * scale)), max(short, round(h * scale))),
        Image.BILINEAR,
    )
    w, h = img.size
    left = int(rng.integers(0, w - size + 1))
    top = int(rng.integers(0, h - size + 1))
    img = img.crop((left, top, left + size, top + size))
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def test_transform(img, size: int, rng=None):
    from PIL import Image

    return img.resize((size, size), Image.BILINEAR)


def _to_uint8_hwc(img) -> np.ndarray:
    """PIL image -> uint8 HWC array (the wire format; [-1, 1] happens on the
    card, ``ops.images.to_unit_range``)."""
    return np.asarray(img, dtype=np.uint8)


def load_image(
    path: str, size: int, mode: str, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Decode + augment one image -> uint8 HWC.  Uses the native C++/libjpeg
    path when the library builds (``data/native.py``: GIL-free threaded decode,
    triangle-filter resize); falls back to PIL with identical augmentation
    semantics.  The crop/flip draws come from the same stateless per-example
    RNG either way."""
    from xmc_gan_tpu_torch.data import native

    if path.lower().endswith((".jpg", ".jpeg")) and native.available():
        with open(path, "rb") as f:
            data = f.read()
        if mode == "train":
            assert rng is not None
            out = native.decode_train(
                data, size, int(size * 76 / 64),
                u_x=rng.random(), u_y=rng.random(), flip=rng.random() < 0.5,
            )
        else:
            out = native.decode_test(data, size)
        if out is not None:
            return out
        # corrupt/odd file: fall through to PIL

    from PIL import Image

    with Image.open(path) as img:
        if img.format == "JPEG" and os.environ.get("XMC_DCT_SCALE", "1") != "0":
            # mirror the native path's DCT-scaled decode (data/native.py):
            # request >= 2x the resize target so the BILINEAR filter keeps
            # >= 2x oversampling; draft() only ever downscales in the IDCT
            t = 2 * (int(size * 76 / 64) if mode == "train" else size)
            img.draft("RGB", (t, t))
        img = img.convert("RGB")
        if mode == "train":
            assert rng is not None
            img = train_transform(img, size, rng)
        else:
            img = test_transform(img, size)
        return _to_uint8_hwc(img)


def decode_route(dataset) -> str:
    """How ``dataset``'s images are made: ``synthetic`` (drawn in memory),
    ``native`` (libjpeg through ``data/native.py``) or ``PIL``."""
    from xmc_gan_tpu_torch.data import native

    if isinstance(dataset, SyntheticDataset):
        return "synthetic"
    return "native" if native.available() else "PIL"


# --------------------------------------------------------------------------- #
# Datasets
# --------------------------------------------------------------------------- #


class _TextDatasetBase:
    """Filename list + image loading shared by both caption formats
    (reference ``TextDataset``, ``dataset.py:23-79``)."""

    def __init__(self, data_dir: str, mode: str, cfg):
        self.data_dir = data_dir
        self.mode = mode
        self.img_size = cfg.IMG.SIZE
        self.caps_per_image = cfg.TEXT.CAPTIONS_PER_IMAGE
        self.max_length = cfg.TEXT.MAX_LENGTH
        self.filenames = self._load_filenames(data_dir, mode)
        self._load_text_data(data_dir, mode)

    @staticmethod
    def _load_filenames(data_dir: str, mode: str) -> list:
        path = f"{data_dir}/{mode}/filenames.pickle"
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} not found — prepare the dataset metadata first "
                "(reference dataset.py:70 'Download the meta data')"
            )
        with open(path, "rb") as f:
            return pickle.load(f)

    def __len__(self) -> int:
        return len(self.filenames)

    def _load_text_data(self, data_dir: str, mode: str) -> None:
        raise NotImplementedError

    def get_caption(self, sent_ix: int):
        raise NotImplementedError

    def __getitem__(self, args) -> dict[str, Any]:
        idx, epoch, seed = args if isinstance(args, tuple) else (args, 0, 0)
        key = self.filenames[idx]
        rng = _example_rng(seed, epoch, idx)
        img = load_image(
            f"{self.data_dir}/images/{key}.jpg", self.img_size, self.mode, rng
        )
        # Reference quirk: fixed *second* caption (dataset.py:50-52) — but only
        # meaningful when each image has several captions (COCO: 5).  With
        # CAPTIONS_PER_IMAGE=1 (the LN configs) index 1 would read the *next*
        # image's caption and overflow on the last one, so clamp to 0 there.
        sent_ix = 1 if self.caps_per_image > 1 else 0
        cap_idx = idx * self.caps_per_image + sent_ix
        cap, cap_len = self.get_caption(cap_idx)
        return {
            "imgs": img,
            "caps": cap,
            "cap_lens": cap_len,
            "cap_idx": cap_idx,  # index into the caption list / SBERT cache
            "keys": key,
            "mode": self.mode,
        }


class WordTextDataset(_TextDatasetBase):
    """Integer-token captions for the DAMSM RNN encoder (reference
    ``WordTextDataset``, ``dataset.py:82-113``)."""

    def _load_text_data(self, data_dir: str, mode: str) -> None:
        path = os.path.join(data_dir, "captions.pickle")
        with open(path, "rb") as f:
            train_caps, test_caps, i2w, w2i = pickle.load(f)[:4]
        self.captions = train_caps if mode == "train" else test_caps
        self.i2w, self.w2i = i2w, w2i
        self.voca_size = len(i2w)

    def get_caption(self, sent_ix: int) -> tuple[np.ndarray, int]:
        cap = np.asarray(self.captions[sent_ix], dtype=np.int64)
        x = np.zeros((self.max_length,), dtype=np.int64)
        x_len = min(len(cap), self.max_length)
        x[:x_len] = cap[:x_len]
        return x, x_len


class SentTextDataset(_TextDatasetBase):
    """Raw-string captions for the SBERT encoder (reference
    ``SentTextDataset``, ``dataset.py:115-136``)."""

    def _load_text_data(self, data_dir: str, mode: str) -> None:
        path = os.path.join(data_dir, "bert_captions.pickle")
        with open(path, "rb") as f:
            train_sents, test_sents = pickle.load(f)[:2]
        self.captions = train_sents if mode == "train" else test_sents

    def get_caption(self, sent_ix: int) -> tuple[str, int]:
        sent = self.captions[sent_ix]
        return sent, len(sent.split(" "))


class SyntheticDataset:
    """Deterministic synthetic images + integer captions for smoke tests and
    data-free benchmarking (no reference counterpart; SURVEY.md §7 step 6's
    'synthetic images, synthetic text embeddings' slice)."""

    def __init__(self, cfg, length: int = 512, mode: str = "train"):
        self.img_size = cfg.IMG.SIZE
        self.max_length = cfg.TEXT.MAX_LENGTH
        self.voca_size = cfg.TEXT.VOCA_SIZE
        self.length = length
        self.mode = mode
        # Distinct streams per split: the Trainer passes the same seed to the
        # train and test loaders, and without this salt test example i would
        # be bit-identical to train example i — synthetic FID "real" stats
        # would then be computed over data the model trained on, and no
        # train/test-leak regression could ever be detected on this dataset.
        self._seed_salt = 0 if mode == "train" else 1_000_003
        self.filenames = [f"synthetic_{mode}_{i:06d}" for i in range(length)]
        self.i2w = {i: f"tok{i}" for i in range(self.voca_size)}

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, args) -> dict[str, Any]:
        idx, epoch, seed = args if isinstance(args, tuple) else (args, 0, 0)
        rng = _example_rng(seed + self._seed_salt, epoch, idx)
        img = rng.integers(
            0, 256, (self.img_size, self.img_size, 3), dtype=np.uint8
        )
        cap_len = int(rng.integers(3, self.max_length + 1))
        cap = np.zeros((self.max_length,), np.int64)
        cap[:cap_len] = rng.integers(1, self.voca_size, cap_len)
        return {
            "imgs": img,
            "caps": cap,
            "cap_lens": cap_len,
            "keys": self.filenames[idx],
        }


# --------------------------------------------------------------------------- #
# Loader: sharded, shuffled, threaded-decode, fixed-size batches
# --------------------------------------------------------------------------- #


def _collate(examples: Sequence[dict]) -> dict[str, Any]:
    batch: dict[str, Any] = {}
    for k in examples[0]:
        vals = [e[k] for e in examples]
        if isinstance(vals[0], np.ndarray):
            batch[k] = np.stack(vals)
        elif isinstance(vals[0], (int, np.integer, float, np.floating)):
            batch[k] = np.asarray(vals)
        else:
            batch[k] = list(vals)  # strings / keys stay host-side lists
    return batch


class DataLoader:
    """Sharded, deterministic, threaded batch iterator.

    Replaces ``torch.utils.data.DataLoader(num_workers=8)`` (reference
    ``train_gan.py:456-457``).  Shuffling is a seeded permutation per epoch
    (identical on every host); each host then takes its ``shard`` slice, so the
    union over hosts is exactly one pass over the data with no overlap.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_threads: int = 8,
        shard: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.shard_index, self.shard_count = shard
        if batch_size % self.shard_count == 0:
            # batch_size is the *global* batch; each host produces its slice.
            self.local_batch = batch_size // self.shard_count
        else:
            raise ValueError(
                f"batch_size {batch_size} not divisible by shard_count {self.shard_count}"
            )
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the next iteration pass.

        ``start_batch`` skips the first N batches of the epoch *before* any
        decode work (mid-epoch crash resume: the trainer repositions the
        iterator to the exact batch the restored step count implies, so a
        resumed run consumes the same example sequence as an uninterrupted
        one).  Resets to 0 on every call — a skip applies to one pass.
        """
        self.epoch = epoch
        self.start_batch = start_batch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order[self.shard_index::self.shard_count]

    def __len__(self) -> int:
        if self.drop_last:
            # Every host must step the same number of times or collectives
            # deadlock: use the minimum shard size (shards differ by <= 1).
            return (len(self.dataset) // self.shard_count) // self.local_batch
        n = len(self._epoch_indices())
        return (n + self.local_batch - 1) // self.local_batch

    def first_batch(self) -> dict[str, Any]:
        """Collate the current epoch's first batch synchronously — no thread
        pool, no read-ahead.  For one-off consumers (e.g. the fixed sample
        grid): ``next(iter(loader))`` would submit ``depth`` batches of
        decodes to a fresh executor and then block on and discard them at
        generator close.  Does not consume ``start_batch``."""
        indices = self._epoch_indices()[: self.local_batch]
        epoch, seed = self.epoch, self.seed
        return _collate(
            [self.dataset[(int(i), epoch, seed)] for i in indices]
        )

    def __iter__(self) -> Iterator[dict[str, Any]]:
        indices = self._epoch_indices()
        nb = len(self)
        start, self.start_batch = min(self.start_batch, nb), 0  # one pass only
        if start:
            # skip whole batches index-side (no decode of skipped examples)
            indices = indices[start * self.local_batch :]
            nb -= start
        epoch, seed = self.epoch, self.seed

        def fetch(i: int) -> dict:
            return self.dataset[(int(i), epoch, seed)]

        if self.num_threads == 1:
            for b in range(nb):
                chunk = indices[b * self.local_batch : (b + 1) * self.local_batch]
                yield _collate([fetch(i) for i in chunk])
            return

        # Bounded pipeline: worker threads decode examples ahead of the
        # consumer; batches are emitted strictly in order.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_threads) as pool:
            pending: queue.Queue = queue.Queue()
            depth = 4  # batches in flight
            for b in range(min(depth, nb)):
                chunk = indices[b * self.local_batch : (b + 1) * self.local_batch]
                pending.put([pool.submit(fetch, i) for i in chunk])
            for b in range(nb):
                futures = pending.get()
                nxt = b + depth
                if nxt < nb:
                    chunk = indices[nxt * self.local_batch : (nxt + 1) * self.local_batch]
                    pending.put([pool.submit(fetch, i) for i in chunk])
                yield _collate([f.result() for f in futures])
