"""Offline Sentence-BERT encoding (the port's copy of
``xmc_gan_tpu/data/text_encode.py``): the encode and cache-building
functions and the cache reader.

The reference runs ``SentenceTransformer('stsb-roberta-base')`` inside the
train loop (``encoder.py:41-48``); the JAX package and the port encode every
caption once, offline, into a cache at the dataset root, next to
``bert_captions.pickle``:

    ``sbert_cache_train.npz`` / ``sbert_cache_test.npz``
        token_embs: float16 [N, MAX_LENGTH, 768]
        attn_mask:  uint8   [N, MAX_LENGTH] (1 = real token)

and the train step pools those rows (``models/encoder.SBERTEncoder``).
``make_hf_sbert_encode`` encodes captions that no cache holds (``cli
sample``) and ``build_sbert_cache`` writes the caches (``cli prep-ln
--build_cache``), both with the port's own tokenizer (``data/bpe.py``) and
RoBERTa encoder (``models/roberta.py``), on the card unless the CPU is
asked for.  The weights are a RoBERTa checkpoint directory (``config.json``,
``pytorch_model.bin``, ``vocab.json``, ``merges.txt``): ``model_path``, or
``sentence-transformers/stsb-roberta-base`` in the local HF hub cache, where
the JAX package's ``from_pretrained`` looks.  They are not in the repository.
``SbertCache`` reads a cache with numpy only.
"""

from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from xmc_gan_tpu_torch.data.bpe import ByteLevelBPETokenizer
from xmc_gan_tpu_torch.device import resolve_device, to_device
from xmc_gan_tpu_torch.models.roberta import RobertaModel, load_roberta

SBERT_MODEL = "sentence-transformers/stsb-roberta-base"

__all__ = ["SBERT_MODEL", "SbertCache", "SbertEncode", "build_sbert_cache", "hub_snapshot",
           "make_hf_sbert_encode"]


def hub_cache_dir() -> str:
    """The HF hub cache: ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
        "huggingface")
    return os.path.join(home, "hub")


def hub_snapshot(name: str = SBERT_MODEL) -> str:
    """The directory of ``name``'s ``main`` snapshot in the hub cache
    (``models--{org}--{name}/snapshots/<refs/main>``); it may not exist."""
    repo = os.path.join(hub_cache_dir(), "models--" + name.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as f:
            commit = f.read().strip()
    except OSError:
        return os.path.join(repo, "snapshots", "main")
    return os.path.join(repo, "snapshots", commit)


@contextlib.contextmanager
def _fp32_products():
    """TF32 off for the encoder's products (the JAX forward is fp32), the
    process's flags as they were afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class SbertEncode:
    """``sents -> (token_embs, attn_mask)``: fp32 ``[N, T, hidden]`` and int64
    ``[N, T]`` numpy arrays (``T = TEXT.MAX_LENGTH``), as the JAX package's
    encode function returns them; ``tokenize`` (host) and ``forward`` (the
    encoder on its device, fp32 tensors there) are its two halves."""

    def __init__(self, tokenizer: ByteLevelBPETokenizer, model: RobertaModel, max_length: int):
        self.tokenizer = tokenizer
        self.model = model
        self.max_length = max_length
        self.device = next(model.parameters()).device

    def tokenize(self, sents: list[str]) -> tuple[np.ndarray, np.ndarray]:
        return self.tokenizer(list(sents), self.max_length)

    @torch.no_grad()
    def forward(self, input_ids, attention_mask) -> torch.Tensor:
        with _fp32_products():
            return self.model(to_device(input_ids, self.device),
                              to_device(attention_mask, self.device))

    def __call__(self, sents: list[str]) -> tuple[np.ndarray, np.ndarray]:
        ids, mask = self.tokenize(sents)
        return self.forward(ids, mask).cpu().numpy(), mask


def make_hf_sbert_encode(cfg, model_path: str | None = None,
                         device: str | torch.device | None = None) -> SbertEncode:
    """The encode function of ``xmc_gan_tpu/data/text_encode.py:33-74`` on
    ``device`` (default ``cuda``; see ``device.resolve_device``).
    ``model_path`` is a RoBERTa checkpoint directory; without it the
    ``stsb-roberta-base`` snapshot of the local hub cache (``hub_snapshot``).
    Raises the JAX package's ``RuntimeError`` where the files are not there."""
    dev = resolve_device(device)
    name = model_path or SBERT_MODEL
    path = model_path or hub_snapshot()
    try:
        tokenizer = ByteLevelBPETokenizer.from_dir(path)
        model = load_roberta(path, dev)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"Could not load {name!r} weights locally. Download them on "
            "a machine with network access (huggingface-cli download "
            f"{name}) or build the cache there and copy "
            "sbert_cache_*.npz next to bert_captions.pickle."
        ) from e
    return SbertEncode(tokenizer, model, cfg.TEXT.MAX_LENGTH)


def build_sbert_cache(
    data_dir: str, cfg, modes=("train", "test"), batch_size: int = 256,
    model_path: str | None = None, device: str | torch.device | None = None,
) -> None:
    """Encode every caption in ``bert_captions.pickle`` and write the per-mode
    ``.npz`` caches (``xmc_gan_tpu/data/text_encode.py:77-98``; reference data
    format, ``dataset.py:119-127``)."""
    encode = make_hf_sbert_encode(cfg, model_path=model_path, device=device)
    with open(os.path.join(data_dir, "bert_captions.pickle"), "rb") as f:
        train_sents, test_sents = pickle.load(f)[:2]
    per_mode = {"train": train_sents, "test": test_sents}
    for mode in modes:
        sents = per_mode[mode]
        embs_out, mask_out = [], []
        for i in range(0, len(sents), batch_size):
            e, m = encode(list(sents[i : i + batch_size]))
            embs_out.append(e.astype(np.float16))
            mask_out.append(m.astype(np.uint8))
        np.savez(
            os.path.join(data_dir, f"sbert_cache_{mode}.npz"),
            token_embs=np.concatenate(embs_out),
            attn_mask=np.concatenate(mask_out),
        )


class SbertCache:
    """One split's cache, read into host memory once (an ``.npz`` member is
    not memory-mapped), indexed by the caption index the datasets compute
    (``cap_idx = idx * CAPTIONS_PER_IMAGE + sent_ix``)."""

    def __init__(self, data_dir: str, mode: str):
        path = os.path.join(data_dir, f"sbert_cache_{mode}.npz")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} not found — build it with "
                "xmc_gan_tpu_torch.data.text_encode.build_sbert_cache() (or `cli prep-ln "
                "--build_cache`; needs the RoBERTa weights), or copy a prebuilt cache next to "
                "bert_captions.pickle")
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
