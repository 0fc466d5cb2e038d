"""A seeded tiny RoBERTa checkpoint for the SBERT encoding tests, written by
``transformers`` itself (``RobertaTokenizer`` + ``RobertaModel``,
``pytorch_model.bin``): a byte-level vocabulary with BPE merges learned from
``CORPUS`` (so that the merge loop runs), hidden 32, 2 layers, 2 heads.
``hub_layout`` places it where ``from_pretrained("sentence-transformers/
stsb-roberta-base")`` and the port's ``hub_snapshot`` look."""

from __future__ import annotations

import os

# no hub request from transformers in this process: every load is local
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import json  # noqa: E402
import shutil  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

import regex  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402

from xmc_gan_tpu_torch.data.bpe import bytes_to_unicode

HIDDEN, LAYERS, HEADS, FFN, MAX_LEN = 32, 2, 2, 64, 16
N_MERGES = 300
GPT2_PATTERN = regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
CORPUS = [
    "In this image we can see a bird sitting on the branch of a tree.",
    "In this picture we can see a red bird and the sky in the background.",
    "There is a dog playing with a ball on the grass and there are trees.",
    "We can see two dogs running in the snow, and the sky is blue.",
    "In the kitchen there is a white stove, a plate of food and a table.",
    "A person is holding a cup of coffee in the café near the window.",
    "It's the bird's nest; they're sitting and we'll see the birds there.",
] * 3
SNAPSHOT = "0123456789abcdef0123456789abcdef01234567"  # any commit name


def learn_merges(corpus: list[str], n: int) -> list[tuple[str, str]]:
    """Byte-level BPE training: the most frequent pair, n times (ties by the
    pair's order)."""
    b2u = bytes_to_unicode()
    words = Counter(tuple(b2u[b] for b in tok.encode("utf-8"))
                    for s in corpus for tok in GPT2_PATTERN.findall(s))
    merges = []
    for _ in range(n):
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


def write_tiny_roberta(path: str | Path, seed: int = 0) -> str:
    """A complete checkpoint directory (tokenizer files, ``config.json``,
    ``pytorch_model.bin`` with the pooler, as HF saves it)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    merges = learn_merges(CORPUS, N_MERGES)
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for tok in [*bytes_to_unicode().values(), *(a + b for a, b in merges)]:
        vocab.setdefault(tok, len(vocab))
    vocab["<mask>"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    transformers.RobertaTokenizer(vocab_file=str(path / "vocab.json"),
                                  merges_file=str(path / "merges.txt")).save_pretrained(str(path))
    config = transformers.RobertaConfig(
        vocab_size=len(vocab), hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN, max_position_embeddings=MAX_LEN + 8,
        pad_token_id=1, bos_token_id=0, eos_token_id=2, type_vocab_size=1)
    torch.manual_seed(seed)
    transformers.RobertaModel(config).eval().save_pretrained(str(path), safe_serialization=False)
    return str(path)


def hub_layout(hub: str | Path, checkpoint: str | Path,
               name: str = "sentence-transformers/stsb-roberta-base") -> str:
    """``hub/models--{org}--{name}/{refs/main, snapshots/<commit>/...}`` holding
    a copy of ``checkpoint``; returns the snapshot directory."""
    repo = Path(hub) / ("models--" + name.replace("/", "--"))
    snap = repo / "snapshots" / SNAPSHOT
    shutil.copytree(checkpoint, snap, dirs_exist_ok=True)
    (repo / "refs").mkdir(parents=True, exist_ok=True)
    (repo / "refs" / "main").write_text(SNAPSHOT)
    return str(snap)

