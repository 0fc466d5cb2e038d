"""RoBERTa's byte-level BPE tokenizer, in plain Python (the port's copy of what
the JAX package's ``make_hf_sbert_encode`` gets from ``AutoTokenizer``,
``xmc_gan_tpu/data/text_encode.py:44,67-70``).

It reads ``vocab.json`` and ``merges.txt`` from a RoBERTa checkpoint
directory and gives the ids and the attention mask of

    tokenizer(sents, padding="max_length", truncation=True,
              max_length=T, return_tensors="np")

(GPT-2's byte-level BPE, as ``RobertaTokenizer`` and ``RobertaTokenizerFast``
apply it):

1. the literal special-token strings (``<s>``, ``</s>``, ``<pad>``,
   ``<unk>``, ``<mask>``) are split out first; ``<mask>`` takes the
   whitespace before it (``lstrip``);
2. each other piece is cut by GPT-2's pre-tokenizer pattern
   ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
   here a scanner over ``unicodedata.category`` (no ``regex`` package), with
   no prefix space;
3. each pre-token's UTF-8 bytes map to GPT-2's printable byte characters
   and are merged pair by pair in the order of ``merges.txt`` (a cache per
   pre-token);
4. ``<s> ... </s>`` around the first T - 2 tokens, right padding with the
   pad id, a mask of 1 at every real and special token.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache

import numpy as np

__all__ = ["ByteLevelBPETokenizer", "bytes_to_unicode", "pre_tokenize"]

SPECIAL_TOKENS = ("<s>", "</s>", "<pad>", "<unk>", "<mask>")
# special tokens that take the whitespace before them (RobertaTokenizer's
# AddedToken(mask_token, lstrip=True))
LSTRIP_TOKENS = ("<mask>",)
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # the pattern's order
# \s of the pattern: Unicode's White_Space property
WHITESPACE = frozenset("\t\n\v\f\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                       + "".join(map(chr, range(0x2000, 0x200B))))


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's table of the 256 bytes to printable characters: the printable
    Latin-1 bytes stand for themselves, the others take 256 and up in order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=65536)
def _kind(c: str) -> str:
    """The pattern's class of one character: L(etter), N(umber), S(pace) or O(ther)."""
    if c in WHITESPACE:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def pre_tokenize(text: str) -> list[str]:
    """``text`` cut as GPT-2's pattern cuts it (leftmost match, the first
    alternative that matches, greedy runs)."""
    out = []
    n = len(text)
    kinds = [_kind(c) for c in text]
    i = 0
    while i < n:
        if text[i] == "'":
            s = next((s for s in CONTRACTIONS if text.startswith(s, i + 1)), None)
            if s is not None:
                out.append(text[i:i + 1 + len(s)])
                i += 1 + len(s)
                continue
        if text[i] == " " and i + 1 < n and kinds[i + 1] != "S":
            kind, j = kinds[i + 1], i + 1  # ' ?' then a run of the next character's class
        elif kinds[i] != "S":
            kind, j = kinds[i], i
        else:
            # \s+(?!\S): the run of whitespace but its last character where
            # a non-space follows; \s+: a single one there
            j = i
            while j < n and kinds[j] == "S":
                j += 1
            if j < n and j - i >= 2:
                j -= 1
            out.append(text[i:j])
            i = j
            continue
        while j < n and kinds[j] == kind:
            j += 1
        out.append(text[i:j])
        i = j
    return out


class ByteLevelBPETokenizer:
    """RoBERTa's tokenizer from a checkpoint directory (``vocab.json``,
    ``merges.txt``); ``__call__(sents, max_length)`` gives ``(input_ids,
    attention_mask)``, both int64 ``[N, max_length]``."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.vocab = vocab
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        missing = [t for t in ("<s>", "</s>", "<pad>") if t not in vocab]
        if missing:
            raise ValueError(f"the vocabulary has no {missing}")
        self.bos, self.eos, self.pad = vocab["<s>"], vocab["</s>"], vocab["<pad>"]
        self.unk = vocab.get("<unk>")
        self.specials = {t: vocab[t] for t in SPECIAL_TOKENS if t in vocab}
        self._split = re.compile(
            "(" + "|".join(map(re.escape, sorted(self.specials, key=len, reverse=True))) + ")")
        self.byte_encoder = bytes_to_unicode()
        self.cache: dict[str, tuple[int, ...]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPETokenizer":
        vocab_file, merges_file = os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
        for f in (vocab_file, merges_file):
            if not os.path.isfile(f):
                raise FileNotFoundError(f"{f} not found (a RoBERTa checkpoint directory holds it)")
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for n, line in enumerate(f.read().split("\n")):
                if (n == 0 and line.startswith("#version")) or not line.strip():
                    continue
                pair = line.split()
                if len(pair) != 2:
                    raise ValueError(f"{merges_file}:{n + 1}: not a merge: {line!r}")
                merges.append(tuple(pair))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> tuple[int, ...]:
        """The ids of one pre-token: its bytes as GPT-2's characters, merged
        lowest rank first, every occurrence of the pair at once."""
        ids = self.cache.get(token)
        if ids is not None:
            return ids
        word = [self.byte_encoder[b] for b in token.encode("utf-8")]
        ranks = self.ranks
        while len(word) > 1:
            best, best_rank = None, None
            for pair in zip(word, word[1:]):
                r = ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = tuple(self.vocab.get(w, self.unk) for w in word)
        if None in ids:
            raise ValueError(f"{token!r}: a token not in the vocabulary and no <unk>")
        self.cache[token] = ids
        return ids

    def tokenize(self, text: str) -> list[int]:
        """The ids of ``text`` without ``<s>``/``</s>``."""
        pieces = self._split.split(text)  # odd indices: the special tokens
        for i in range(1, len(pieces), 2):
            if pieces[i] in LSTRIP_TOKENS:
                pieces[i - 1] = pieces[i - 1].rstrip()
        ids: list[int] = []
        for i, piece in enumerate(pieces):
            if i % 2:
                ids.append(self.specials[piece])
            elif piece:
                for token in pre_tokenize(piece):
                    ids.extend(self._bpe(token))
        return ids

    def __call__(self, sents: list[str], max_length: int) -> tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(sents), max_length), self.pad, np.int64)
        mask = np.zeros((len(sents), max_length), np.int64)
        for row, sent in enumerate(sents):
            toks = [self.bos, *self.tokenize(sent)[:max_length - 2], self.eos]
            ids[row, :len(toks)] = toks
            mask[row, :len(toks)] = 1
        return ids, mask
