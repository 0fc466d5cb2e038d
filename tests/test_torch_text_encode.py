"""The port's SBERT encode and cache functions against the JAX package's on the CPU
(``data/bpe.py``, ``models/roberta.py``, ``data/text_encode.py``).

One seeded tiny RoBERTa checkpoint (``torch_sbert_helpers``: hidden 32, 2
layers, T = 16, 155 BPE merges learned from a small corpus) goes through the JAX
``make_hf_sbert_encode`` (``AutoTokenizer`` + ``FlaxRobertaModel``
``from_pt``) and through the port:

* the tokenizer's ids and masks equal ``AutoTokenizer``'s (what the JAX
  function calls) and ``RobertaTokenizer``'s on captions with accents, an
  emoji, digits, runs of spaces, apostrophes, a literal ``<mask>`` and
  other special strings, and one longer than T;
* the embeddings are within ``EMB_TOL`` (fp32; the two differ only in the
  order of the sums) of JAX's, padding positions included;
* ``build_sbert_cache``'s ``.npz`` against JAX's: masks equal, fp16 within
  one ulp; ``SbertCache`` reads it back;
* ``load_roberta`` raises, naming the file and the key, on what it cannot
  take; ``make_hf_sbert_encode`` finds the hub snapshot through the HF
  cache variables and raises JAX's error where nothing is there.
"""

import json
import pickle
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_sbert_helpers import (CORPUS, GPT2_PATTERN, HIDDEN, MAX_LEN, N_MERGES, hub_layout,
                                learn_merges, write_tiny_roberta)
import transformers

from xmc_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from xmc_gan_tpu.data import text_encode as jax_te
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.data import text_encode as te
from xmc_gan_tpu_torch.data.bpe import ByteLevelBPETokenizer, pre_tokenize
from xmc_gan_tpu_torch.models.roberta import load_roberta

TEXT = {"ENCODER_NAME": "SBERT", "TYPE": "SENT", "EMBEDDING_DIM": HIDDEN,
        "MAX_LENGTH": MAX_LEN, "POOLING_MODE": "MEAN", "BERT_NORM": False}
CAPTIONS = [
    "In this image we can see a bird sitting on the branch of a tree.",
    "A café with crème brûlée, naïve façade and Ångström",
    "a dog 🐕 plays with 3 balls, 42 sticks and 1000 leaves",
    "two   dogs\tplaying  in the snow  ",
    "it's the bird's nest; they're here and we'll see IT'S",
    "a photo of a <mask> on the table <s>x</s><pad>",
    "There is a dog playing with a ball on the grass and there are trees behind it.",
    "",
]
EMB_TOL = {"rtol": 1e-5, "atol": 5e-6}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_tiny_roberta(tmp_path_factory.mktemp("tiny_roberta"))


@pytest.fixture(scope="module")
def jax_encode(ckpt):
    return jax_te.make_hf_sbert_encode(jax_cfg_from_dict({"TEXT": TEXT}), model_path=ckpt)


@pytest.fixture(scope="module")
def port_encode(ckpt):
    return te.make_hf_sbert_encode(cfg_from_dict({"TEXT": TEXT}), model_path=ckpt, device="cpu")


@pytest.mark.parametrize("which", ["AutoTokenizer", "RobertaTokenizer"])
def test_tokenizer_matches_hf(ckpt, jax_encode, port_encode, which):
    """Ids and masks as the JAX path tokenizes (``text_encode.py:67-70``);
    the masks also as the JAX encode function returns them.  The captions
    take real merges, the truncation and the special strings."""
    hf = getattr(transformers, which).from_pretrained(ckpt)
    want = hf(CAPTIONS, padding="max_length", truncation=True, max_length=MAX_LEN,
              return_tensors="np")
    ids, mask = port_encode.tokenize(CAPTIONS)
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])
    np.testing.assert_array_equal(mask, jax_encode(CAPTIONS)[1])
    vocab = port_encode.tokenizer.vocab
    assert ((ids >= 4 + 256) & (ids < vocab["<mask>"])).any()  # merged tokens
    assert vocab["<mask>"] in ids[5] and mask[6].all() and ids[6, -1] == vocab["</s>"]


def test_pre_tokenize_matches_the_pattern():
    """The scanner against GPT-2's pattern (``regex``) on random strings of
    the characters and runs it tells apart."""
    rng = random.Random(0)
    parts = list("ab cd'sStT\t\n\r\xa0é1２3!.,🐕́ｌ　 ") + [
        "'s", "'ll", "'re", "'ve", "'m", "'d", "  ", "   ", "bird", " 42"]
    for _ in range(3000):
        s = "".join(rng.choice(parts) for _ in range(rng.randint(0, 14)))
        assert pre_tokenize(s) == GPT2_PATTERN.findall(s), repr(s)


def test_encoder_matches_jax(jax_encode, port_encode):
    want, want_mask = jax_encode(CAPTIONS)
    got, mask = port_encode(CAPTIONS)
    assert got.dtype == np.float32 and got.shape == (len(CAPTIONS), MAX_LEN, HIDDEN)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_allclose(got, want, **EMB_TOL)


def test_cache_matches_jax(ckpt, tmp_path):
    """Both packages' ``build_sbert_cache`` on one ``bert_captions.pickle``
    (batches of 3, so a ragged last one): masks equal, fp16 within one ulp;
    the port's ``SbertCache`` reads the rows back."""
    dirs = {}
    for name, build, cfg, kw in (
            ("jax", jax_te.build_sbert_cache, jax_cfg_from_dict({"TEXT": TEXT}), {}),
            ("port", te.build_sbert_cache, cfg_from_dict({"TEXT": TEXT}), {"device": "cpu"})):
        d = dirs[name] = tmp_path / name
        d.mkdir()
        with open(d / "bert_captions.pickle", "wb") as f:
            pickle.dump([CAPTIONS, CAPTIONS[:5]], f)
        build(str(d), cfg, batch_size=3, model_path=ckpt, **kw)
    for mode, n in (("train", len(CAPTIONS)), ("test", 5)):
        want = np.load(dirs["jax"] / f"sbert_cache_{mode}.npz")
        got = np.load(dirs["port"] / f"sbert_cache_{mode}.npz")
        assert got["token_embs"].dtype == np.float16 and got["attn_mask"].dtype == np.uint8
        assert got["token_embs"].shape == (n, MAX_LEN, HIDDEN)
        np.testing.assert_array_equal(got["attn_mask"], want["attn_mask"])
        a, b = got["token_embs"], want["token_embs"]
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(a.astype(np.float32) - b.astype(np.float32)) <= ulp).all()
        tok, attn = te.SbertCache(str(dirs["port"]), mode).rows(np.arange(n)[::-1])
        np.testing.assert_array_equal(tok, a[::-1])
        np.testing.assert_array_equal(attn, got["attn_mask"][::-1])


def _weights(ckpt) -> dict:
    return torch.load(f"{ckpt}/pytorch_model.bin", weights_only=True)


@pytest.mark.parametrize("case", ["roberta_prefix", "position_ids", "missing_key",
                                  "unexpected_key", "shape", "missing_file", "hidden_act"])
def test_load_roberta_keys_and_errors(ckpt, tmp_path, case):
    """``roberta.``-prefixed keys and the ``position_ids`` buffer load; a
    missing or unexpected key, a shape the config does not give, a missing
    file or an activation other than GELU raise, naming the file and key."""
    d = tmp_path / "ckpt"
    shutil.copytree(ckpt, d)
    sd = _weights(ckpt)
    base = load_roberta(ckpt)
    if case == "roberta_prefix":
        sd = {f"roberta.{k}": v for k, v in sd.items()}
    elif case == "position_ids":
        sd["embeddings.position_ids"] = torch.arange(MAX_LEN + 8)[None]
    elif case == "missing_key":
        del sd["encoder.layer.1.output.dense.bias"]
    elif case == "unexpected_key":
        sd["lm_head.dense.weight"] = torch.zeros(2, 2)
    elif case == "shape":
        sd["encoder.layer.0.intermediate.dense.weight"] = torch.zeros(3, HIDDEN)
    elif case == "missing_file":
        (d / "pytorch_model.bin").unlink()
    elif case == "hidden_act":
        cfg = json.loads((d / "config.json").read_text())
        (d / "config.json").write_text(json.dumps({**cfg, "hidden_act": "gelu_new"}))
    if case not in ("missing_file", "hidden_act"):
        torch.save(sd, d / "pytorch_model.bin")
    want = {"missing_key": (ValueError, r"pytorch_model.bin.*missing key "
                                        r"'encoder.layer.1.output.dense.bias'"),
            "unexpected_key": (ValueError, r"pytorch_model.bin.*unexpected key "
                                           r"'lm_head.dense.weight'"),
            "shape": (ValueError, r"pytorch_model.bin.*'encoder.layer.0.intermediate.dense"),
            "missing_file": (FileNotFoundError, r"pytorch_model.bin not found"),
            "hidden_act": (ValueError, r"config.json.*gelu_new")}.get(case)
    if want is not None:
        with pytest.raises(want[0], match=want[1]):
            load_roberta(str(d))
        return
    got = load_roberta(str(d))
    for (k, a), b in zip(base.state_dict().items(), got.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("where", ["HF_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME", "HOME"])
def test_make_hf_sbert_encode_finds_the_hub_snapshot(ckpt, port_encode, tmp_path, monkeypatch,
                                                     where):
    """``model_path=None`` reads ``stsb-roberta-base``'s ``refs/main``
    snapshot where ``from_pretrained`` would look for it."""
    for var in ("HF_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    root = tmp_path / "root"
    hub = {"HF_HUB_CACHE": root, "HF_HOME": root / "hub", "XDG_CACHE_HOME":
           root / "huggingface" / "hub", "HOME": root / ".cache" / "huggingface" / "hub"}[where]
    hub_layout(hub, ckpt)
    monkeypatch.setenv(where, str(root))
    encode = te.make_hf_sbert_encode(cfg_from_dict({"TEXT": TEXT}), device="cpu")
    got, mask = encode(CAPTIONS[:3])
    want, want_mask = port_encode(CAPTIONS[:3])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mask, want_mask)


@pytest.mark.parametrize("layout", ["empty", "no_weights"])
def test_make_hf_sbert_encode_raises_the_jax_error_without_weights(ckpt, tmp_path, monkeypatch,
                                                                   layout):
    hub = tmp_path / "hub"
    hub.mkdir()
    if layout == "no_weights":
        (Path(hub_layout(hub, ckpt)) / "pytorch_model.bin").unlink()
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    with pytest.raises(RuntimeError, match=r"Could not load 'sentence-transformers/"
                                           r"stsb-roberta-base' weights locally") as e:
        te.make_hf_sbert_encode(cfg_from_dict({"TEXT": TEXT}), device="cpu")
    assert isinstance(e.value.__cause__, FileNotFoundError)


def test_tokenizer_reads_the_checkpoint_files(ckpt):
    tok = ByteLevelBPETokenizer.from_dir(ckpt)
    merges = learn_merges(CORPUS, N_MERGES)
    assert len(merges) > 100 and list(tok.ranks) == merges
    assert (tok.bos, tok.pad, tok.eos) == (0, 1, 2)
    ids, mask = tok(["a bird"] * 2, 4)
    assert ids.dtype == np.int64 and ids.shape == (2, 4) and mask.tolist() == [[1, 1, 1, 1]] * 2
