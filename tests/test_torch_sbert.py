"""The port's Sentence-BERT path against the JAX package's: ``words_pooling``
and ``SBERTEncoder`` (``xmc_gan_tpu/models/encoder.py``), the cache reader
``SbertCache`` (``xmc_gan_tpu/data/text_encode.py``) and both SBERT branches
of ``make_encode_fn`` (``xmc_gan_tpu/trainer.py``): the cache on disk, and
the synthetic table, fed the JAX package's ``PRNGKey(42)`` table (the port
draws its own from a ``torch.Generator``).  Token embeddings come from numpy
seeds, with ragged masks and one all-padded row; the cache is a tiny
``.npz`` in ``tmp_path`` (``tests/test_text_encode.py``'s oracle).  fp32:
the masked mean and the norm are the same sums in another order, held to
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmc_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from xmc_gan_tpu.data.text_encode import SbertCache as JaxSbertCache
from xmc_gan_tpu.models.encoder import SBERTEncoder as JaxSBERTEncoder
from xmc_gan_tpu.models.encoder import words_pooling as jax_words_pooling
from xmc_gan_tpu.trainer import make_encode_fn as jax_make_encode_fn
from xmc_gan_tpu_torch import registry
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.data.text_encode import SbertCache
from xmc_gan_tpu_torch.models.encoder import SBERTEncoder, words_pooling
from xmc_gan_tpu_torch.trainer import make_encode_fn, make_sbert_table_encode, sbert_table

T, D, VOCAB = 8, 16, 30
TOL = 1e-6


def _overrides(bert_norm: bool) -> dict:
    return {"TEXT": {"TYPE": "SENT", "ENCODER_NAME": "SBERT", "EMBEDDING_DIM": D,
                     "MAX_LENGTH": T, "VOCA_SIZE": VOCAB, "BERT_NORM": bert_norm}}


def _cfgs(bert_norm: bool = False):
    over = _overrides(bert_norm)
    return jax_cfg_from_dict(over), cfg_from_dict(over)


def _tokens(seed=0, batch=5):
    """Token embeddings and an attention mask (1 = real): ragged lengths,
    row 2 all padding, row 4 all real."""
    rng = np.random.RandomState(seed)
    tok = rng.randn(batch, T, D).astype(np.float32)
    lens = np.array([3, 7, 0, 1, T])[:batch]
    attn = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    return tok, attn


@pytest.mark.parametrize("bert_norm", [False, True])
def test_sbert_encoder_matches_jax(bert_norm):
    """Words zeroed at padding, the masked mean over real tokens (divided by
    at least 1: the all-padded row pools to 0), the optional L2 norm (held
    at least 1e-12) and ``mask = attn == 0``."""
    jcfg, cfg = _cfgs(bert_norm)
    tok, attn = _tokens()
    jw, js, jm = JaxSBERTEncoder(jcfg).apply({}, jnp.asarray(tok), jnp.asarray(attn))
    words, sent, mask = SBERTEncoder(cfg)(torch.from_numpy(tok), torch.from_numpy(attn))
    assert words.dtype == sent.dtype == torch.float32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_allclose(words.numpy(), np.asarray(jw), rtol=0, atol=TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(js), rtol=0, atol=TOL)
    assert not bool(sent[2].any()) and not bool(words[2].any())
    if bert_norm:
        np.testing.assert_allclose(sent.norm(dim=1).numpy()[[0, 1, 3, 4]], 1.0, atol=1e-6)


def test_words_pooling_matches_jax_and_rejects_other_modes():
    tok, attn = _tokens(seed=3)
    mask = attn == 0
    words = tok * attn[..., None]
    want = np.asarray(jax_words_pooling(jnp.asarray(words), jnp.asarray(mask)))
    got = words_pooling(torch.from_numpy(words), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    with pytest.raises(NotImplementedError, match="POOLING_MODE"):
        words_pooling(torch.from_numpy(words), torch.from_numpy(mask), "CLS")
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="POOLING_MODE"):
        SBERTEncoder(cfg_from_dict({"TEXT": {"POOLING_MODE": "MAX"}}, base=cfg))(
            torch.from_numpy(tok), torch.from_numpy(attn))


@pytest.fixture()
def cache_dir(tmp_path):
    """``tests/test_text_encode.py``'s caches: fp16 token embeddings, uint8
    masks, 30 train and 10 test captions; test caption 4 all padded."""
    rng = np.random.RandomState(0)
    for mode, n in (("train", 30), ("test", 10)):
        attn = (rng.rand(n, T) > 0.3).astype(np.uint8)
        if mode == "test":
            attn[4] = 0
        np.savez(tmp_path / f"sbert_cache_{mode}.npz",
                 token_embs=rng.randn(n, T, D).astype(np.float16), attn_mask=attn)
    return str(tmp_path)


def test_sbert_cache_matches_jax(cache_dir):
    for mode in ("train", "test"):
        cache, jcache = SbertCache(cache_dir, mode), JaxSbertCache(cache_dir, mode)
        assert len(cache) == len(jcache)
        idx = [3, 7, 7, 0]
        tok16, attn8 = cache.rows(idx)  # what the encode path moves to the card
        assert tok16.dtype == np.float16 and attn8.dtype == np.uint8
        jtok, jattn = jcache(idx)
        np.testing.assert_array_equal(tok16.astype(np.float32), jtok)
        np.testing.assert_array_equal(attn8.astype(np.int32), jattn)
    with pytest.raises(FileNotFoundError, match="build_sbert_cache"):
        SbertCache(cache_dir + "/nope", "train")


@pytest.mark.parametrize("bert_norm", [False, True])
def test_cache_encode_matches_jax(cache_dir, bert_norm):
    """``make_encode_fn`` from disk: rows ``cap_idx`` of the cache of
    ``batch["mode"]`` (as the datasets give it: a list, one entry a row),
    one cache a split, the all-padded caption included."""
    jcfg, cfg = _cfgs(bert_norm)
    jenc = jax_make_encode_fn(jcfg, synthetic=False, data_dir=cache_dir)
    enc = make_encode_fn(cfg, device="cpu", data_dir=cache_dir)
    for mode, idx in (("test", [1, 4, 9]), ("train", [0, 29, 5, 5])):
        batch = {"cap_idx": np.array(idx), "mode": [mode] * len(idx)}
        for got, want in zip(enc(batch), jenc(batch)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="data_dir"):
        make_encode_fn(cfg, device="cpu")


def test_synthetic_encode_fed_the_jax_table_matches_jax():
    """The synthetic branch pools rows ``caps`` of a ``[VOCA_SIZE,
    EMBEDDING_DIM]`` table, id 0 padding; fed the JAX package's table it
    gives the JAX encoder's outputs.  The port's own table is seeded: two
    encoders agree, and it is N(0, 1) of the configured shape."""
    jcfg, cfg = _cfgs(bert_norm=True)
    rng = np.random.RandomState(4)
    caps = rng.randint(1, VOCAB, (4, T))
    caps[0, 3:] = 0
    caps[2] = 0
    batch = {"caps": caps, "cap_lens": (caps != 0).sum(1)}
    jtable = np.array(jax.random.normal(jax.random.PRNGKey(42), (VOCAB, D), jnp.float32))
    want = jax_make_encode_fn(jcfg, synthetic=True)(batch)
    got = make_sbert_table_encode(cfg, jtable, torch.device("cpu"))(batch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    table = sbert_table(cfg)
    assert table.shape == (VOCAB, D) and abs(table.std().item() - 1) < 0.2
    a, b = (make_encode_fn(cfg, device="cpu", synthetic=True)(batch) for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_registry_resolves_sbert_and_sent():
    from xmc_gan_tpu_torch.data.pipeline import SentTextDataset

    assert registry.get_text_encoder("SBERT") is SBERTEncoder
    assert registry.get_dataset("SENT") is SentTextDataset
