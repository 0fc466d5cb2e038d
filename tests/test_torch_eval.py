"""The port's FID path (``models/inception.py``, ``eval.py``) against the JAX
package's, on shared random weights (no pretrained Inception is here).

Inception weights are drawn with numpy into the JAX variables' shapes (only
the shapes come from the JAX module), with non-trivial BatchNorm statistics
so that a parity fault cannot hide behind an identity normalization, and
carried to the port by ``utils/convert.inception_state_dict_from_jax``.

Tolerances (fp32): the pool3 features to 1e-3 relative and 1e-4 absolute
(the JAX oracle test's, ``tests/test_eval.py``: ~100 convolutions summed in
another order); ``preprocess`` to 1e-4 absolute on [-1, 1] values (the same
triangle filter, weights computed in another order); the statistics' mean
and covariance to 1e-4 of their largest magnitude; ``fid_from_stats`` on the
same inputs to 1e-10 relative (the same host fp64 ``sqrtm``).  The end-to-end
FID number to 1e-3 relative (as ``tests/test_eval.py`` holds the JAX number
to the pytorch_fid transliteration).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread, jax_g_params, port_g, small_cfgs
from xmc_gan_tpu import eval as jax_eval
from xmc_gan_tpu.data import DataLoader as JaxDataLoader
from xmc_gan_tpu.data import SyntheticDataset as JaxSyntheticDataset
from xmc_gan_tpu.models.encoder import RNNEncoder as JaxRNNEncoder
from xmc_gan_tpu.models.inception import InceptionV3 as JaxInceptionV3
from xmc_gan_tpu.models.inception import inception_params_from_torch
from xmc_gan_tpu.models.inception import preprocess as jax_preprocess
from xmc_gan_tpu.train import make_sample_fn as jax_make_sample_fn
from xmc_gan_tpu_torch import eval as port_eval
from xmc_gan_tpu_torch.data import DataLoader, SyntheticDataset
from xmc_gan_tpu_torch.models.encoder import RNNEncoder
from xmc_gan_tpu_torch.models.inception import InceptionV3, preprocess
from xmc_gan_tpu_torch.utils.convert import (
    inception_state_dict_from_jax,
    rnn_encoder_state_dict,
)
from xmc_gan_tpu_torch.utils.miscc import count_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FEAT_RTOL, FEAT_ATOL = 1e-3, 1e-4
RESIZE_ATOL = 1e-4
STATS_SCALE = 1e-4
FID_RTOL = 1e-3


def _inception_variables(fid_variant: bool, seed: int) -> dict:
    x = jnp.zeros((1, 75, 75, 3))
    shapes = jax.eval_shape(JaxInceptionV3(fid_variant=fid_variant).init,
                            jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) * np.sqrt(2 / np.prod(s.shape[:-1]))  # He
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)  # bias, mean

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32),
                                            dict(shapes))


@pytest.fixture(scope="module")
def variables():
    return {fid: _inception_variables(fid, seed=3 + fid) for fid in (True, False)}


@pytest.mark.parametrize("fid_variant", [True, False])
def test_inception_matches_jax(fid_variant, variables):
    v = variables[fid_variant]
    model = InceptionV3(fid_variant=fid_variant)
    model.load_state_dict(inception_state_dict_from_jax(v), strict=True)
    x = np.random.RandomState(4).rand(2, 75, 75, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax.jit(JaxInceptionV3(fid_variant=fid_variant).apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048) and np.abs(want).mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=FEAT_RTOL, atol=FEAT_ATOL)


def test_inception_names_are_torchvision_and_the_trunk_count(variables):
    """The converter's names are the module's own, and JAX's
    ``inception_params_from_torch`` reads them back to the same variables;
    the trunk holds torchvision's 21,785,568 parameters (27,161,264 less fc
    and AuxLogits)."""
    sd = inception_state_dict_from_jax(variables[True])
    model = InceptionV3()
    assert set(sd) == set(model.state_dict())
    assert count_params(model) == 21_785_568
    back = inception_params_from_torch({k: v.numpy() for k, v in sd.items()})
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(dict(variables[True]))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(64, 64), (299, 299), (320, 300), (256, 256)])
def test_preprocess_matches_jax(hw):
    x = np.random.RandomState(5).rand(2, *hw, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax_preprocess(jnp.asarray(x)))
    got = preprocess(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_feature_stats_match_numpy_cov():
    feats = np.random.RandomState(0).randn(500, 16).astype(np.float32)
    st = port_eval.FeatureStats(16, device="cpu")
    for i in range(0, 500, 100):
        st.update(torch.from_numpy(feats[i : i + 100]))
    assert st.n == 500 and st._sum.dtype == st._outer.dtype == torch.float64
    mu, sigma = st.finalize()
    np.testing.assert_allclose(mu, feats.astype(np.float64).mean(0), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sigma, np.cov(feats.astype(np.float64), rowvar=False),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match=">= 2 samples"):
        port_eval.FeatureStats(4, device="cpu").finalize()


@pytest.mark.parametrize("shift", [0.0, 3.0, 0.7])
def test_fid_from_stats_matches_jax(shift):
    rng = np.random.RandomState(1)
    a = rng.randn(400, 8)
    b = a * 1.3 + shift + 0.2 * rng.randn(400, 8)
    stats = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    got, want = port_eval.fid_from_stats(*stats), jax_eval.fid_from_stats(*stats)
    assert got == pytest.approx(want, rel=1e-10, abs=1e-12)
    assert port_eval.fid_from_stats(*stats[:2], *stats[:2]) == pytest.approx(0.0, abs=1e-6)


def test_fid_weights_npz_loads_into_the_port(variables, tmp_path):
    """The JAX CLI's ``convert-fid-weights`` file: ``FidComputer`` reads it as
    pretrained weights (no standardization), and so does a ``.pth`` in
    torchvision's names with ``AuxLogits``/``fc`` tensors beside the trunk."""
    npz = str(tmp_path / "fid.npz")
    jax_eval.save_fid_weights_npz(variables[True], npz)
    from_npz = port_eval.FidComputer(weights_path=npz, device="cpu")
    assert from_npz.pretrained and from_npz._mu is None
    sd = inception_state_dict_from_jax(variables[True])
    sd.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000),
               "AuxLogits.fc.weight": torch.zeros(1000, 768)})
    pth = str(tmp_path / "fid.pth")
    torch.save(sd, pth)
    from_pth = port_eval.FidComputer(weights_path=pth, device="cpu")
    for a, b in zip(from_npz.model.state_dict().values(), from_pth.model.state_dict().values()):
        assert torch.equal(a, b)


class _StatsCounter:
    """A ``FidComputer`` stand-in that counts what reaches each statistic."""

    pretrained = False

    def stats(self):
        return {"n": 0}

    def update(self, stats, images):
        stats["n"] += int(np.asarray(images).shape[0])

    def fid(self, real, fake):
        return float(real["n"] * 1000 + fake["n"])


def test_fid_30k_cycles_the_test_split(tmp_path):
    """More samples than the split: the loader cycles with fresh noise for
    every batch; the real statistics cover the split exactly once."""
    _, cfg = small_cfgs({"TRAIN": {"NCH": 4, "NEF": 16, "NOISE_DIM": 8},
                         "IMG": {"SIZE": 64},
                         "TEXT": {"EMBEDDING_DIM": 16, "MAX_LENGTH": 6, "VOCA_SIZE": 40}})
    loader = DataLoader(SyntheticDataset(cfg, 8, "test"), 4, drop_last=True, num_threads=1)
    calls = []

    def noise_fn(i, n):
        calls.append(i)
        return torch.zeros(n, 8)

    sample = lambda noise, sent, words, mask: torch.zeros(noise.shape[0], 64, 64, 3)
    encode = lambda batch: (None, torch.zeros(len(batch["keys"]), 16), None)
    value = port_eval.evaluate_fid_30k(cfg, None, encode, loader, num_samples=20,
                                       fid=_StatsCounter(), sample_fn=sample, noise_fn=noise_fn)
    assert value == 8 * 1000 + 20 and calls == [0, 1, 2, 3, 4]


@pytest.fixture(scope="module")
def fid_run(variables, tmp_path_factory):
    """``evaluate_fid`` in both packages on the same G, text encoder and
    Inception weights (the ``.npz`` of the JAX CLI's format), the same test
    split and the JAX noise draw fed to the port: 2 batches of 4."""
    size, noise_dim, emb, T = 64, 8, 16, 6
    over = {"TRAIN": {"NCH": 4, "NEF": 32, "NOISE_DIM": noise_dim, "BATCH_SIZE": 4},
            "IMG": {"SIZE": size}, "DISC": {"IMG_MATCH": True},
            "TEXT": {"EMBEDDING_DIM": emb, "VOCA_SIZE": 40, "MAX_LENGTH": T}}
    jcfg, cfg = small_cfgs(over)
    g_params = jax_g_params(jcfg, seed=2)
    rng = np.random.RandomState(9)
    enc_shapes = jax.eval_shape(JaxRNNEncoder(jcfg).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, T), jnp.int32))["params"]
    enc_params = jax.tree.map(lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
                              dict(enc_shapes))
    npz = str(tmp_path_factory.mktemp("fid") / "fid.npz")
    jax_eval.save_fid_weights_npz(variables[True], npz)

    jenc = JaxRNNEncoder(jcfg)
    jencode = lambda b: jenc.apply({"params": enc_params}, jnp.asarray(b["caps"]),
                                   jnp.asarray(b["cap_lens"]))
    jfid = jax_eval.FidComputer(weights_path=npz)
    rec = {}

    def keep(tag, fid):
        def fid_fn(real, fake):
            rec[tag] = (real.finalize(all_reduce=False) if tag == "jax" else real.finalize(),
                        fake.finalize(all_reduce=False) if tag == "jax" else fake.finalize())
            return type(fid).fid(fid, real, fake)
        return fid_fn

    jfid.fid = keep("jax", jfid)
    jloader = JaxDataLoader(JaxSyntheticDataset(jcfg, 8, "test"), 4, drop_last=True,
                            num_threads=1)
    want = jax_eval.evaluate_fid(jcfg, g_params, jencode, jloader, num_samples=8, seed=5,
                                 fid=jfid, sample_fn=jax_make_sample_fn(jcfg))

    key, draws = jax.random.PRNGKey(5), []
    for _ in range(2):  # the JAX loop's draw: split, then normal of the new key
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(sub, (4, noise_dim)))))
    enc = RNNEncoder(cfg, gen=torch.Generator().manual_seed(0))
    enc.load_state_dict(rnn_encoder_state_dict(enc_params))
    enc = enc.eval()

    def encode(b):
        with torch.no_grad():
            return enc(torch.from_numpy(np.asarray(b["caps"])), torch.from_numpy(b["cap_lens"]))

    pfid = port_eval.FidComputer(weights_path=npz, device="cpu")
    pfid.fid = keep("port", pfid)
    loader = DataLoader(SyntheticDataset(cfg, 8, "test"), 4, drop_last=True, num_threads=1)
    got = port_eval.evaluate_fid(cfg, port_g(cfg, g_params), encode, loader, num_samples=8,
                                 fid=pfid, noise_fn=lambda i, n: draws[i])
    return want, got, rec


def test_evaluate_fid_statistics_match_jax(fid_run):
    _, _, rec = fid_run
    for side in (0, 1):  # real, fake
        for got, want in zip(rec["port"][side], rec["jax"][side]):
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=STATS_SCALE * scale)


def test_evaluate_fid_number_matches_jax(fid_run):
    want, got, _ = fid_run
    assert np.isfinite(want) and want > 0
    assert got == pytest.approx(want, rel=FID_RTOL)
