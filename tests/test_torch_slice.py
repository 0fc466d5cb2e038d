"""The port's serving slice end to end against the JAX package's: caption ids
-> ``make_encode_fn`` -> ``make_sample_fn`` -> NHWC images, with the same
encoder and G weights on both sides (seeded numpy values, saved as
reference-named ``.pth`` state_dicts, the format both packages load) and the
same numpy noise; then the port's CLI ``sample`` writing a PNG."""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from torch_port_helpers import JaxNetG, g_overrides, jax_g_params, small_cfgs
from xmc_gan_tpu.train import make_sample_fn as jax_make_sample_fn
from xmc_gan_tpu.trainer import make_encode_fn as jax_make_encode_fn
from xmc_gan_tpu_torch import cli
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.models.encoder import RNNEncoder
from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
from xmc_gan_tpu_torch.trainer import make_encode_fn
from xmc_gan_tpu_torch.utils.convert import df_gan_generator_state_dict

T = 6  # TEXT.MAX_LENGTH of g_overrides


def _save_encoder(path, overrides: dict, seed: int) -> None:
    """A reference-named ``RNN_ENCODER`` state_dict of seeded numpy values
    (embedding U(+-0.1), RNN weights U(+-0.3))."""
    names = RNNEncoder(cfg_from_dict(overrides), gen=torch.Generator()).state_dict()
    rng = np.random.RandomState(seed)
    sd = {k: torch.from_numpy(rng.uniform(-0.1 if k == "encoder.weight" else -0.3,
                                          0.1 if k == "encoder.weight" else 0.3,
                                          tuple(v.shape)).astype(np.float32))
          for k, v in names.items()}
    torch.save(sd, path)


def _caption_batch(seed: int):
    rng = np.random.RandomState(seed)
    lens = np.array([T, 1, 4], np.int64)
    caps = np.zeros((len(lens), T), np.int64)
    for i, n in enumerate(lens):
        caps[i, :n] = rng.randint(1, 40, n)
    return {"caps": caps, "cap_lens": lens}


@pytest.mark.parametrize("size,fuse", [(64, True), (64, False), (256, True), (256, False)])
def test_encode_and_sample_match_jax(size, fuse, tmp_path):
    """Tolerances: words/sent 1e-5 (fp32 gate math in another order); images
    2e-5, as the NetG test (XLA's and PyTorch's CPU convolutions sum in
    another order; the encoder's ~1e-7 differences add nothing visible)."""
    enc_path = tmp_path / "text_encoder.pth"
    over = g_overrides(size)
    over["TEXT"]["ENCODER_DIR"] = str(enc_path)
    jcfg, cfg = small_cfgs(over)
    _save_encoder(enc_path, over, seed=11)
    params = jax_g_params(jcfg, seed=5)
    g_path = tmp_path / "G.pth"
    torch.save(df_gan_generator_state_dict(params), g_path)
    batch = _caption_batch(12)
    noise = np.random.RandomState(13).randn(3, cfg.TRAIN.NOISE_DIM).astype(np.float32)

    jw, js, jm = jax_make_encode_fn(jcfg)(batch)
    want = np.asarray(jax_make_sample_fn(jcfg, JaxNetG(jcfg, fuse_upsample=fuse))(
        params, noise, js, jw, jm))

    words, sent, mask = make_encode_fn(cfg, device="cpu")(batch)
    g = make_generator(cfg, device="cpu", weights=str(g_path), fuse_upsample=fuse)
    got = make_sample_fn(cfg, g)(noise, sent, words, mask)

    np.testing.assert_allclose(words.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sent.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert got.shape == want.shape == (3, size, size, 3) and got.dtype == torch.float32
    assert np.mean(np.abs(want) > 0.99) < 0.5  # not saturated: the test has teeth
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_sampler_turns_tf32_off_once(monkeypatch):
    """Building the sampler turns TF32 off (full fp32 convolutions, as in
    the JAX package); a call leaves a caller's later choice alone."""
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", True)
    _, cfg = small_cfgs(g_overrides(64))
    sample = make_sample_fn(cfg, device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    rng = np.random.RandomState(0)
    img = sample(rng.randn(2, cfg.TRAIN.NOISE_DIM).astype(np.float32),
                 rng.randn(2, cfg.TEXT.EMBEDDING_DIM).astype(np.float32))
    assert img.shape == (2, 64, 64, 3)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


WORDS = ["<pad>", "a", "red", "bird", "on", "branch", "two", "dogs", "in", "snow"]


@pytest.fixture
def tiny_dataset(tmp_path):
    """A YAML config of the reference schema and a ``captions.pickle``
    (``(train_caps, test_caps, i2w, w2i)``) with a ten-word vocabulary."""
    w2i = {w: i for i, w in enumerate(WORDS)}
    with open(tmp_path / "captions.pickle", "wb") as f:
        pickle.dump(([[1, 2, 3]], [[6, 7]], dict(enumerate(WORDS)), w2i), f)
    over = g_overrides(64)
    over["TEXT"]["VOCA_SIZE"] = len(WORDS)
    (tmp_path / "tiny.yml").write_text(yaml.safe_dump({"CONFIG_NAME": "tiny", **over}))
    return tmp_path


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cli_sample_writes_png(tiny_dataset, dtype):
    out = tiny_dataset / "grid.png"
    argv = ["sample", "--cfg", str(tiny_dataset / "tiny.yml"), "--data_dir", str(tiny_dataset),
            "--caption", "A red bird on a branch", "--caption", "two dogs in the snow",
            "--n_per_caption", "3", "--dtype", dtype, "--device", "cpu", "--out", str(out)]
    with pytest.warns(UserWarning, match="random"):
        assert cli.main(argv) == 0
    img = np.asarray(Image.open(out))
    # 2 captions x 3 samples of 64x64, 2-pixel padding
    assert img.shape == (2 * 66 + 2, 3 * 66 + 2, 3) and img.dtype == np.uint8
    assert img[2:66, 2:66].std() > 0


def test_cli_sample_needs_cuda_unless_cpu_is_asked(tiny_dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["sample", "--cfg", str(tiny_dataset / "tiny.yml"), "--data_dir", str(tiny_dataset),
            "--caption", "a red bird", "--out", str(tiny_dataset / "x.png")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not (tiny_dataset / "x.png").exists()


def test_cli_sample_rejects_out_of_vocabulary_caption(tiny_dataset):
    argv = ["sample", "--cfg", str(tiny_dataset / "tiny.yml"), "--data_dir", str(tiny_dataset),
            "--caption", "zebra giraffe", "--device", "cpu"]
    with pytest.raises(ValueError, match="No in-vocabulary words"):
        cli.main(argv)


@pytest.mark.parametrize("name", ["CONCEPT_IN_DF_GEN", "CONCEPT_INATTN_GEN"])
def test_cli_sample_serves_a_concept_yaml(tiny_dataset, name):
    """``xmc_gan_tpu/cfg/concept_in_df_gan.yml`` cut to the tiny dataset's
    sizes, with either concept family's generator: the CLI needs no new flag
    (it hands the words and their mask on)."""
    with open(Path(__file__).resolve().parents[1] / "xmc_gan_tpu/cfg/concept_in_df_gan.yml") as f:
        doc = yaml.safe_load(f)
    over = g_overrides(64)
    for section, values in over.items():
        doc[section].update(values)
    doc["TEXT"]["VOCA_SIZE"] = len(WORDS)
    doc["GEN"]["ENCODER_NAME"] = name
    (tiny_dataset / "concept.yml").write_text(yaml.safe_dump(doc))
    out = tiny_dataset / "concept.png"
    argv = ["sample", "--cfg", str(tiny_dataset / "concept.yml"), "--data_dir",
            str(tiny_dataset), "--caption", "a red bird", "--caption", "two dogs in snow",
            "--n_per_caption", "2", "--device", "cpu", "--out", str(out)]
    with pytest.warns(UserWarning, match="random"):
        assert cli.main(argv) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (2 * 66 + 2, 2 * 66 + 2, 3) and img[2:66, 2:66].std() > 0
