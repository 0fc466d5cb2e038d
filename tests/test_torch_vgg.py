"""The port's VGG-19 features (``models/vgg.py``) against the JAX package's
``xmc_gan_tpu.models.vgg.VGG19Features`` on shared random weights, the
weight files ``make_vgg`` reads, and one fp32 train step with
``ENCODER_LOSS.VGG`` against the JAX step (``tests/torch_step_parity.py``)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_step_parity import CFG_DIR, _merge, check_metrics, check_params, run_step
from xmc_gan_tpu.eval import save_fid_weights_npz
from xmc_gan_tpu.models.vgg import VGG19Features as JaxVGG
from xmc_gan_tpu.models.vgg import vgg19_params_from_torch
from xmc_gan_tpu_torch import train
from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.models.vgg import TAPS, VGG19Features, make_vgg, preprocess
from xmc_gan_tpu_torch.trainer import Trainer
from xmc_gan_tpu_torch.utils.convert import vgg_state_dict_from_jax

# port vs JAX in fp32: the same convolutions in another summation order
# (XLA's against oneDNN's) through up to 16 layers: 1e-5 relative and 1e-5
# of the features' largest magnitude
RTOL, ATOL_FRAC = 1e-5, 1e-5


def _images(seed, b=2, size=32):
    return np.random.RandomState(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _port(model, x):
    """NHWC numpy images -> the port's features (NCHW in channels_last memory)."""
    return model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_FRAC * np.abs(want).max())


@pytest.mark.parametrize("tap", ["relu5_4", "relu3_1", "relu1_1"])
def test_features_match_jax_through_the_jax_converter(tap):
    """The JAX module's random init carried across by
    ``vgg_state_dict_from_jax``; every tap of the port holds the whole tower."""
    x = _images(0)
    jv = JaxVGG(tap=tap)
    var = jax.tree.map(np.asarray, jv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jv.apply(var, jnp.asarray(x)))
    model = VGG19Features(tap=tap)
    missing = model.load_state_dict(vgg_state_dict_from_jax(var), strict=False).missing_keys
    assert len(missing) == 2 * (len(TAPS) - 1 - TAPS[tap])
    got = _port(model, x)
    assert got.dtype == np.float32 and got.shape == want.shape
    _close(got, want)


def test_features_match_jax_through_torchvision_names():
    """The port's own state_dict (torchvision's ``features.{i}`` names) read
    by the JAX package's ``vgg19_params_from_torch``: both compute the same
    features."""
    model = make_vgg(path="")
    x = _images(1)
    params = vgg19_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()})
    assert len(params["params"]) == 16
    want = np.asarray(JaxVGG().apply(params, jnp.asarray(x)))
    _close(_port(model, x), want)


def test_preprocess_matches_jax():
    from xmc_gan_tpu.models.vgg import preprocess as jax_preprocess

    x = _images(2)
    want = np.asarray(jax_preprocess(jnp.asarray(x)))
    model = VGG19Features()
    got = preprocess(torch.from_numpy(x).permute(0, 3, 1, 2), model.mean, model.std)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_vgg_is_frozen_and_passes_gradients_to_its_input():
    model = make_vgg(path="")
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    x = torch.from_numpy(_images(3)).permute(0, 3, 1, 2).requires_grad_()
    model(x).sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    assert all(p.grad is None for p in model.parameters())


def test_make_vgg_reads_npz_and_pth_and_logs_a_random_init(tmp_path):
    """``VGG_WEIGHTS_PATH`` as the JAX CLI's ``convert-vgg-weights`` writes it
    (``.npz``) or as a torchvision ``vgg19`` state_dict (``.pth``: its
    ``features.*`` loaded, ``classifier.*`` left); without a file a seeded
    random init, reported."""
    var = jax.tree.map(np.asarray,
                       JaxVGG().init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3))))
    npz = tmp_path / "vgg.npz"
    save_fid_weights_npz(var, str(npz))
    from_npz = make_vgg(path=str(npz))
    want = vgg_state_dict_from_jax(var)
    assert all(torch.equal(from_npz.state_dict()[k], v) for k, v in want.items())
    pth = tmp_path / "vgg19.pth"
    torch.save({**want, "classifier.0.weight": torch.zeros(4, 4)}, pth)
    from_pth = make_vgg(path=str(pth))
    assert all(torch.equal(from_pth.state_dict()[k], v) for k, v in want.items())
    messages = []
    a, b = make_vgg(path="", log=messages.append), make_vgg(path="")
    assert "random-init" in messages[0]
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())


def test_step_refuses_vgg_without_the_model():
    cfg = cfg_from_dict({"TRAIN": {"ENCODER_LOSS": {"VGG": True}}})
    step = train.make_train_step(cfg)
    with pytest.raises(ValueError, match="4th argument"):
        step(None, {}, None)


# df_gan_damsm_nomagp.yml with VGG on: D takes one Adam step, so its
# elements are held to check_params' bound for one step (with MAGP's second
# step, one of D's 2,048 first-block elements moves +2.09 lr in the port
# against -0.10 lr in JAX at these sizes, VGG on or off: a near-zero
# gradient's sign in both of D's Adam steps)
@pytest.fixture(scope="module")
def run(one_torch_thread):
    return run_step("df_gan_damsm_nomagp.yml", {"TRAIN": {"ENCODER_LOSS": {"VGG": True}}})


def test_vgg_step_metrics_match_jax(run):
    """``vgg_loss`` among the metrics, as in the JAX step, within its
    tolerance with every other metric."""
    assert "vgg_loss" in run["steps"][0]["port"]["metrics"]
    assert run["steps"][0]["port"]["metrics"]["vgg_loss"] > 0
    check_metrics(run)


def test_vgg_step_params_match_jax(run):
    check_params(run)


@pytest.mark.parametrize("over", [
    {"TRAIN": {"ENCODER_LOSS": {"VGG": True}}},
    {"GEN": {"ENCODER_NAME": "CONCEPT_INATTN_GEN"}},
    {"GEN": {"ENCODER_NAME": "CONCEPT_OUTATTN_GEN"}}], ids=["vgg", "inattn", "outattn"])
def test_trainer_takes_the_vgg_loss_and_the_word_attention_generators(over, tmp_path,
                                                                      one_torch_thread):
    """``Trainer.fit`` on the CPU at tiny width: with ``ENCODER_LOSS.VGG`` it
    builds the frozen VGG (a random init without ``VGG_WEIGHTS_PATH``, in the
    log) and passes it to every step; a word-attention generator trains
    from the synthetic captions' words.  Two steps, finite metrics."""
    name = "concept_in_df_gan.yml" if "GEN" in over else "df_gan_damsm_nomagp.yml"
    tiny = {"TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": 16, "BATCH_SIZE": 4, "HE_INIT": True},
            "IMG": {"SIZE": 64},
            "TEXT": {"EMBEDDING_DIM": 48, "MAX_LENGTH": 6, "VOCA_SIZE": 50, "ENCODER_DIR": ""}}
    cfg = cfg_from_dict(_merge(tiny, over), base=cfg_from_file(str(CFG_DIR / name)))
    tr = Trainer(cfg, seed=1, output_root=str(tmp_path), log_type="none", synthetic=True,
                 synthetic_len=8, save_after=10**9, eval_fid=False, device="cpu")
    metrics = tr.fit(max_epochs=1)
    assert tr.state.step == 2 and all(np.isfinite(v) for v in metrics.values())
    vgg = cfg.TRAIN.ENCODER_LOSS.VGG
    assert ("vgg_loss" in metrics) == vgg and (tr.vgg is not None) == vgg
    if vgg:
        assert "random-init VGG" in Path(tr.log_dir, "log.txt").read_text()
