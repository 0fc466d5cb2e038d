"""The port's train step at the LN-COCO config against the JAX package's.

``xmc_gan_tpu/cfg/ln_coco_256.yml`` (DF_GEN + DF_DISC, NOISE_DIM = 128,
NEF = 256, spectral norm, IMG_MATCH, RMIS, MAGP, SENT + DISC + WORD +
B_GLOBAL, SMOOTH.GLOBAL = 0, GEN.NORMALIZE) read by each package's own
config loader, cut to IMG.SIZE 64, NCH 8 and batch 4 with the word shape
kept: T = 200 word slots of width 768.  The port's step takes the kernel
route for its word scores, as it does on the card (``word_block_elems=0``,
with ``losses.word_scores_backend`` reading the CPU tensors as CUDA ones),
which on the CPU runs the plain version of each 16-slot sub-caption of
real words (``damsm_score.split_captions``), the split the card runs; the JAX step
scores the whole captions with its XLA path.  One JAX train state (perturbed weights)
is carried across by ``utils/convert.train_state_from_jax``; one fp32 step
on the same numpy batch and the JAX noise draw, held to the bounds of
``tests/test_torch_train_step.py``.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import CLOSE_SHARE, METRIC_ATOL, METRIC_RTOL, _check_params, _np
from test_torch_train_step import _snapshot_jax, _snapshot_port
from torch_port_helpers import perturb
from xmc_gan_tpu import train as jax_train
from xmc_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from xmc_gan_tpu.config import cfg_from_file as jax_cfg_from_file
from xmc_gan_tpu_torch import losses, train
from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.utils.convert import train_state_from_jax

LN_CFG = str(Path(__file__).resolve().parents[1] / "xmc_gan_tpu" / "cfg" / "ln_coco_256.yml")
BS, SIZE, NCH = 4, 64, 8
OVERRIDES = {"TRAIN": {"NCH": NCH, "BATCH_SIZE": BS}, "IMG": {"SIZE": SIZE}}


def _batch(cfg):
    """uint8 images, Gaussian embeddings, about half the word slots real
    with the padding scattered (as ``benchmarks/ln_word_loss.py`` draws the
    LN mask), caption 1 all padded."""
    rng = np.random.RandomState(0)
    t, e = cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM
    mask = rng.rand(BS, t) > 0.5
    mask[1] = True
    return {"imgs": rng.randint(0, 256, (BS, SIZE, SIZE, 3)).astype(np.uint8),
            "sent_embs": rng.randn(BS, e).astype(np.float32),
            "words_embs": rng.randn(BS, t, e).astype(np.float32), "mask": mask}


def _unit(v):
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def run():
    jcfg = jax_cfg_from_dict(OVERRIDES, base=jax_cfg_from_file(LN_CFG))
    cfg = cfg_from_dict(OVERRIDES, base=cfg_from_file(LN_CFG))
    # every value is drawn anew, so only the state's structure and shapes
    # come from the JAX package (``jax.eval_shape``: no init is compiled)
    shapes = jax.eval_shape(functools.partial(jax_train.create_train_state, jcfg),
                            jax.random.PRNGKey(0))
    g = perturb(shapes.g_params, 1)
    d = perturb(shapes.d_params, 2)
    rng = np.random.RandomState(3)
    uv = jax.tree.map(lambda x: _unit(rng.randn(*x.shape).astype(np.float32)), shapes.d_spectral)
    # vectors near the top singular ones: sigma near each kernel's norm
    spec = _np(jax_train.refresh_spectral(d, uv, 20))
    g_tx, d_tx = jax_train.make_optimizers(jcfg)
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32), g_params=g, d_params=d,
                                 d_spectral=spec, g_opt_state=g_tx.init(g),
                                 d_opt_state=d_tx.init(d))
    port = train_state_from_jax(cfg, g, d, spec, device="cpu")
    batch = _batch(cfg)
    key = jax.random.PRNGKey(100)
    noise = np.asarray(jax.random.normal(key, (BS, cfg.TRAIN.NOISE_DIM), jnp.float32))
    state, jm = jax.jit(jax_train.make_train_step(jcfg))(
        state, {n: jnp.asarray(v) for n, v in batch.items()}, key)
    splits = []
    split, backend = ds.split_captions, losses.word_scores_backend

    def spy(w, mask, width):
        out = split(w, mask, width)
        splits.append((tuple(w.shape), width, tuple(out[0].shape)))
        return out

    # the route the card takes at this shape (CUDA tensors above the
    # threshold), here on CPU tensors: the kernel route's plain version
    ds.split_captions = spy
    losses.word_scores_backend = lambda *args: (
        "kernel" if backend(*args[:-1], torch.device("cuda")) == "kernel" else "plain")
    try:
        pm = train.make_train_step(cfg, word_block_elems=0)(port, batch, noise)
    finally:
        ds.split_captions, losses.word_scores_backend = split, backend
    return {"cfg": cfg, "splits": splits, "mask": batch["mask"],
            "jax": {"metrics": {n: float(v) for n, v in jm.items()},
                    "params": _snapshot_jax(state)},
            "port": {"metrics": {n: float(v) for n, v in pm.items()},
                     "params": _snapshot_port(port)}}


def test_ln_config_keeps_the_word_shape(run):
    cfg = run["cfg"]
    assert (cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM, cfg.TRAIN.NOISE_DIM) == (200, 768, 128)
    assert cfg.TRAIN.ENCODER_LOSS.WORD and cfg.TRAIN.MAGP and cfg.DISC.SPEC_NORM


def test_ln_word_scores_take_the_kernel_route_as_sub_captions(run):
    """Both word losses of the step (real and fake regions) went through
    ``damsm_scores`` as sub-captions of 8 slots (fp32: half the packed
    d_words' 16 rows a pass), ceil(n / 8) per caption for the batch's
    longest caption of n real words."""
    k = -(-int((~np.asarray(run["mask"])).sum(1).max()) // 8)
    assert run["splits"] == [((BS, 200, 768), 8, (BS * k, 8, 768))] * 2


def test_ln_step_metrics_match_jax(run):
    j, p = run["jax"]["metrics"], run["port"]["metrics"]
    assert set(p) == set(j)
    for name, want in j.items():
        got = p[name]
        assert abs(got - want) <= METRIC_RTOL * abs(want) + METRIC_ATOL, (name, got, want)


def test_ln_step_params_and_vectors_match_jax(run):
    _check_params(run["cfg"].TRAIN.OPT, run["jax"]["params"], run["port"]["params"], 1,
                  CLOSE_SHARE)


def test_ln_all_padded_caption_losses_match_jax(run):
    """Caption 1 of the batch has no real word, so it scores (-1e30 + log T)
    / gamma2 against every image, and its own image's word InfoNCE row
    meets a positive logit of gamma3 times that, ~-2e30: the image-to-caption
    term averages ~2e30 / B over the batch, and the symmetric loss (half the
    two directions' sum) and Loss_D / Loss_G, which add it, come to 1e30 /
    B, in the JAX package as in the port, equal within the metric tolerance.
    The LN-COCO step's ~3.9e27 at batch 256 is this input's value (1e30 /
    256), not a fault of either."""
    j, p = run["jax"]["metrics"], run["port"]["metrics"]
    assert np.asarray(run["mask"])[1].all()
    for name in ("ds_word", "gs_word", "Loss_D", "Loss_G"):
        assert abs(p[name] - j[name]) <= METRIC_RTOL * abs(j[name]) + METRIC_ATOL, name
        np.testing.assert_allclose(j[name], 1e30 / BS, rtol=1e-6, err_msg=name)
    for name in ("errD_real", "errD_fake", "ds_loss", "gs_loss"):  # the rest stay O(1)
        assert abs(j[name]) < 10, name
        assert abs(p[name] - j[name]) <= METRIC_RTOL * abs(j[name]) + METRIC_ATOL, name
