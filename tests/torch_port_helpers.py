"""Shared fixtures-by-function for the port's parity tests (``test_torch_*.py``).

Inputs and weight perturbations are made with numpy from fixed seeds and
handed to both the JAX package and the port; weights cross through the port's
``utils/convert.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmc_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from xmc_gan_tpu.models.df_gan import NetD as JaxNetD
from xmc_gan_tpu.train import refresh_spectral as jax_refresh_spectral
from xmc_gan_tpu.models.df_gan import NetG as JaxNetG
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.models.df_gan import NetD, NetG
from xmc_gan_tpu_torch.utils.convert import (
    df_gan_discriminator_state_dict,
    df_gan_generator_state_dict,
)


def small_cfgs(overrides: dict):
    """The same overrides as a JAX-package and a port config."""
    return jax_cfg_from_dict(overrides), cfg_from_dict(overrides)


def g_overrides(size: int, he_init: bool = True, emb: int = 16, nef: int = 32) -> dict:
    """A narrow DF-GAN G: NCH=4 (the 256² table's widths / 8)."""
    return {
        "TRAIN": {"NCH": 4, "NEF": nef, "NOISE_DIM": 8, "HE_INIT": he_init},
        "IMG": {"SIZE": size},
        "TEXT": {"EMBEDDING_DIM": emb, "VOCA_SIZE": 40, "MAX_LENGTH": 6, "ENCODER_DIR": ""},
    }


def perturb(tree, seed: int):
    """Replace every G parameter by a seeded random value, scaled so that
    activations stay O(1) through all blocks (a fresh G has zero gates, so
    its residual branches — and the epilogue in them — would affect nothing;
    random He-scaled weights with non-zero gates overflow ``tanh``).

    Kernels ~ N(0, 1/fan_in); biases ~ N(0, 0.1^2); the affine output layers
    give gamma ~ 1 +- 0.1 and beta ~ 0 +- 0.1 plus a small text-dependent
    part; gates ~ U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(name, parent, shape):
        if name == "gamma":
            return rng.uniform(0.5, 1.5, shape)
        if name == "kernel":
            std = 0.1 if parent in ("fc_gamma_2", "fc_beta_2") else 1.0
            return rng.standard_normal(shape) * std / np.sqrt(np.prod(shape[:-1]))
        base = 1.0 if parent == "fc_gamma_2" else 0.0
        return base + 0.1 * rng.standard_normal(shape)

    def walk(node, parent=""):
        return {k: walk(v, k) if isinstance(v, dict)
                else leaf(k, parent, np.shape(v)).astype(np.float32)
                for k, v in node.items()}

    return walk(tree)


def jax_g_params(jcfg, seed: int = 0):
    """Perturbed JAX ``NetG`` params (numpy tree) for ``jcfg``.  Every value
    is drawn anew, so only the tree's structure and shapes come from the JAX
    module (``jax.eval_shape``: no init is run)."""
    g = JaxNetG(jcfg)
    noise = jnp.zeros((1, jcfg.TRAIN.NOISE_DIM))
    sent = jnp.zeros((1, jcfg.TEXT.EMBEDDING_DIM))
    shapes = jax.eval_shape(g.init, jax.random.PRNGKey(seed), noise, sent)["params"]
    return perturb(shapes, seed + 1)


def port_g(cfg, params, dtype=torch.float32, fuse_upsample=True) -> NetG:
    """The port's NetG on the CPU carrying the JAX params."""
    g = NetG(cfg, dtype=dtype, fuse_upsample=fuse_upsample, gen=torch.Generator().manual_seed(0))
    g.load_state_dict(df_gan_generator_state_dict(params), strict=True)
    return g.eval().requires_grad_(False)


def d_overrides(size: int, spec_norm: bool = True, word: bool = True, nch: int = 2,
                emb: int = 16, nef: int = 16) -> dict:
    """A narrow DF-GAN D (NCH=2 by default) with the sentence projection
    (``IMG_MATCH``) and, with ``word``, the word-region head."""
    return {
        "TRAIN": {"NCH": nch, "NEF": nef, "NOISE_DIM": 8, "HE_INIT": True,
                  "ENCODER_LOSS": {"SENT": True, "WORD": word}},
        "IMG": {"SIZE": size},
        "TEXT": {"EMBEDDING_DIM": emb, "MAX_LENGTH": 6},
        "DISC": {"SPEC_NORM": spec_norm, "IMG_MATCH": True},
    }


def jax_d_variables(jcfg, seed: int = 0):
    """Perturbed JAX ``NetD`` params and power-iteration vectors (numpy
    trees) for ``jcfg``: random unit vectors taken 20 refreshes towards the
    top singular vectors, so that ``sigma`` is near each kernel's norm and
    activations stay O(1).  Only the trees' structure and shapes come from the
    JAX module (``jax.eval_shape``)."""
    size = jcfg.IMG.SIZE
    x = jnp.zeros((1, size, size, 3))
    sent = jnp.zeros((1, jcfg.TEXT.EMBEDDING_DIM))
    d = JaxNetD(jcfg)
    shapes = jax.eval_shape(lambda k: d.init(k, x, sent, method="d_all"),
                            jax.random.PRNGKey(seed))
    params = perturb(shapes["params"], seed + 1)
    rng = np.random.RandomState(seed + 2)

    def unit(leaf):
        v = rng.standard_normal(leaf.shape)
        return (v / np.linalg.norm(v)).astype(np.float32)

    spectral = jax.tree.map(unit, dict(shapes.get("spectral", {})))
    if spectral:
        spectral = jax.tree.map(np.asarray, jax_refresh_spectral(params, spectral, 20))
    return params, spectral


def port_d(cfg, params, spectral, dtype=torch.float32, fuse_downsample=True) -> NetD:
    """The port's NetD on the CPU carrying the JAX params and vectors."""
    d = NetD(cfg, dtype=dtype, fuse_downsample=fuse_downsample,
             gen=torch.Generator().manual_seed(0))
    d.load_state_dict(df_gan_discriminator_state_dict(params, spectral), strict=True)
    return d


@pytest.fixture(scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module's tests, restored after: the
    tier-1 run puts six xdist workers, each with JAX's thread pool, on the
    same cores, where more threads per worker only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
