"""The port's DF-GAN ``NetG`` against the JAX package's, on the same seeded
weights (perturbed so that every gate is non-zero and the epilogue matters)
and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JaxNetG, g_overrides, jax_g_params, port_g, small_cfgs
from xmc_gan_tpu.utils.convert import df_gan_generator_state_dict as jax_export_g
from xmc_gan_tpu_torch.models import df_gan
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.utils.convert import df_gan_generator_state_dict

BF16_ULP = 2.0 ** -7


def _inputs(cfg, seed=3, batch=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, cfg.TRAIN.NOISE_DIM).astype(np.float32),
            rng.randn(batch, cfg.TEXT.EMBEDDING_DIM).astype(np.float32))


def _jax_g(jcfg, params, noise, sent, fuse, dtype=jnp.float32):
    g = JaxNetG(jcfg, dtype=dtype, fuse_upsample=fuse)
    return np.asarray(jax.jit(lambda p, n, s: g.apply({"params": p}, n, s))(params, noise, sent))


def _port(g, noise, sent):
    with torch.no_grad():
        out = g(torch.from_numpy(noise), torch.from_numpy(sent))
    assert out.dtype == torch.float32
    return out.permute(0, 2, 3, 1).numpy()


# (size, fuse_upsample, HE_INIT, EMBEDDING_DIM): EMBEDDING_DIM 16 != NEF 32
# runs the proj_sent branch, 32 skips it.
CASES = [(64, True, True, 16), (64, False, False, 16), (128, True, False, 32),
         (256, True, True, 32), (256, False, False, 16)]


@pytest.mark.parametrize("size,fuse,he,emb", CASES)
def test_netg_matches_jax_fp32(size, fuse, he, emb):
    """Tolerance: 2e-5 on the tanh output, ~10x the fp32 summation-order
    difference seen between XLA's and PyTorch's CPU convolutions (2.4e-6)."""
    jcfg, cfg = small_cfgs(g_overrides(size, he, emb))
    params = jax_g_params(jcfg)
    noise, sent = _inputs(cfg)
    want = _jax_g(jcfg, params, noise, sent, fuse)
    got = _port(port_g(cfg, params, fuse_upsample=fuse), noise, sent)
    assert got.shape == (2, size, size, 3)
    assert np.mean(np.abs(want) > 0.99) < 0.5  # not saturated: the test has teeth
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("size", [64, 256])
def test_netg_matches_jax_bf16(size):
    """bf16 activations in both.  The two round in different places (the JAX
    epilogue rounds its intermediate; convolutions accumulate differently), so
    the port is held to the algorithm: its error against the fp32 JAX output
    is at most the JAX bf16 run's own error plus 4 bf16 ulps, and its mean
    distance from the JAX bf16 output is under one ulp."""
    jcfg, cfg = small_cfgs(g_overrides(size))
    params = jax_g_params(jcfg)
    noise, sent = _inputs(cfg)
    ref32 = _jax_g(jcfg, params, noise, sent, True)
    ref16 = _jax_g(jcfg, params, noise, sent, True, jnp.bfloat16)
    got = _port(port_g(cfg, params, torch.bfloat16), noise, sent)
    assert np.abs(got - ref32).max() <= np.abs(ref16 - ref32).max() + 4 * BF16_ULP
    assert np.abs(got - ref16).mean() < BF16_ULP


def test_jax_exported_state_dict_loads_strict():
    """The JAX package's own exporter (reference names) loads strict=True into
    the port's NetG and gives the same G as the port's converter."""
    jcfg, cfg = small_cfgs(g_overrides(64))
    params = jax_g_params(jcfg)
    g = df_gan.NetG(cfg, gen=torch.Generator().manual_seed(0))
    exported = {k: torch.from_numpy(np.array(v)) for k, v in jax_export_g(params).items()}
    g.load_state_dict(exported, strict=True)
    ours = df_gan_generator_state_dict(params)
    assert set(ours) == set(exported)
    for k, v in ours.items():
        torch.testing.assert_close(v, exported[k], rtol=0, atol=0)


@pytest.mark.parametrize("he", [True, False])
def test_init_regime_matches_jax(he):
    """Same parameter set and shapes as the JAX init; zero gates; zero biases
    under HE_INIT; affine gamma bias 1 / beta bias 0 and zero output weights
    without it; He std sqrt(2/fan_in) on the big convs."""
    jcfg, cfg = small_cfgs(g_overrides(64, he))
    args = (jax.random.PRNGKey(0), jnp.zeros((1, 8)), jnp.zeros((1, 16)))
    # One program at XLA's lowest optimisation level: eager init compiles a
    # sampler per parameter shape, which made this the slowest port test.
    init = jax.jit(JaxNetG(jcfg).init).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    jparams = init(*args)
    want = df_gan_generator_state_dict(jax.tree.map(np.asarray, jparams["params"]))
    got = df_gan.NetG(cfg, gen=torch.Generator().manual_seed(0)).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    for k, v in got.items():
        w = want[k]
        assert bool((v == 0).all()) == bool((w == 0).all()), k
        assert bool((v == 1).all()) == bool((w == 1).all()), k
        if v.numel() >= 4096:
            assert abs(v.std().item() - w.std().item()) <= 0.1 * w.std().item(), k


@pytest.mark.parametrize("size,fuse", [(64, True), (256, True), (256, False)])
def test_epilogue_calls_and_shapes(size, fuse, monkeypatch):
    """Two epilogue calls per GBlock (14 at 256²), at the shapes that
    ``epilogue_shapes`` derives from the arch table, all channels_last; on
    the CPU they go to the plain version and the kernel count stays put."""
    jcfg, cfg = small_cfgs(g_overrides(size))
    seen = []
    real = df_gan.double_modulate_lrelu

    def spy(x, *mods):
        assert x.is_contiguous(memory_format=torch.channels_last)
        seen.append(tuple(x.shape))
        return real(x, *mods)

    monkeypatch.setattr(df_gan, "double_modulate_lrelu", spy)
    g = port_g(cfg, jax_g_params(jcfg), fuse_upsample=fuse)
    before = fa.FORWARD.launches
    _port(g, *_inputs(cfg))
    assert seen == df_gan.epilogue_shapes(cfg, 2, fuse)
    assert len(seen) == {64: 10, 256: 14}[size]
    assert fa.FORWARD.launches == before


def test_epilogue_shapes_at_flagship_width():
    """The 14 shapes of the 256², NCH=32 G: 5,943,296 elements per image."""
    _, cfg = small_cfgs({"TRAIN": {"NCH": 32}, "IMG": {"SIZE": 256}})
    shapes = df_gan.epilogue_shapes(cfg, 1)
    assert len(shapes) == 14
    assert shapes[-1] == (1, 32, 256, 256)
    assert sum(int(np.prod(s)) for s in shapes) == 5_943_296
