"""The port's DF-GAN discriminator (``NetD``, ``ResD``, ``DGetLogits``), its
spectral refresh and its pooling/image ops against the JAX package's, on the
same seeded, perturbed weights (non-zero gates) and numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JaxNetD, d_overrides, jax_d_variables, port_d, small_cfgs
from xmc_gan_tpu import train as jax_train
from xmc_gan_tpu.models.df_gan import ResD as JaxResD
from xmc_gan_tpu.ops.images import to_unit_range as jax_to_unit_range
from xmc_gan_tpu.ops.modules import avg_pool as jax_avg_pool
from xmc_gan_tpu_torch import registry, train
from xmc_gan_tpu_torch.models.df_gan import NetD, ResD
from xmc_gan_tpu_torch.ops.images import to_unit_range
from xmc_gan_tpu_torch.ops.modules import avg_pool, global_avg_pool
from xmc_gan_tpu_torch.utils.convert import conv_state_dict, df_gan_discriminator_state_dict

# fp32 on both sides; the trunk's convolutions sum in another order (XLA's
# and PyTorch's CPU kernels): ~1e-6 on O(1) values, held to 2e-5.
ATOL = 2e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(cfg, seed=1, batch=3):
    rng = np.random.RandomState(seed)
    size = cfg.IMG.SIZE
    return (rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32),
            rng.randn(batch, cfg.TEXT.EMBEDDING_DIM).astype(np.float32))


def _jax(jcfg, variables, method, *args, fuse=True):
    d = JaxNetD(jcfg, fuse_downsample=fuse)
    fn = jax.jit(lambda v, *a: d.apply(v, *a, method=method))
    return jax.tree.map(np.asarray, fn(variables, *args))


# (size, SPEC_NORM, fuse_downsample, WORD)
CASES = [(64, True, True, True), (64, False, False, False), (128, True, False, True),
         (256, True, True, True), (256, False, True, False)]


@pytest.mark.parametrize("size,spec_norm,fuse,word", CASES)
def test_netd_matches_jax_fp32(size, spec_norm, fuse, word):
    """``forward`` (4x4 features), ``features_and_regions`` and ``logits``
    (match, img_feat, sent_proj), and ``d_all``."""
    jcfg, cfg = small_cfgs(d_overrides(size, spec_norm, word))
    params, spectral = jax_d_variables(jcfg)
    variables = {"params": params, **({"spectral": spectral} if spectral else {})}
    x, sent = _inputs(cfg)
    d = port_d(cfg, params, spectral, fuse_downsample=fuse)
    with torch.no_grad():
        feats = d(_nchw(x))
        logits = d.logits(feats, torch.from_numpy(sent))
        d_all = d.d_all(_nchw(x), torch.from_numpy(sent))
    want_feats = _jax(jcfg, variables, "__call__", x, fuse=fuse)
    assert want_feats.shape == (3, 4, 4, 16 * cfg.TRAIN.NCH)
    np.testing.assert_allclose(_nhwc(feats), want_feats, rtol=0, atol=ATOL)
    want_logits = _jax(jcfg, variables, "logits", want_feats, sent, fuse=fuse)
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    for got, want in zip(d_all, want_logits):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * ATOL)
    if word:
        with torch.no_grad():
            f2, regions = d.features_and_regions(_nchw(x))
        wf, wr = _jax(jcfg, variables, "features_and_regions", x, fuse=fuse)
        assert regions.shape == wr.shape == (3, 256, cfg.TEXT.EMBEDDING_DIM)
        np.testing.assert_allclose(regions.numpy(), wr, rtol=0, atol=ATOL)
        np.testing.assert_allclose(_nhwc(f2), wf, rtol=0, atol=ATOL)
    else:
        assert d.region_proj is None
        with pytest.raises(ValueError, match="ENCODER_LOSS.WORD"):
            d.features_and_regions(_nchw(x))


@pytest.mark.parametrize("in_dim,out_dim,fuse", [(4, 8, True), (4, 8, False), (8, 8, True)])
def test_resd_matches_jax(in_dim, out_dim, fuse):
    """One residual down-block, with and without a shortcut conv and the
    pool-first fold; spectral norm on."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, in_dim).astype(np.float32)
    m = JaxResD(in_dim, out_dim, True, True, True, fuse)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), x)
    variables = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32) * 0.3, shapes)
    variables = jax.tree.map(np.asarray, variables)
    # vectors near the top singular ones, so that sigma is near each norm
    variables["spectral"] = jax.tree.map(np.asarray, jax_train.refresh_spectral(
        variables["params"], variables["spectral"], 20))
    want = np.asarray(m.apply(variables, x))
    port = ResD(in_dim, out_dim, True, True, True, fuse, gen=torch.Generator().manual_seed(0))
    sd = {"gamma": torch.from_numpy(variables["params"]["gamma"])}
    for jname, pname in (("conv_r1", "conv_r.0."), ("conv_r2", "conv_r.2."), ("conv_s", "conv_s.")):
        if jname in variables["params"]:
            sd.update(conv_state_dict(variables["params"][jname],
                                      variables["spectral"][jname], prefix=pname))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("iters", [1, 3])
def test_refresh_spectral_matches_jax(iters):
    """u/v after ``iters`` power-iteration steps from the same weights and
    vectors; conv v compared after the (kH, kW, I) -> (I, kH, kW) permutation
    that ``utils/convert.py`` applies.  Tolerance: fp32 matrix-vector
    products in another order (1e-6)."""
    jcfg, cfg = small_cfgs(d_overrides(64))
    params, spectral = jax_d_variables(jcfg, seed=4)
    d = port_d(cfg, params, spectral)
    train.refresh_spectral(d, iters)
    want_spec = jax.tree.map(np.asarray, jax_train.refresh_spectral(params, spectral, iters))
    want = df_gan_discriminator_state_dict(params, want_spec)
    got = d.state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith(("weight_u", "weight_v")):
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6)
            n += 1
    assert n == 2 * sum(1 for m in d.modules() if getattr(m, "spec_norm", False))
    assert n > 0


def test_matricize_spectral_kernel_is_torch_view():
    w = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    assert tuple(train.matricize_spectral_kernel(w).shape) == (2, 48)
    torch.testing.assert_close(train.matricize_spectral_kernel(w)[1], w[1].flatten())


def test_pooling_and_unit_range_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 5).astype(np.float32)
    np.testing.assert_allclose(_nhwc(avg_pool(_nchw(x), 2)), np.asarray(jax_avg_pool(x, 2)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(global_avg_pool(_nchw(x)).numpy(), x.mean((1, 2)),
                               rtol=0, atol=1e-6)
    u8 = rng.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    got = to_unit_range(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_to_unit_range(u8)))
    bf = to_unit_range(torch.from_numpy(u8), torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.float().numpy(), np.asarray(jax_to_unit_range(u8, jnp.bfloat16).astype(jnp.float32)))
    f = torch.from_numpy(rng.uniform(-1, 1, (2, 3)).astype(np.float32))
    assert to_unit_range(f) is f


def test_registry_discriminators():
    assert registry.get_discriminator("DF_DISC") is NetD
    with pytest.raises(NotImplementedError, match="concept-family slice"):
        registry.get_discriminator("CONCEPT_NETD")
    with pytest.raises(KeyError):
        registry.get_discriminator("NO_SUCH_D")


def test_state_dict_uses_reference_names():
    """The converter's names are the reference ``NetD``'s (``conv_img``,
    ``downblocks.{i}.conv_r.0/.2``, ``conv_s``, ``gamma``,
    ``COND_DNET.proj_match``, ``COND_DNET.joint_conv.0/.2``) plus the
    word-loss ``region_proj``, and load strictly."""
    jcfg, cfg = small_cfgs(d_overrides(64))
    params, spectral = jax_d_variables(jcfg)
    sd = df_gan_discriminator_state_dict(params, spectral)
    for key in ("conv_img.weight", "conv_img.bias", "downblocks.0.conv_r.0.weight",
                "downblocks.0.conv_r.2.weight", "downblocks.0.conv_s.weight",
                "downblocks.0.gamma", "COND_DNET.proj_match.weight",
                "COND_DNET.joint_conv.0.weight", "COND_DNET.joint_conv.2.weight",
                "region_proj.weight", "COND_DNET.joint_conv.2.weight_v"):
        assert key in sd, key
    assert set(sd) == set(NetD(cfg, gen=torch.Generator()).state_dict())
