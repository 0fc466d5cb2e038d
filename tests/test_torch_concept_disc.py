"""The port's concept discriminator (``CONCEPT_NETD``: ``NetD``,
``ConceptResD``, ``ConceptDGetLogits``), its spectral refresh, its MAGP
penalty and that penalty's gradient in D's parameters against the JAX
package's ``xmc_gan_tpu.models.df_concept_gan.NetD``, on the same perturbed
weights and power-iteration vectors (carried by
``utils/convert.concept_discriminator_state_dict``) and numpy inputs.

NCH=4 (D's widths 4…64 at 64²), NEF=16, EMBEDDING_DIM=24, batch 3, fp32.
Tolerances: the trunk's convolutions and the concept samplers' softmax sums
run in another order (XLA's and PyTorch's CPU kernels): features and logits
to 1e-4 absolute on O(1) values (as ``tests/test_torch_disc.py`` states for
the concept head), the vectors to 1e-6, the penalty to 1e-4 relative and its
gradients to 1e-4 of each tensor's largest magnitude (its sixth power
multiplies the fp32 differences by six)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_port_helpers import perturb_concept, small_cfgs, unit_spectral
from xmc_gan_tpu import losses as jl
from xmc_gan_tpu import train as jax_train
from xmc_gan_tpu.models import df_concept_gan as jdf
from xmc_gan_tpu.ops.grouped import GroupedDense as JaxGroupedDense
from xmc_gan_tpu_torch import losses, registry, train
from xmc_gan_tpu_torch.models import df_concept_gan as pdf
from xmc_gan_tpu_torch.ops.grouped import GroupedDense
from xmc_gan_tpu_torch.utils.convert import concept_discriminator_state_dict, grouped_state_dict

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ATOL = 1e-4
BS, SIZE, NEF, EMB = 3, 64, 16, 24

# (DISC head, SPEC_NORM, GEN.NORMALIZE, the JAX D's fuse_downsample):
# concept_out_df_gan.yml's SENT_MATCH + spectral norm; the JAX package's
# IMG_MATCH; neither head, the sentence as G projects it; DISC.SEPERATE, the raw
# sentence projected to NEF.  The port's one D pools its shortcut first and
# matches the JAX D with the fold on and off.
CASES = [("SENT_MATCH", True, False, True), ("IMG_MATCH", True, True, False),
         ("NONE", False, False, True), ("SEPERATE", False, True, True)]


def _overrides(head, spec_norm, normalize):
    return {"TRAIN": {"NCH": 4, "NEF": NEF, "NOISE_DIM": 8, "HE_INIT": True},
            "IMG": {"SIZE": SIZE}, "TEXT": {"EMBEDDING_DIM": EMB, "MAX_LENGTH": 6},
            "GEN": {"NORMALIZE": normalize},
            "DISC": {"ENCODER_NAME": "CONCEPT_NETD", "SPEC_NORM": spec_norm,
                     "SENT_MATCH": head == "SENT_MATCH", "IMG_MATCH": head == "IMG_MATCH",
                     "SEPERATE": head == "SEPERATE"}}


def _sent_dim(cfg):
    return cfg.TEXT.EMBEDDING_DIM if cfg.DISC.SEPERATE else cfg.TRAIN.NEF


def _jax_d(jcfg, seed=0, fuse=True):
    """JAX concept NetD and its perturbed variables (numpy trees)."""
    d = jdf.NetD(jcfg, fuse_downsample=fuse)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    sent = jnp.zeros((1, _sent_dim(jcfg)))
    shapes = jax.eval_shape(lambda k: d.init(k, x, sent, method="d_all"),
                            jax.random.PRNGKey(seed))
    params = perturb_concept(shapes["params"], seed + 1)
    spectral = shapes.get("spectral", {})
    variables = {"params": params}
    if spectral:
        variables["spectral"] = unit_spectral(spectral, params, seed + 2)
    return d, variables


def _port_d(cfg, variables):
    d = pdf.NetD(cfg, gen=torch.Generator().manual_seed(0))
    d.load_state_dict(concept_discriminator_state_dict(variables["params"],
                                                       variables.get("spectral")), strict=True)
    return d


def _inputs(cfg, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (BS, SIZE, SIZE, 3)).astype(np.float32),
            rng.randn(BS, _sent_dim(cfg)).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("head,spec_norm,normalize,fuse", CASES)
def test_concept_netd_matches_jax(head, spec_norm, normalize, fuse):
    """``forward`` (the 4x4 features), ``logits`` (match, img_feat, sent_proj)
    and ``d_all``, with each head the JAX package has."""
    jcfg, cfg = small_cfgs(_overrides(head, spec_norm, normalize))
    jd, variables = _jax_d(jcfg, fuse=fuse)
    x, sent = _inputs(cfg)
    d = _port_d(cfg, variables)
    with torch.no_grad():
        feats = d(_nchw(x))
        logits = d.logits(feats, torch.from_numpy(sent))
        d_all = d.d_all(_nchw(x), torch.from_numpy(sent))
    want_feats = np.asarray(jax.jit(lambda v, i: jd.apply(v, i))(variables, x))
    assert want_feats.shape == (BS, 4, 4, 16 * cfg.TRAIN.NCH)
    assert np.abs(want_feats).max() > 0.1  # the gates are open: the blocks count
    np.testing.assert_allclose(_nhwc(feats), want_feats, rtol=0, atol=ATOL)
    want = jax.jit(lambda v, f, s: jd.apply(v, f, s, method="logits"))(variables, want_feats,
                                                                       sent)
    for got, w in zip(logits, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    for got, w in zip(d_all, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=2 * ATOL)
    want_proj = {"SENT_MATCH": 16 * cfg.TRAIN.NCH, "IMG_MATCH": _sent_dim(cfg)}.get(head, NEF)
    assert logits[2].shape == (BS, want_proj)


@pytest.mark.parametrize("iters", [1, 3])
def test_concept_refresh_spectral_matches_jax(iters):
    """u/v of every spectral-normalized layer, the grouped projections of
    the concept samplers and the gamma/beta MLPs among them, after
    ``iters`` power-iteration steps; 1e-6 (fp32 matrix-vector products in
    another order)."""
    jcfg, cfg = small_cfgs(_overrides("SENT_MATCH", True, True))
    _, variables = _jax_d(jcfg, seed=4)
    d = _port_d(cfg, variables)
    train.refresh_spectral(d, iters)
    want_spec = jax.tree.map(np.asarray, jax_train.refresh_spectral(
        variables["params"], variables["spectral"], iters))
    want = concept_discriminator_state_dict(variables["params"], want_spec)
    got = d.state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith(("weight_u", "weight_v")):
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6, msg=k)
            n += 1
    spectral = [m for m in d.modules() if getattr(m, "spec_norm", False)]
    assert n == 2 * len(spectral)
    assert sum(isinstance(m, GroupedDense) for m in spectral) == 4 * 7  # 7 a block


def test_grouped_dense_spectral_norm_matches_jax():
    """``GroupedDense(spec_norm=True)``: the ``(groups*d_out, d_in)``
    matricization, both forms (vectors and the per-pixel grouped conv);
    1e-6."""
    rng = np.random.RandomState(3)
    jm = JaxGroupedDense(5, spec_norm=True)
    x = rng.randn(3, 4, 6).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    params = perturb_concept(shapes["params"], 1)
    spectral = unit_spectral(shapes["spectral"], params, 2, refreshes=2)
    want = np.asarray(jm.apply({"params": params, "spectral": spectral}, x))
    m = GroupedDense(4, 6, 5, spec_norm=True, gen=torch.Generator().manual_seed(0))
    m.load_state_dict(grouped_state_dict(params, spectral), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-6)
        pix = torch.from_numpy(x).reshape(3, 24, 1, 1)
        np.testing.assert_allclose(m.conv(pix).reshape(3, 4, 5).numpy(), want, rtol=0,
                                   atol=1e-6)


def test_magp_penalty_and_d_grads_match_jax():
    """``2 * mean(||grad_{img,sent} D||^6)`` through the concept D and its
    gradient in every D parameter: autograd of D's input gradient, through
    the epilogue's double backward (the plain version on the CPU)."""
    jcfg, cfg = small_cfgs(_overrides("SENT_MATCH", True, False))
    jd, variables = _jax_d(jcfg, seed=5)
    x, sent = _inputs(cfg, seed=9)

    def jpen(p):
        def d_scalar(i, s):
            v = {"params": p, "spectral": variables["spectral"]}
            return jd.apply(v, i, s, method="d_all")[0].astype(jnp.float32).sum()
        return jl.magp_penalty(d_scalar, jnp.asarray(x), jnp.asarray(sent))

    want, jgrads = jax.jit(jax.value_and_grad(jpen))(variables["params"])
    d = _port_d(cfg, variables)
    got = losses.magp_penalty(lambda i, s: d.d_all(i, s)[0].float().sum(), _nchw(x),
                              torch.from_numpy(sent))
    names = [n for n, _ in d.named_parameters()]
    grads = torch.autograd.grad(got, list(d.parameters()), allow_unused=True)
    assert got.item() > 0 and got.item() == pytest.approx(float(want), rel=1e-4)
    want_sd = concept_discriminator_state_dict(jax.tree.map(np.asarray, jgrads))
    moved = 0
    for n, g in zip(names, grads):
        w = want_sd[n]
        g = torch.zeros_like(w) if g is None else g
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max().item() + 1e-12,
                                   msg=n)
        moved += "concept_sampler" in n and w.abs().max().item() > 0
    assert moved  # the penalty reaches the samplers: gamma/beta depend on the image


def test_state_dict_names_and_modulation_shapes():
    """The converter gives exactly the port's names (``downblocks.{i}``,
    ``COND_DNET.joint_conv.0/.2``, the JAX tree's names inside a block);
    ``disc_modulation_shapes`` lists the inputs of the trunk's
    ``modulate_lrelu`` calls in order."""
    jcfg, cfg = small_cfgs(_overrides("SENT_MATCH", True, True))
    _, variables = _jax_d(jcfg)
    sd = concept_discriminator_state_dict(variables["params"], variables["spectral"])
    d = pdf.NetD(cfg, gen=torch.Generator().manual_seed(0))
    assert set(sd) == set(d.state_dict())
    for key in ("conv_img.weight_v", "downblocks.0.concept_sampler.key_gconv.weight_u",
                "downblocks.3.gamma_g2.bias", "downblocks.1.gn.weight",
                "COND_DNET.proj_match.weight", "COND_DNET.joint_conv.2.weight"):
        assert key in sd, key
    seen = []
    real = pdf.modulate_lrelu

    def record(x, g, b):
        seen.append(tuple(x.shape))
        return real(x, g, b)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(pdf, "modulate_lrelu", record)
        d(torch.zeros(2, 3, SIZE, SIZE).contiguous(memory_format=torch.channels_last))
    assert seen == pdf.disc_modulation_shapes(cfg, 2) == [
        (2, 128, 32, 32), (2, 128, 16, 16), (2, 128, 8, 8), (2, 128, 4, 4)]


def test_registry_resolves_concept_netd():
    assert registry.get_discriminator("CONCEPT_NETD") is pdf.NetD
