"""The port's concept families (``models/df_concept_gan.py``,
``models/concept_gan.py``, ``ops/grouped.py``, grouped ``SNConv``) against
the JAX package's modules, on the same seeded weights and numpy inputs, at
the sizes of ``tests/test_concept_gan.py`` (NCH=4, NEF=24, NOISE_DIM=16,
EMBEDDING_DIM=20, MAX_LENGTH=6, 64², batch 2) and with its masks.

Weights: every leaf of the JAX tree is drawn anew (kernels ~ N(0, 1/fan_in),
GroupNorm/BatchNorm scales ~ 1 +- 0.1, biases ~ N(0, 0.1^2), gates ~ U(0.5,
1.5)), so that the residual gates are open and the output is not saturated;
the port loads them through ``utils/convert``.  Tolerances are stated per
test; fp32 throughout (TF32 plays no part on the CPU)."""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import small_cfgs
from xmc_gan_tpu.models import concept_gan as jcg
from xmc_gan_tpu.models import df_concept_gan as jdf
from xmc_gan_tpu.ops.grouped import GroupedDense as JaxGroupedDense
from xmc_gan_tpu.ops.modules import SNConv as JaxSNConv
from xmc_gan_tpu.utils.convert import df_concept_generator_params as jax_reference_reader
from xmc_gan_tpu_torch import registry
from xmc_gan_tpu_torch.models import concept_gan as pcg
from xmc_gan_tpu_torch.models import df_concept_gan as pdf
from xmc_gan_tpu_torch.models.common import concept_gen_arch
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca
from xmc_gan_tpu_torch.ops.grouped import GroupedDense
from xmc_gan_tpu_torch.ops.modules import SNConv
from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
from xmc_gan_tpu_torch.utils.convert import (
    concept_generator_state_dict,
    df_concept_generator_state_dict,
)

GEN = torch.Generator().manual_seed(0)  # the port's own init, overwritten by every load


def _overrides(normalize=True):
    return {"TRAIN": {"NCH": 4, "NEF": 24, "NOISE_DIM": 16, "HE_INIT": True},
            "IMG": {"SIZE": 64}, "TEXT": {"EMBEDDING_DIM": 20, "MAX_LENGTH": 6},
            "GEN": {"NORMALIZE": normalize}}


def _inputs(bs=2, seed=0):
    """``tests/test_concept_gan.py``'s inputs and masks (4 and 2 real words)."""
    rng = np.random.RandomState(seed)
    noise = rng.randn(bs, 16).astype(np.float32)
    sent = rng.randn(bs, 20).astype(np.float32)
    words = rng.randn(bs, 6, 20).astype(np.float32)
    mask = np.array([[False] * 4 + [True] * 2, [False] * 2 + [True] * 4])
    return noise, sent, words, mask


def perturb(tree, seed):
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name == "gamma":
            return rng.uniform(0.5, 1.5, shape)
        if name == "kernel":  # dense/conv fan-in: all but the last axis; grouped: d_in
            fan_in = shape[1] if len(shape) == 3 else np.prod(shape[:-1])
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name.endswith("scale"):
            return 1.0 + 0.1 * rng.standard_normal(shape)
        return 0.1 * rng.standard_normal(shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, np.shape(v)).astype(np.float32)
                for k, v in node.items()}

    return walk(tree)


def jax_params(module, *args, seed=1):
    """Perturbed params for ``module``; only the tree's shapes come from it."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    return perturb(shapes, seed)


def jax_apply(module, params, *args):
    return np.asarray(module.apply({"params": params}, *args))


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC memory: channels_last


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ---------------------------------------------------------------- ops layer


def test_grouped_dense_matches_jax():
    """Vector form and per-pixel (grouped 1x1 conv) form; tolerance 1e-6."""
    rng = np.random.RandomState(3)
    jm = JaxGroupedDense(5)
    x = rng.randn(3, 4, 6).astype(np.float32)
    params = jax_params(jm, x)
    want = jax_apply(jm, params, x)
    m = _load(GroupedDense(4, 6, 5, gen=GEN), df_concept_generator_state_dict(params))
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=1e-6, atol=1e-6)
    xmap = rng.randn(2, 3, 5, 24).astype(np.float32)  # NHWC, 4 groups of 6
    want_map = jax_apply(jm, params, xmap.reshape(-1, 4, 6)).reshape(2, 3, 5, 20)
    np.testing.assert_allclose(nhwc(m.conv(nchw(xmap))), want_map, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pre_upsample", [False, True])
def test_grouped_snconv_matches_jax(pre_upsample):
    """A grouped 3x3 (``feature_group_count``), also with the upsample fold;
    tolerance 1e-5 (conv sums in another order)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 5, 16).astype(np.float32)
    jm = JaxSNConv(8, 3, padding=1, use_bias=False, feature_group_count=4,
                   pre_upsample=pre_upsample)
    params = jax_params(jm, x)
    m = _load(SNConv(16, 8, 3, padding=1, use_bias=False, groups=4, pre_upsample=pre_upsample,
                     gen=GEN), concept_generator_state_dict(params))
    np.testing.assert_allclose(nhwc(m(nchw(x))), jax_apply(jm, params, x), rtol=1e-5, atol=1e-5)


def test_grouped_fold_equals_upsample_then_conv():
    """The grouped fold regroups the taps per group: fold on == fold off
    (``conv3x3(upsample(x))``) on the same grouped weight, with a bias."""
    x = torch.randn(2, 12, 5, 7, generator=torch.Generator().manual_seed(5))
    off = SNConv(12, 8, 3, padding=1, groups=4, gen=torch.Generator().manual_seed(6))
    on = SNConv(12, 8, 3, padding=1, groups=4, pre_upsample=True,
                gen=torch.Generator().manual_seed(7))
    on.load_state_dict(off.state_dict())
    up = torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest")
    torch.testing.assert_close(on(x), off(up), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- concept modules


def _state_and_map(seed, c=16, p=4, hw=(4, 4), bs=2):
    rng = np.random.RandomState(seed)
    return rng.randn(bs, c, p).astype(np.float32), rng.randn(bs, *hw, c * 8).astype(np.float32)


def test_concept_reasoner_matches_jax():
    state, _ = _state_and_map(8)
    jm = jdf.ConceptReasoner(cardinality=16, state_dim=4, he_init=True)
    params = jax_params(jm, state)
    m = _load(pdf.ConceptReasoner(16, 4, True, gen=GEN), concept_generator_state_dict(params))
    np.testing.assert_allclose(m(torch.from_numpy(state)).detach().numpy(),
                               jax_apply(jm, params, state), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
def test_concept_sampler_matches_jax(normalize):
    """Self-attention pooling over space, GroupNorm on and off; 1e-5."""
    _, x = _state_and_map(9)
    jm = jdf.ConceptSampler(cardinality=16, state_dim=4, normalize=normalize, he_init=True)
    params = jax_params(jm, x)
    m = _load(pdf.ConceptSampler(16, 4, normalize, True, gen=GEN),
              concept_generator_state_dict(params))
    np.testing.assert_allclose(m(nchw(x)).detach().numpy(), jax_apply(jm, params, x),
                               rtol=1e-5, atol=1e-5)


def test_cond_concept_sampler_matches_jax():
    _, x = _state_and_map(10)
    sent = np.random.RandomState(11).randn(2, 24).astype(np.float32)
    jm = jdf.CondConceptSampler(cardinality=16, state_dim=4, cond_dim=24, normalize=True,
                                he_init=True)
    params = jax_params(jm, x, sent)
    m = _load(pdf.CondConceptSampler(16, 4, 24, True, True, gen=GEN),
              concept_generator_state_dict(params))
    np.testing.assert_allclose(m(nchw(x), torch.from_numpy(sent)).detach().numpy(),
                               jax_apply(jm, params, x, sent), rtol=1e-5, atol=1e-5)


def test_word_cond_concept_sampler_matches_jax():
    """Image queries over the masked words through the port's
    ``masked_cross_attention`` (plain version here), key GroupNorm over every
    word slot; 1e-5."""
    _, x = _state_and_map(12)
    mask = _inputs()[3]
    words = np.random.RandomState(13).randn(2, 6, 24).astype(np.float32)
    jm = jcg.WordCondConceptSampler(cardinality=16, state_dim=4, text_dim=24, normalize=True,
                                    he_init=True)
    params = jax_params(jm, x, words, mask)
    m = _load(pcg.WordCondConceptSampler(16, 4, 24, True, True, gen=GEN),
              concept_generator_state_dict(params))
    got = m(nchw(x), torch.from_numpy(words), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, jax_apply(jm, params, x, words, mask), rtol=1e-5, atol=1e-5)


def _block_case(family, inner, pre_upsample=False):
    """(JAX module, port module, args): a concept block on a 4x4 (8x8 with
    the fold) map of 32 channels, sentence/global condition of 24."""
    rng = np.random.RandomState(14)
    x = rng.randn(2, 4, 4, 32).astype(np.float32)
    cond = rng.randn(2, 24).astype(np.float32)
    if family == "df":
        jcls = jdf.InConceptBlock if inner == "in" else jdf.OutConceptBlock
        pcls = pdf.InConceptBlock if inner == "in" else pdf.OutConceptBlock
        jm = jcls(in_dim=32, cond_dim=24, normalize=True, he_init=True,
                  pre_upsample=pre_upsample)
        return jm, pcls(32, 24, True, True, pre_upsample, gen=GEN), (x, cond)
    mask = _inputs()[3]
    words = rng.randn(2, 6, 20).astype(np.float32)
    jcls = jcg.InConceptBlock if inner == "in" else jcg.OutConceptBlock
    pcls = pcg.InConceptBlock if inner == "in" else pcg.OutConceptBlock
    jm = jcls(in_dim=32, gc_dim=24, text_dim=20, upsample=True, normalize=True, he_init=True)
    return jm, pcls(32, 24, 20, True, True, True, gen=GEN), (x, cond, words, mask)


@pytest.mark.parametrize("family,inner,pre_upsample", [
    ("df", "in", False), ("df", "in", True), ("df", "out", False), ("df", "out", True),
    ("word", "in", False), ("word", "out", False)])
def test_concept_blocks_match_jax(family, inner, pre_upsample):
    """Both ``InConceptBlock``s and both ``OutConceptBlock``s (the DF ones
    also with the upsample folded into the grouped 3x3, the word-attention
    ones with their mid-block upsample); 2e-5."""
    jm, m, args = _block_case(family, inner, pre_upsample)
    params = jax_params(jm, *args)
    convert = df_concept_generator_state_dict if family == "df" else concept_generator_state_dict
    _load(m, convert(params))
    want = jax_apply(jm, params, *args)
    targs = [nchw(args[0])] + [torch.from_numpy(a) for a in args[1:]]
    np.testing.assert_allclose(nhwc(m(*targs)), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fuse", [True, False])
def test_resblockup_matches_jax(fuse):
    """Batch-statistics BN, the in-block upsample folded into ``c1`` or not;
    1e-5."""
    rng = np.random.RandomState(15)
    x = rng.randn(2, 8, 8, 12).astype(np.float32)
    cond = rng.randn(2, 20).astype(np.float32)
    jm = jcg.ResBlockUp(in_dim=12, out_dim=8, cond_dim=20, upsample=True, normalize=True,
                        he_init=True, fuse_upsample=fuse)
    params = jax_params(jm, x, cond)
    m = _load(pcg.ResBlockUp(12, 8, 20, True, True, True, fuse, gen=GEN),
              concept_generator_state_dict(params))
    np.testing.assert_allclose(nhwc(m(nchw(x), torch.from_numpy(cond))),
                               jax_apply(jm, params, x, cond), rtol=1e-5, atol=1e-5)


def test_batch_norm_ignores_eval_mode():
    """``make_generator`` puts G in ``eval()``: the BN still normalizes by the
    batch's own statistics (no running averages exist)."""
    m = pcg.ResBlockUp(4, 4, 6, False, True, True, gen=torch.Generator().manual_seed(0))
    x = torch.randn(3, 4, 5, 5) * 7 + 3
    c = torch.randn(3, 6)
    torch.testing.assert_close(m.train()(x, c), m.eval()(x, c))
    assert not any("running" in k for k in m.state_dict())


# ------------------------------------------------------ whole generators

GENERATORS = {  # name -> (JAX class, port class, converter)
    "CONCEPT_IN_DF_GEN": (jdf.InNetG, pdf.InNetG, df_concept_generator_state_dict),
    "CONCEPT_OUT_DF_GEN": (jdf.OutNetG, pdf.OutNetG, df_concept_generator_state_dict),
    "CONCEPT_INATTN_GEN": (jcg.InNetG, pcg.InNetG, concept_generator_state_dict),
    "CONCEPT_OUTATTN_GEN": (jcg.OutNetG, pcg.OutNetG, concept_generator_state_dict),
}
_CACHE: dict = {}


def _jax_generator(name, normalize=True):
    """(params, want images) of the JAX generator, built once per module."""
    key = (name, normalize)
    if key not in _CACHE:
        jcfg, _ = small_cfgs(_overrides(normalize))
        jm = GENERATORS[name][0](jcfg)
        args = _inputs()
        params = jax_params(jm, *args, seed=2)
        want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, *args))(params))
        _CACHE[key] = params, want
    return _CACHE[key]


def _port_generator(name, params, normalize=True, **kw):
    _, cfg = small_cfgs(_overrides(normalize))
    g = GENERATORS[name][1](cfg, gen=GEN, **kw)
    return _load(g, GENERATORS[name][2](params)).requires_grad_(False)


@pytest.mark.parametrize("name,normalize", [
    ("CONCEPT_IN_DF_GEN", True), ("CONCEPT_OUT_DF_GEN", True), ("CONCEPT_INATTN_GEN", True),
    ("CONCEPT_OUTATTN_GEN", True), ("CONCEPT_INATTN_GEN", False)])
def test_generator_matches_jax_fp32(name, normalize):
    """Each of the four generators end to end (GEN.NORMALIZE off once);
    tolerance 5e-5 on the tanh output, ~10x the largest difference seen
    (XLA's and PyTorch's CPU convolutions, GroupNorm and softmax sum in
    another order)."""
    params, want = _jax_generator(name, normalize)
    g = _port_generator(name, params, normalize)
    got = g(*map(torch.from_numpy, _inputs())).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert np.mean(np.abs(want) > 0.99) < 0.5  # not saturated: the test has teeth
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("name", ["CONCEPT_IN_DF_GEN", "CONCEPT_OUT_DF_GEN"])
def test_df_generator_fold_off_matches_fold_on(name):
    """``fuse_upsample`` off (upsample after each block) gives the folded
    generator's output: the fold is exact math; 2e-5."""
    params, _ = _jax_generator(name)
    args = [torch.from_numpy(a) for a in _inputs()]
    on = _port_generator(name, params)(*args)
    off = _port_generator(name, params, fuse_upsample=False)(*args)
    torch.testing.assert_close(on, off, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name,normalize", [("CONCEPT_OUTATTN_GEN", True),
                                            ("CONCEPT_INATTN_GEN", False)])
def test_masked_words_do_not_influence_output(name, normalize):
    """``test_concept_gan.py:56-75`` on the port: changing the embeddings of
    padded words leaves the image as it was; changing a real word does not.
    (With GEN.NORMALIZE the In sampler's key GroupNorm takes statistics over
    every word slot, so there padded words do count: next test.)"""
    params, _ = _jax_generator(name, normalize)
    g = _port_generator(name, params, normalize)
    noise, sent, words, mask = _inputs()
    run = lambda w: g(*map(torch.from_numpy, (noise, sent, w, mask))).numpy()
    a = run(words)
    w2 = words.copy()
    w2[0, 4:] += 100.0
    w2[1, 2:] -= 50.0
    np.testing.assert_allclose(run(w2), a, atol=1e-5)
    w3 = words.copy()
    w3[0, 0] += 5.0
    assert np.abs(run(w3) - a).max() > 1e-6


def test_in_sampler_key_groupnorm_counts_padded_slots():
    """The JAX In sampler normalizes the word keys with statistics over all
    T slots, padded ones included (``concept_gan.py:163-165``): the port does
    the same, so both move alike when only padded words change; 5e-5."""
    params, want = _jax_generator("CONCEPT_INATTN_GEN")
    noise, sent, words, mask = _inputs()
    w2 = words.copy()
    w2[0, 4:] += 3.0
    jcfg, _ = small_cfgs(_overrides())
    jm = jcg.InNetG(jcfg)
    want2 = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, noise, sent, w2, mask))(params))
    got2 = _port_generator("CONCEPT_INATTN_GEN", params)(
        *map(torch.from_numpy, (noise, sent, w2, mask))).permute(0, 2, 3, 1).numpy()
    assert np.abs(want2 - want).max() > 1e-3
    np.testing.assert_allclose(got2, want2, rtol=0, atol=5e-5)


def test_fully_padded_caption_gives_finite_images():
    """A caption with no word: the port's zero context (the Pallas kernel's
    result) keeps the image finite, where the JAX einsum chain gives NaN."""
    params, _ = _jax_generator("CONCEPT_INATTN_GEN")
    g = _port_generator("CONCEPT_INATTN_GEN", params)
    noise, sent, words, mask = _inputs()
    mask = mask.copy()
    mask[1] = True
    img = g(*map(torch.from_numpy, (noise, sent, words, mask)))
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("inner", ["in", "out"])
def test_attention_calls_follow_the_arch_table(inner, monkeypatch):
    """Two attention launches per attention block, at the shapes that
    ``attention_shapes`` derives from the table; on the CPU they take the
    plain version and the kernel's count stays put."""
    name = "CONCEPT_INATTN_GEN" if inner == "in" else "CONCEPT_OUTATTN_GEN"
    params, _ = _jax_generator(name)
    g = _port_generator(name, params)
    seen, real = [], pcg.masked_cross_attention

    def spy(q, k, v, mask, scale=1.0):
        q4 = q if q.dim() == 4 else q.unsqueeze(1)
        seen.append((q4.shape[0], q4.shape[1], q4.shape[2], k.shape[-2], q.shape[-1]))
        return real(q, k, v, mask, scale)

    monkeypatch.setattr(pcg, "masked_cross_attention", spy)
    before = ca.FORWARD.launches
    g(*map(torch.from_numpy, _inputs()))
    _, cfg = small_cfgs(_overrides())
    assert seen == pcg.attention_shapes(cfg, 2, inner)
    assert ca.FORWARD.launches == before


def test_launch_plan_at_full_width():
    """256², NCH=32: ten attention launches per request of either
    word-attention generator (N per In launch as listed), 28 modulations per
    concept-DF request (2 phases x 2 concept blocks x 7 GBlocks)."""
    _, cfg = small_cfgs({"TRAIN": {"NCH": 32}, "IMG": {"SIZE": 256},
                         "TEXT": {"MAX_LENGTH": 15}})
    arch = concept_gen_arch(256, 32)
    assert arch["in_channels"] == [512, 512, 256, 256, 128, 64, 32]
    shapes = pcg.attention_shapes(cfg, 128, "in")
    assert [s[2] for s in shapes] == [256, 1024, 1024, 4096, 4096, 16384, 16384, 65536,
                                      65536, 65536]
    assert {s[:2] + s[3:] for s in shapes} == {(128, 16, 15, 4)}
    assert pcg.attention_shapes(cfg, 128, "out") == [(128, 1, 16, 15, 4)] * 10
    mods = pdf.modulation_shapes(cfg, 128)
    assert len(mods) == 28 and mods[-1] == (128, 128, 256, 256)


# ----------------------------------------------------- names and entry points


@pytest.mark.parametrize("name", list(GENERATORS))
def test_converter_round_trip_and_names(name):
    """The converted tree loads strictly and gives back every value; the
    concept-DF names are the reference's: the JAX package's own reader of
    reference state_dicts (``convert.df_concept_generator_params``) turns
    them into the original tree."""
    params, _ = _jax_generator(name)
    sd = GENERATORS[name][2](params)
    g = _port_generator(name, params)
    for k, v in g.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    if "DF" in name:
        back = jax_reference_reader({k: v.numpy() for k, v in sd.items()})
        flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
        got = {jax.tree_util.keystr(p): v for p, v in flat(back)}
        want = {jax.tree_util.keystr(p): v for p, v in flat(params)}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_reference_norm_buffer_is_accepted():
    """A reference state_dict carries the self-attention sampler's
    ``rsqrt(state_dim)`` buffer ``norm``; the port computes it inline and
    ignores that entry."""
    params, _ = _jax_generator("CONCEPT_OUT_DF_GEN")
    sd = df_concept_generator_state_dict(params)
    sd["upblocks.0.concept1.concept_sampler1.norm"] = torch.tensor(0.5)
    _port_generator("CONCEPT_OUT_DF_GEN", params).load_state_dict(sd, strict=True)


def test_registry_resolves_the_four_generators():
    assert registry.get_generator("CONCEPT_IN_DF_GEN") is pdf.InNetG
    assert registry.get_generator("CONCEPT_OUT_DF_GEN") is pdf.OutNetG
    assert registry.get_generator("CONCEPT_INATTN_GEN") is pcg.InNetG
    assert registry.get_generator("CONCEPT_OUTATTN_GEN") is pcg.OutNetG
    assert registry.get_discriminator("CONCEPT_NETD") is pdf.NetD


def test_sampler_needs_words_for_word_attention():
    """``make_generator`` builds every concept family like ``NetG`` (dtype,
    fold, seed); a word-attention G sampled without words raises."""
    _, cfg = small_cfgs({**_overrides(), "GEN": {"ENCODER_NAME": "CONCEPT_OUTATTN_GEN"}})
    g = make_generator(cfg, torch.bfloat16, "cpu", fuse_upsample=False, seed=3)
    assert isinstance(g, pcg.OutNetG) and g.dtype == torch.bfloat16 and not g.training
    noise, sent, words, mask = _inputs()
    sample = make_sample_fn(cfg, g)
    with pytest.raises(ValueError, match="words_embs"):
        sample(noise, sent)
    img = sample(noise, sent, words, mask)
    assert img.shape == (2, 64, 64, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
