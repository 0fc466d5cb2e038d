"""The port's losses against the JAX package's ``losses.py``: values and input
gradients of every loss, the label quirk, the word-region scores' plain path
(single einsum and checkpointed caption blocks), the backend rule, and the
MAGP penalty with its gradient in a small D's parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JaxNetD, d_overrides, jax_d_variables, port_d, small_cfgs
from xmc_gan_tpu import losses as jl
from xmc_gan_tpu_torch import losses as pl
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.utils.convert import df_gan_discriminator_state_dict

# fp32 on both sides, the same expressions: differences are summation order
# in the products and reductions (~1e-7 relative); held to 1e-5.
TOL = dict(rtol=1e-5, atol=1e-6)


def _sents(seed=0, b=6, d=8):
    """Sentence embeddings for which ``B_GLOBAL`` finds soft positives
    (cosine > 0.6) in some rows and none in others, with different counts:
    row 0 (a + b) is close to rows 1 (a) and 2 (b), which are not close to
    each other; rows 3 and 4 are a near-duplicate pair."""
    rng = np.random.RandomState(seed)
    s = rng.randn(b, d).astype(np.float32)
    a, c = np.zeros(d, np.float32), np.zeros(d, np.float32)
    a[: d // 2], c[d // 2:] = rng.randn(d // 2), rng.randn(d // 2)
    c *= np.linalg.norm(a) / np.linalg.norm(c)
    s[0], s[1], s[2] = a + c, a, c
    s[4] = s[3] + 0.1 * rng.randn(d)
    return s


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("b_global,smooth", [(False, 0.0), (True, 0.0), (True, 0.5)])
def test_labels_and_num_pos_match_jax(b_global, smooth):
    """Including the per-column ``1 / num_pos`` weight with SMOOTH.GLOBAL = 0
    (``labels[i, j] = 1 / num_pos[j]``, not per row)."""
    s = _sents()
    got = pl.make_labels(_t(s), b_global, smooth)
    want = np.asarray(jl.make_labels(jnp.asarray(s), b_global, smooth))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    if b_global and smooth == 0.0:
        off = got - torch.eye(6)
        pos = off > 0
        num_pos = pos.sum(1).clamp_min(1) + 1
        i, j = pos.nonzero(as_tuple=True)
        assert 0 < len(i) < 30 and bool((num_pos[i] != num_pos[j]).any())  # has teeth
        torch.testing.assert_close(off[i, j], 1.0 / num_pos[j].float())  # per column
    np.testing.assert_allclose(pl.contrastive_num_pos(got, b_global, smooth).numpy(),
                               np.asarray(jl.contrastive_num_pos(jnp.asarray(want), b_global,
                                                                 smooth)), rtol=0, atol=0)


def test_l2_normalize_and_cosine_match_jax():
    rng = np.random.RandomState(1)
    x, y = rng.randn(5, 7).astype(np.float32), rng.randn(4, 7).astype(np.float32)
    x[2] = 0.0  # max(norm, eps) keeps the zero row finite
    np.testing.assert_allclose(pl.l2_normalize(_t(x)).numpy(),
                               np.asarray(jl.l2_normalize(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(pl.cosine_scores(_t(x), _t(y)).numpy(),
                               np.asarray(jl.cosine_scores(jnp.asarray(x), jnp.asarray(y))), **TOL)
    with pytest.raises(ValueError, match="mismatched feature dims"):
        pl.cosine_scores(_t(x), _t(y[:, :3]))


@pytest.mark.parametrize("name", ["sent_loss", "img_loss"])
@pytest.mark.parametrize("b_global,smooth", [(False, 0.0), (True, 0.0), (True, 0.5)])
def test_contrastive_losses_and_grads_match_jax(name, b_global, smooth):
    rng = np.random.RandomState(2)
    a, b = rng.randn(6, 8).astype(np.float32), rng.randn(6, 8).astype(np.float32)
    labels_j = jl.make_labels(jnp.asarray(_sents()), b_global, smooth)
    labels_p = pl.make_labels(_t(_sents()), b_global, smooth)
    jfn = getattr(jl, name)
    want, (ga, gb) = jax.value_and_grad(
        lambda x, y: jfn(x, y, labels_j, b_global, smooth), argnums=(0, 1))(a, b)
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = getattr(pl, name)(ta, tb, labels_p, b_global, smooth)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **TOL)


@pytest.mark.parametrize("name", ["hinge_real", "hinge_fake", "generator_loss"])
def test_adversarial_losses_and_grads_match_jax(name):
    x = np.random.RandomState(3).randn(9).astype(np.float32) * 2
    want, g = jax.value_and_grad(getattr(jl, name))(x)
    t = _t(x).requires_grad_()
    got = getattr(pl, name)(t)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def _word_problem(seed=4, b=3, r=7, t=5, d=6, allpad=True):
    rng = np.random.RandomState(seed)
    regions = rng.randn(b, r, d).astype(np.float32)
    words = rng.randn(b, t, d).astype(np.float32)
    lens = rng.randint(1, t + 1, b)
    mask = np.arange(t)[None, :] >= lens[:, None]
    if allpad:
        mask[1] = True
    return regions, words, mask


# word scores and grads.  fp32: 1e-5 as above.  bf16 operands on both sides
# (the same roundings at the same points), fp32 accumulation in another
# order: an operand near a rounding boundary can round to the neighbouring
# bf16 value, so one bf16 ulp (2^-7) of the largest magnitude.
WORD_TOL = {None: 1e-5, "bf16": 2.0 ** -7}


@pytest.mark.parametrize("cd", [None, "bf16"])
@pytest.mark.parametrize("block_elems", [None, 40])
def test_word_region_scores_plain_path_matches_jax(cd, block_elems):
    """The plain path (one einsum chain, or caption blocks under
    ``torch.utils.checkpoint`` when the [B, Bc, T, R] intermediate exceeds
    ``block_elems``) against the JAX XLA path at the same threshold: scores
    and the gradients in regions and words, with an all-padded caption."""
    regions, words, mask = _word_problem()
    jcd = jnp.bfloat16 if cd else None
    tcd = torch.bfloat16 if cd else None
    gup = np.random.RandomState(5).randn(3, 3).astype(np.float32)

    def jloss(r, w):
        s = jl.word_region_scores(r, w, jnp.asarray(mask), block_elems=block_elems,
                                  compute_dtype=jcd, backend="xla")
        return jnp.sum(s * gup), s

    (_, want), (gr, gw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        regions, words)
    tr, tw = _t(regions).requires_grad_(), _t(words).requires_grad_()
    got = pl.word_region_scores(tr, tw, torch.from_numpy(mask), block_elems=block_elems,
                                compute_dtype=tcd, backend="plain")
    (got * _t(gup)).sum().backward()
    tol = WORD_TOL[cd]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=tol * np.abs(np.asarray(want)[:, [0, 2]]).max())
    assert np.isfinite(got.detach().numpy()).all() and got[0, 1].item() < -1e29
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gr), rtol=0,
                               atol=tol * np.abs(np.asarray(gr)).max())
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=0,
                               atol=tol * np.abs(np.asarray(gw)).max())


def test_blocked_plain_path_equals_single():
    """Blocking splits only the caption axis (no softmax crosses it):
    identical values and gradients up to fp32 summation order."""
    regions, words, mask = _word_problem(seed=6, b=4, allpad=False)
    outs = []
    for be in (None, 30):
        r = _t(regions).requires_grad_()
        s = pl.word_region_scores(r, _t(words), torch.from_numpy(mask), block_elems=be,
                                  backend="plain")
        s.sum().backward()
        outs.append((s.detach(), r.grad))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b_global", [False, True])
def test_word_loss_and_grads_match_jax(b_global):
    regions, words, mask = _word_problem(seed=7, b=6, allpad=False)
    sents = _sents()
    labels_j = jl.make_labels(jnp.asarray(sents), b_global, 0.0)
    labels_p = pl.make_labels(_t(sents), b_global, 0.0)
    want, gr = jax.value_and_grad(lambda r: jl.word_loss(
        r, jnp.asarray(words), jnp.asarray(mask), labels_j, b_global, 0.0, backend="xla"))(regions)
    tr = _t(regions).requires_grad_()
    got = pl.word_loss(tr, _t(words), torch.from_numpy(mask), labels_p, b_global, 0.0,
                       backend="plain")
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gr), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gr)).max())


def test_word_scores_backend_rule():
    """The kernel exactly where the plain path would block and the operands
    are CUDA tensors; the plain path otherwise (the JAX rule, "TPU backend"
    read as "CUDA tensor").  The LN config's shape (B = Bc = 256, R = 256,
    T = 200, word width 768) routes to the kernels, which take it as 16-slot
    sub-captions in fp32 and 32-slot ones in bf16: a small LN-like problem on the kernel
    route computes and matches the plain path.  Past D = 1024 the kernel
    route computes too (the feature-streamed kernels' width, their rows at
    R) and matches the plain path."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    block = pl.WORD_LOSS_BLOCK_ELEMS
    assert pl.word_scores_backend(128, 128, 20, 256, block, cuda) == "kernel"
    assert pl.word_scores_backend(128, 128, 20, 256, block, cpu) == "plain"
    assert pl.word_scores_backend(64, 64, 20, 256, block, cuda) == "plain"
    assert pl.word_scores_backend(2, 2, 3, 4, 0, cuda) == "kernel"
    assert pl.word_scores_backend(2, 2, 3, 4, None, cuda) == "plain"
    assert pl.word_scores_backend(256, 256, 200, 256, 2**26, cuda) == "kernel"
    jax_name = {"xla": "plain", "pallas": "kernel"}
    for args in [(128, 128, 20, 256, block), (2, 2, 3, 4, 0)]:
        assert pl.word_scores_backend(*args, cpu) == jax_name[jl.word_scores_backend(*args)]
    rng = np.random.RandomState(0)
    regions, words = rng.randn(2, 256, 768), rng.randn(3, 200, 768)
    mask = torch.from_numpy(rng.rand(3, 200) > 0.5)
    for cd in (None, torch.float32, torch.bfloat16):
        for r_regions, t, d in [(256, 20, 256), (256, 200, 768), (256, 200, 256),
                                (256, 20, 768), (300, 20, 256), (256, 200, 1024)]:
            assert 1 <= ds.sub_caption_width(r_regions, t, d, cd) <= t
        assert ds.route("fwd", 256, 1032, cd) == ds.STREAMED_FEATURES
        assert ds.sub_caption_width(256, 200, 1032, cd) == ds.fs_rows(256, True) == 64
        wide = (_t(rng.randn(2, 4, 1032)), _t(rng.randn(2, 5, 1032)),
                torch.zeros(2, 5, dtype=torch.bool))
        got = pl.word_region_scores(*wide, compute_dtype=cd, backend="kernel")
        want = pl.word_region_scores(*wide, compute_dtype=cd, backend="plain")
        assert got.shape == (2, 2) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        # a small LN-like problem (T = 200, D = 768, R = 256) on the kernel route
        assert ds.sub_caption_width(256, 200, 768, cd) == (16 if cd == torch.bfloat16 else 8)
        got = pl.word_region_scores(_t(regions), _t(words), mask, compute_dtype=cd,
                                    backend="kernel")
        want = pl.word_region_scores(_t(regions), _t(words), mask, compute_dtype=cd,
                                     backend="plain")
        assert bool(torch.isfinite(got).all())
        tol = 1e-5 if cd != torch.bfloat16 else 2.0 ** -7
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol * want.abs().max().item())


def test_explicit_backend_is_obeyed_without_fallback():
    """``backend="kernel"`` on CPU tensors goes through the damsm Function,
    which takes its plain version there (and counts no launch); an unknown
    backend raises."""
    regions, words, mask = _word_problem(seed=8)
    args = (_t(regions), _t(words), torch.from_numpy(mask))
    before = (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches)
    torch.testing.assert_close(pl.word_region_scores(*args, backend="kernel"),
                               pl.word_region_scores(*args, backend="plain"), rtol=0, atol=0)
    assert (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches) == before
    with pytest.raises(ValueError, match="word-score backend"):
        pl.word_region_scores(*args, backend="pallas")
    with pytest.raises(ValueError, match="compute_dtype"):
        pl.word_region_scores(*args, compute_dtype=torch.float16)


def test_magp_penalty_and_d_grads_match_jax():
    """``2 * mean(||grad_{img,sent} D||^6)`` and its gradient in D's
    parameters (a second-order gradient through the trunk), on a 64², NCH=2
    spectral-norm D.  Tolerance: the penalty's sixth power multiplies the
    fp32 convolution differences (~1e-6) by six; values to 1e-4 relative,
    gradients to 1e-4 of each tensor's largest magnitude."""
    jcfg, cfg = small_cfgs(d_overrides(64, word=False))
    params, spectral = jax_d_variables(jcfg, seed=5)
    rng = np.random.RandomState(9)
    imgs = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    sent = rng.randn(3, cfg.TEXT.EMBEDDING_DIM).astype(np.float32)
    jd = JaxNetD(jcfg)

    def jpen(p):
        def d_scalar(i, s):
            v = {"params": p, "spectral": spectral}
            return jd.apply(v, i, s, method="d_all")[0].astype(jnp.float32).sum()
        return jl.magp_penalty(d_scalar, jnp.asarray(imgs), jnp.asarray(sent))

    want, jgrads = jax.jit(jax.value_and_grad(jpen))(params)
    d = port_d(cfg, params, spectral)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    got = pl.magp_penalty(lambda i, s: d.d_all(i, s)[0].float().sum(), x, _t(sent))
    names = [n for n, _ in d.named_parameters()]
    # the image-feature projection does not reach the match logit: no grad
    grads = torch.autograd.grad(got, list(d.parameters()), allow_unused=True)
    assert got.item() > 0 and got.item() == pytest.approx(float(want), rel=1e-4)
    want_sd = df_gan_discriminator_state_dict(jax.tree.map(np.asarray, jgrads))
    for n, g in zip(names, grads):
        w = want_sd[n]
        g = torch.zeros_like(w) if g is None else g
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max().item() + 1e-12,
                                   msg=n)
