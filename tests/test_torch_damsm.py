"""The damsm_score plain version (the kernels' reference on the card) against
the JAX package's Pallas ``damsm_scores`` in interpret mode, as
``tests/test_pallas_ops.py`` runs it, and the autograd Function's routing on
CPU tensors.  The CUDA kernels themselves run in ``tests/test_torch_cuda.py``
(marker ``cuda``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmc_gan_tpu import losses as jl
from xmc_gan_tpu.ops.pallas.damsm_score import damsm_scores as pallas_damsm_scores
from xmc_gan_tpu_torch import losses as pl
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds

BF16_ULP = 2.0 ** -7
# fp32: the same math in another summation order (1e-5).  bf16: the Pallas
# kernel keeps c_hat in fp32 for rel and rounds the backward chain at its own
# points (stores of c_hat, d c_hat, d_c), the port rounds as autograd of the
# plain XLA formula does; the two differ by bf16 roundings, held to one bf16
# ulp of the largest magnitude.
TOL = {None: 1e-5, torch.bfloat16: BF16_ULP}


def _problem(b=3, bc=4, r=7, t=9, d=12, seed=0, allpad=True):
    rng = np.random.RandomState(seed)
    regions = rng.randn(b, r, d).astype(np.float32)
    words = rng.randn(bc, t, d).astype(np.float32)
    lens = rng.randint(1, t + 1, bc)
    mask = np.arange(t)[None, :] >= lens[:, None]
    if allpad:
        mask[1] = True
    g = rng.randn(b, bc).astype(np.float32)
    return regions, words, mask, g


def _port(regions, words, mask, g, cd, need_words=True):
    """Scores and (d_regions, d_words) through ``damsm_scores`` on the CPU,
    from raw inputs normalized in autograd as ``word_region_scores`` does."""
    r = torch.from_numpy(regions).requires_grad_()
    w = torch.from_numpy(words).requires_grad_(need_words)
    out = ds.damsm_scores(pl.l2_normalize(r), pl.l2_normalize(w), torch.from_numpy(mask),
                          4.0, 5.0, cd)
    grads = torch.autograd.grad(out, (r, w) if need_words else (r,), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax(regions, words, mask, g, cd, pallas: bool):
    jcd = jnp.bfloat16 if cd is not None else None

    def scores(r, w):
        if pallas:
            return pallas_damsm_scores(r, w, jnp.asarray(mask), 4.0, 5.0, jcd, interpret=True)
        return jl.word_region_scores(r, w, jnp.asarray(mask), 4.0, 5.0, block_elems=None,
                                     compute_dtype=jcd, backend="xla")

    out, vjp = jax.vjp(scores, jnp.asarray(regions), jnp.asarray(words))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("dims", [(3, 4, 7, 9, 12), (2, 3, 50, 7, 48)])
def test_plain_matches_pallas_interpret(cd, dims):
    """Values and both VJPs against the Pallas kernel (ragged R, T and D,
    none a multiple of the Pallas tiles), captions with words."""
    regions, words, mask, g = _problem(*dims, allpad=False)
    got, (dr, dw) = _port(regions, words, mask, g, cd)
    want, (wr, ww) = _jax(regions, words, mask, g, cd, pallas=True)
    tol = TOL[cd]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol * np.abs(want).max())
    _close(dr, wr, tol, "d_regions")
    _close(dw, ww, tol, "d_words")


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_all_padded_caption(cd):
    """An all-padded caption scores a finite -1e30 / gamma2 + log(T) / gamma2
    ~ -2e29 in both.  Its scores carry no gradient in the port, as in
    autograd of the JAX XLA path (the masked logits are constants); the
    Pallas backward instead spreads its upstream cotangent as g / T over the
    padded words (its softmax over all -1e30 logits is uniform), so on that
    caption the port is held to the XLA path and elsewhere to both."""
    regions, words, mask, g = _problem(seed=1)
    got, (dr, dw) = _port(regions, words, mask, g, cd)
    want_p, (pr, pw) = _jax(regions, words, mask, g, cd, pallas=True)
    want_x, (xr, xw) = _jax(regions, words, mask, g, cd, pallas=False)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 1], -1e30 / 5.0 + np.log(9) / 5.0, rtol=1e-6)
    np.testing.assert_allclose(got, want_p, rtol=1e-5, atol=TOL[cd])
    tol = TOL[cd]
    _close(dr, xr, tol, "d_regions vs XLA")
    _close(dw, xw, tol, "d_words vs XLA")
    assert np.abs(dw[1]).max() == 0.0
    keep = [0, 2, 3]
    _close(dw[keep], pw[keep], tol, "d_words vs Pallas, captions with words")
    # the Pallas d_regions differs by the padded caption's spread cotangent
    assert np.abs(dr - pr).max() > 0.1 * np.abs(dr).max()
    g0 = g.copy()
    g0[:, 1] = 0.0
    _, (pr0, _) = _jax(regions, words, mask, g0, cd, pallas=True)
    _close(dr, pr0, tol, "d_regions vs Pallas with the padded caption's cotangent zeroed")


def test_cpu_function_routes_to_plain_and_skips_d_words(monkeypatch):
    """On CPU tensors the Function takes the plain version (no launch is
    counted), and its backward computes only the inputs that need a
    gradient: with the words as data, d_words never runs."""
    regions, words, mask, g = _problem(seed=2, allpad=False)
    before = (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches)
    r, w = pl.l2_normalize(torch.from_numpy(regions)), pl.l2_normalize(torch.from_numpy(words))
    m = torch.from_numpy(mask)
    torch.testing.assert_close(ds.damsm_scores(r, w, m), ds.damsm_scores_ref(r, w, m),
                               rtol=0, atol=0)

    def no_d_words(*args):
        raise AssertionError("d_words ran for words that need no gradient")

    monkeypatch.setattr(ds, "_d_words", no_d_words)
    got, (dr,) = _port(regions, words, mask, g, None, need_words=False)
    want, (wr, _) = _jax(regions, words, mask, g, None, pallas=False)
    _close(dr, wr, 1e-5, "d_regions")
    assert (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches) == before


def test_function_rejects_what_the_kernels_do_not_take():
    r = torch.randn(2, 5, 8)
    w = torch.randn(3, 4, 8)
    m = torch.zeros(3, 4, dtype=torch.bool)
    with pytest.raises(TypeError, match="float32"):
        ds.damsm_scores(r.double(), w, m)
    with pytest.raises(ValueError, match="mask"):
        ds.damsm_scores(r, w, m[:, :3])
    with pytest.raises(ValueError, match=r"\[B, R, D\]"):
        ds.damsm_scores(r, w[..., :4], m)
    with pytest.raises(ValueError, match="compute_dtype"):
        ds.damsm_scores(r, w, m, compute_dtype=torch.float16)


def test_kernel_plan_mirrors_the_source():
    """Captions per block and shared memory as ``csrc/damsm_score.cu``
    computes them: at the flagship shape 3 captions (60 word rows) forward
    and 2 (40 rows) in the backward, within the 227 KB a block may use;
    T > 64 or D > 256 is refused."""
    vb, smem = ds.plan(256, 20, 256, False, 128)
    assert vb == 3 and smem <= ds.SMEM_LIMIT
    vb, smem = ds.plan(256, 20, 256, True, 128)
    assert vb == 2 and smem <= ds.SMEM_LIMIT
    assert ds.plan(50, 7, 48, True, 5)[0] == 5  # capped by the captions there are
    with pytest.raises(ValueError, match="T <= 64"):
        ds.plan(16, 65, 8, False, 4)
    with pytest.raises(ValueError, match="D <= 256"):
        ds.plan(16, 8, 260, False, 4)


def test_tensor_core_plan_mirrors_the_source():
    """The bf16 d_regions kernel's plan as ``csrc/damsm_score.cu`` computes
    its shared memory: at the flagship shape (B = Bc = 128, R = 256, T = 20,
    D = 256, 132 multiprocessors) passes of 32 word rows (48 do not fit
    beside the resident regions), one block per image with all 128 captions
    (one wave: a block takes a multiprocessor's shared memory), within the
    227 KB a block may use; fewer images get caption splits to fill the
    card; rows per pass are a multiple of 16 and hold a whole caption;
    T > 64, R > 256 and D > 256 are refused."""
    p = ds.plan_dr(256, 20, 256, 128, 128, 132)
    assert (p.rows, p.nsplit, p.captions) == (32, 1, 128)
    assert ds.plan_dr(256, 20, 256, 32, 128, 132)[1:3] == (4, 32)
    # the card tests' edge shapes: 132 images, one split, all captions a block
    assert ds.plan_dr(50, 20, 40, 132, 9, 132) == (64, 1, 9, ds.plan_dr(50, 20, 40, 1, 1, 1).smem)
    stage = 8 * 16 * ds.TC_STAGE  # the warps' d_r staging tiles, fp32
    assert p.smem == 2 * (256 * 264 + 32 * 4 * 264) + 4 * (stage + 15 * 32 + 4)
    assert p.smem <= ds.SMEM_LIMIT
    assert 2 * (256 * 264 + 48 * 4 * 264) + 4 * (stage + 15 * 48 + 4) > ds.SMEM_LIMIT
    for dims in [(50, 7, 48), (256, 20, 256), (24, 33, 24), (50, 64, 40), (5, 3, 12)]:
        p = ds.plan_dr(*dims, 3, 5, 132)
        assert p.rows % 16 == 0 and p.rows >= dims[1] and p.smem <= ds.SMEM_LIMIT
        assert p.nsplit * p.captions >= 5
    with pytest.raises(ValueError, match="T <= 64"):
        ds.plan_dr(16, 65, 8, 2, 4, 132)
    with pytest.raises(ValueError, match="D <= 256"):
        ds.plan_dr(16, 8, 260, 2, 4, 132)
    with pytest.raises(ValueError, match="R <= 256"):
        ds.plan_dr(300, 8, 16, 2, 4, 132)


def test_forward_plan_mirrors_the_source():
    """The bf16 forward kernel's plan as ``csrc/damsm_score.cu`` computes its
    shared memory: it keeps no d_c, d_sim or staging tiles, so at the
    flagship shape (B = Bc = 128, R = 256, T = 20, D = 256, 132
    multiprocessors) passes of 64 word rows fit beside the resident regions
    (d_regions: 32), in one split of all 128 captions; rows per pass are a
    multiple of 16 and hold a whole caption at the card tests' shapes;
    T > 64, R > 256 and D > 256 are refused."""
    p = ds.plan_fwd(256, 20, 256, 128, 128, 132)
    assert p == (64, 1, 128, 206_352)
    assert p.smem == 2 * (256 * 264 + 64 * 2 * 264) + 4 * (14 * 64 + 4) <= ds.SMEM_LIMIT
    assert ds.plan_fwd(256, 20, 256, 32, 128, 132)[1:3] == (4, 32)
    for b, bc, R, T, D in [(3, 5, 50, 7, 48), (2, 3, 5, 3, 12), (4, 7, 256, 20, 256),
                           (132, 7, 64, 7, 40), (132, 9, 50, 20, 40), (132, 2, 24, 33, 24),
                           (132, 3, 50, 64, 40), (132, 40, 256, 20, 256)]:
        p = ds.plan_fwd(R, T, D, b, bc, 132)
        assert p.rows % 16 == 0 and p.rows >= T and p.smem <= ds.SMEM_LIMIT
        assert p.nsplit * p.captions >= bc
    with pytest.raises(ValueError, match="T <= 64"):
        ds.plan_fwd(16, 65, 8, 2, 4, 132)
    with pytest.raises(ValueError, match="D <= 256"):
        ds.plan_fwd(16, 8, 260, 2, 4, 132)
    with pytest.raises(ValueError, match="R <= 256"):
        ds.plan_fwd(300, 8, 16, 2, 4, 132)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forward_ignores_padded_words(seed):
    """The bf16 forward kernel packs only the real words of each caption into
    its passes.  That is exact: in the plain version (the kernel's
    reference) a padded word's vector does not move any score, and an
    all-padded caption scores (-1e30 + log T) / gamma2 whatever its words."""
    regions, words, mask, _ = _problem(b=3, bc=5, r=16, t=9, d=24, seed=seed)
    r = pl.l2_normalize(torch.from_numpy(regions))
    w = pl.l2_normalize(torch.from_numpy(words))
    m = torch.from_numpy(mask)
    other = pl.l2_normalize(torch.from_numpy(
        np.random.RandomState(seed + 10).randn(*words.shape).astype(np.float32)))
    w2 = torch.where(m[..., None], other, w)
    assert not torch.equal(w, w2)
    for cd in (None, torch.bfloat16):
        want = ds.damsm_scores_ref(r, w, m, 4.0, 5.0, cd)
        torch.testing.assert_close(ds.damsm_scores_ref(r, w2, m, 4.0, 5.0, cd), want,
                                   rtol=0, atol=0)
        assert torch.equal(want[:, 1], torch.full((3,), (ds.NEG + np.log(np.float32(9))) / 5.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_d_regions_ignores_padded_words(seed):
    """The bf16 d_regions kernel packs only the real words of each caption
    into its passes.  That is exact: in the plain version (the kernel's
    reference) a padded word's values do not reach d_regions at all."""
    regions, words, mask, g = _problem(b=3, bc=5, r=16, t=9, d=24, seed=seed)
    r = pl.l2_normalize(torch.from_numpy(regions))
    w = pl.l2_normalize(torch.from_numpy(words))
    m = torch.from_numpy(mask)
    other = pl.l2_normalize(torch.from_numpy(
        np.random.RandomState(seed + 10).randn(*words.shape).astype(np.float32)))
    w2 = torch.where(m[..., None], other, w)
    assert not torch.equal(w, w2)
    gt = torch.from_numpy(g)
    for cd in (None, torch.bfloat16):
        want = ds._plain_vjp("dr", r, w, m, gt, 4.0, 5.0, cd)
        got = ds._plain_vjp("dr", r, w2, m, gt, 4.0, 5.0, cd)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
