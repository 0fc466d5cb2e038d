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
