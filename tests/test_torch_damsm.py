"""The damsm_score plain version (the kernels' reference on the card) against
the JAX package's Pallas ``damsm_scores`` in interpret mode, as
``tests/test_pallas_ops.py`` runs it, and the autograd Function's routing on
CPU tensors.  The CUDA kernels themselves run in ``tests/test_torch_cuda.py``
(marker ``cuda``)."""

import re
from pathlib import Path

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


def _long_problem(b, bc, r, t, d, width, seed):
    """About half the word slots real, padding scattered (as
    ``benchmarks/ln_word_loss.py`` draws the LN mask); caption 1 all padded;
    caption 2's 3 real words in its second run of ``width`` slots, which
    the split packs into one sub-caption beside all-padded ones."""
    rng = np.random.RandomState(seed)
    regions = rng.randn(b, r, d).astype(np.float32)
    words = rng.randn(bc, t, d).astype(np.float32)
    mask = rng.rand(bc, t) > 0.5
    mask[0, 0] = False
    mask[1] = True
    mask[2] = True
    mask[2, width + 1:width + 4] = False
    g = rng.randn(b, bc).astype(np.float32)
    return regions, words, mask, g


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("dims", [(2, 3, 256, 200, 768), (2, 3, 50, 77, 520),
                                  (2, 3, 256, 130, 256), (2, 3, 256, 64, 256)], ids=str)
def test_long_captions_match_jax(cd, dims):
    """Captions longer than a block's rows go through as sub-captions
    (``sub_caption_width``: 16 at the LN word shape, T = 200, D = 768, in
    fp32 and 32 in bf16, the tensor-core kernels' rows a pass; a
    ragged T = 77, D = 520; T = 130 at D = 256, on the tensor cores in
    bf16; T = 64 at R = D = 256, which fits the forward but not the
    backward kernels), and the scores and both VJPs match the JAX XLA path and the
    Pallas kernel in interpret mode on the whole captions, under ``TOL``.
    The fully padded caption scores exactly the plain version's
    (-1e30 + log T) / gamma2 and gets no gradient; the Pallas backward
    gives it one (``test_all_padded_caption``), so there the port is held
    to the XLA path, and to Pallas with that caption's cotangent zeroed."""
    b, bc, R, T, D = dims
    width = ds.sub_caption_width(R, T, D, cd)
    assert width < T
    regions, words, mask, g = _long_problem(*dims, width, seed=3)
    got, (dr, dw) = _port(regions, words, mask, g, cd)
    want_x, (xr, xw) = _jax(regions, words, mask, g, cd, pallas=False)
    g0 = g.copy()
    g0[:, 1] = 0.0
    want_p, (pr, pw) = _jax(regions, words, mask, g0, cd, pallas=True)
    tol = TOL[cd]
    plain = ds.damsm_scores_ref(pl.l2_normalize(torch.from_numpy(regions)),
                                pl.l2_normalize(torch.from_numpy(words)),
                                torch.from_numpy(mask), 4.0, 5.0, cd).numpy()
    assert np.array_equal(got[:, 1], plain[:, 1])
    assert np.abs(dw[1]).max() == 0.0
    for want in (want_x, want_p):
        real = want[:, [0, 2]]
        np.testing.assert_allclose(got[:, [0, 2]], real, rtol=1e-5,
                                   atol=tol * np.abs(real).max())
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    _close(dr, xr, tol, "d_regions vs XLA")
    _close(dw, xw, tol, "d_words vs XLA")
    _close(dr, pr, tol, "d_regions vs Pallas, the padded caption's cotangent zeroed")
    _close(dw[[0, 2]], pw[[0, 2]], tol, "d_words vs Pallas, captions with words")


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
    """Captions per block and shared memory of the CUDA-core kernels as
    ``csrc/damsm_score.cu`` computes them: at the flagship shape 3 captions
    (60 word rows) forward and 2 (40 rows) in the backward, within the 227 KB
    a block may use; at the LN word shape (R = 256, D = 768) 18 rows forward
    and 16 backward, so one 16-slot sub-caption a block (T = 200 is at most 13 of
    them); T > 64 and D > 1024 are refused."""
    vb, smem = ds.plan(256, 20, 256, False, 128)
    assert vb == 3 and smem <= ds.SMEM_LIMIT
    vb, smem = ds.plan(256, 20, 256, True, 128)
    assert vb == 2 and smem <= ds.SMEM_LIMIT
    assert ds.plan(50, 7, 48, True, 5)[0] == 5  # capped by the captions there are
    assert (ds.cuda_core_rows(256, 768, False), ds.cuda_core_rows(256, 768, True)) == (18, 16)
    fixed, per_row = 4 * 32 * (768 + 4), 4 * (2 * 768 + 2 * 256 + 4)
    assert (fixed, per_row) == (98_816, 8_208)
    assert ds.plan(256, 16, 768, True, 256 * 13) == (1, fixed + 16 * per_row)
    assert fixed + 17 * per_row > ds.SMEM_LIMIT
    assert ds.plan(256, 16, 768, False, 256 * 13)[0] == 1
    assert ds.plan(256, 9, 1024, True, 4)[0] == 1  # D = 1024: 9 rows
    with pytest.raises(ValueError, match="T <= 64"):
        ds.plan(16, 65, 8, False, 4)
    with pytest.raises(ValueError, match="D <= 1024"):
        ds.plan(16, 8, 1032, False, 4)
    with pytest.raises(ValueError, match="shared memory"):
        ds.plan(256, 17, 768, True, 4)


@pytest.mark.parametrize("which", ["fwd", "dr", "dw"])
def test_route_rule(which):
    """One rule per kernel (``route``): the bf16 forward, d_regions and
    d_words on the tensor cores if and only if R <= 256 and D <= 1024 (the
    forward's and d_regions' regions resident at D <= 256, streamed above;
    the d_words' streamed at every D); the fp32 forward and d_regions
    packed under the same rule (the flagship's (256, 256), (50, 40) on the
    packed kernels, D > 256 such as (256, 264) on the wide ones; not
    (300, 48) or (256, 1025)); the fp32 d_words and every other fp32 launch
    on the CUDA cores."""
    flagship = [(256, 256), (50, 48), (50, 40), (1, 1)]
    wide = [(256, 768), (16, 264), (256, 264), (256, 1024), (64, 770), (50, 520)]
    never = [(257, 256), (300, 16), (300, 48), (257, 768), (256, 1025)]
    for R, D in flagship + wide + never:
        assert ds.route(which, R, D, None) != ds.TENSOR_CORES
        assert ds.route(which, R, D, torch.float32) != ds.TENSOR_CORES
    tc = flagship + wide
    packed = {"fwd": flagship + wide, "dr": flagship + wide, "dw": []}[which]
    for R, D in flagship + wide + never:
        assert (ds.route(which, R, D, torch.bfloat16) == ds.TENSOR_CORES) == ((R, D) in tc), (R, D)
        for cd in (None, torch.float32, torch.bfloat16):
            want = (ds.TENSOR_CORES if (R, D) in tc else ds.CUDA_CORES) if cd == torch.bfloat16 \
                else (ds.PACKED_FP32 if (R, D) in packed else ds.CUDA_CORES)
            assert ds.route(which, R, D, cd) == want, (which, R, D, cd)
            # the name of the kernel launched: regions resident or streamed on
            # the tensor cores, the fp32 forward or d_regions with packed
            # words, else the CUDA-core kernels
            name = ds.kernel_name(which, R, D, cd)
            if want == ds.TENSOR_CORES and which == "dw":
                assert name == "damsm_bwd_dw_tcs_kernel<", (R, D, name)
            elif want == ds.TENSOR_CORES:
                assert ("_tcs_" if D > ds.TC_MAX_RD else "_tc_") in name, (which, R, D, name)
            elif want == ds.PACKED_FP32:
                f32 = "f32w" if (R, D) in wide else "f32"
                assert name == {"fwd": f"damsm_fwd_{f32}_kernel<",
                                "dr": f"damsm_bwd_dr_{f32}_kernel<"}[which], (R, D, cd, name)
            else:
                assert "_tc" not in name and "_f32_" not in name, (which, R, D, cd, name)
    assert ds.kernel_name("dr", 300, 48, None) == "damsm_bwd_dr_kernel<float"
    assert ds.kernel_name("fwd", 300, 48, None) == "damsm_fwd_kernel<"
    assert ds.kernel_name("fwd", 256, 264, torch.float32) == "damsm_fwd_f32w_kernel<"
    assert ds.kernel_name("fwd", 256, 1025, torch.float32) == "damsm_fwd_kernel<"
    assert ds.kernel_name("dw", 300, 256, torch.bfloat16) == "damsm_bwd_dw_kernel<"
    assert ds.kernel_name("dw", 256, 256, None) == "damsm_bwd_dw_kernel<"
    with pytest.raises(ValueError, match="which"):
        ds.route("d_regions", 256, 256, torch.bfloat16)


@pytest.mark.parametrize("cd", [None, torch.float32, torch.bfloat16])
def test_sub_caption_width_mirrors_the_plans(cd):
    """T where every kernel of the route holds a caption (no split: the
    flagship's T = 20 and the card tests' edge shapes but T = 64 in fp32),
    else the largest width all of them hold: at the LN word shape 16 in
    fp32 (the CUDA-core d_words) and 32 in bf16 (the tensor-core kernels'
    passes, the d_words' too); 32 at R = D = 256 in bf16 (the tensor-core
    d_regions), 48 in fp32 at R, D <= 256 (the CUDA-core backward there, and
    the fp32 d_regions' passes of packed words, which take T = 64 only as
    sub-captions; the fp32 forward's passes hold 64 rows), 32 at D = 520 in
    both dtypes (bf16: the streamed kernels' passes; fp32: the wide packed
    kernels'); at D = 1024 9 in fp32 (the CUDA-core backward) and 16 in
    bf16 (the tensor-core d_regions and d_words).  Each width is a plan the
    route's kernels take (the CUDA-core ones only where the route has one);
    D > 1024 and regions too many for one row are refused, naming the
    limit; nothing depends on the device."""
    bf16 = cd == torch.bfloat16
    for R, T, D in [(256, 20, 256), (50, 7, 48), (64, 7, 40), (50, 20, 40), (24, 33, 24),
                    (5, 3, 12)]:
        assert ds.sub_caption_width(R, T, D, cd) == T
    assert ds.sub_caption_width(50, 64, 40, cd) == (64 if bf16 else 48)
    assert ds.sub_caption_width(256, 200, 768, cd) == (32 if bf16 else 16)
    assert ds.sub_caption_width(50, 77, 520, cd) == 32  # streamed or wide: 32 rows
    assert ds.sub_caption_width(256, 130, 256, cd) == (32 if bf16 else 48)
    assert ds.sub_caption_width(256, 64, 256, cd) == (32 if bf16 else 48)
    assert ds.sub_caption_width(256, 200, 1024, cd) == (16 if bf16 else 9)
    for R, T, D in [(256, 200, 768), (256, 130, 256), (50, 77, 520), (256, 77, 520),
                    (300, 40, 256), (7, 200, 768), (256, 200, 1024), (50, 64, 40)]:
        width = ds.sub_caption_width(R, T, D, cd)
        assert 1 <= width <= 64 and width <= T
        if any(ds.route(which, R, D, cd) == ds.CUDA_CORES for which in ("fwd", "dr", "dw")):
            for backward in (False, True):
                assert ds.plan(R, width, D, backward, 4)[0] >= 1
        if ds.route("dw", R, D, cd) == ds.TENSOR_CORES:
            assert ds.plan_dw(R, width, D, 4, 4, 132).rows >= width
        if ds.route("fwd", R, D, cd) == ds.TENSOR_CORES:
            assert ds.plan_fwd(R, width, D, 4, 4, 132).rows >= width
        if ds.route("dr", R, D, cd) == ds.TENSOR_CORES:
            assert ds.plan_dr(R, width, D, 4, 4, 132).rows >= width
        if ds.route("fwd", R, D, cd) == ds.PACKED_FP32:
            assert ds.plan_fwd_f32(R, width, D, 4, 4, 132).rows >= width
        if ds.route("dr", R, D, cd) == ds.PACKED_FP32:
            assert ds.plan_dr_f32(R, width, D, 4, 4, 132).rows >= width
    # the LN word shape: the bf16 forward, d_regions and d_words there
    # (streamed regions) hold 32 rows a pass, the fp32 route's CUDA-core
    # d_words 16
    assert ds.plan_fwd(256, 16, 768, 256, 2048, 132).rows == 32
    assert ds.plan_dr(256, 16, 768, 256, 2048, 132).rows == 32
    assert ds.plan_dw(256, 32, 768, 256, 1024, 132).rows == 32
    assert ds.cuda_core_rows(256, 768, backward=True) == 16
    with pytest.raises(ValueError, match="D <= 1024"):
        ds.sub_caption_width(256, 20, 1025, cd)
    with pytest.raises(ValueError, match="shared memory"):
        ds.sub_caption_width(16384, 20, 768, cd)


def test_fp32_forward_and_d_regions_pack_under_one_rule():
    """``sub_caption_width`` asks ``route`` once for the two packed fp32
    kernels: at every R, D the forward packs iff the d_regions does, and the
    forward's 64 rows a pass hold more than the d_regions' 48, so the
    d_regions sets the fp32 width there."""
    for R in (1, 24, 50, 256, 257, 300):
        for D in (12, 42, 256, 264, 768):
            assert ds.route("fwd", R, D, None) == ds.route("dr", R, D, None)
    fwd = ds._tc_rows(lambda m: ds._f32_smem(m, False), ds.F32_FWD_ROWS)
    dr = ds._tc_rows(lambda m: ds._f32_smem(m, True), ds.F32_ROWS)
    assert (fwd, dr) == (64, 48)
    assert ds.sub_caption_width(256, 130, 256, None) == dr


def test_split_captions_and_combine():
    """``split_captions`` moves each caption's real words to the front in
    their order, drops the slots past the longest caption and pads the last
    sub-caption with masked zero slots; autograd scatters d_words back to
    the slots kept; ``combine_sub_scores`` is ``logsumexp_k(gamma2 * s) / gamma2`` with the
    gradient ``g * softmax_k``; an all-padded sub-caption adds exactly 0 and
    gets exactly 0; a fully padded caption keeps its value bit for bit."""
    w = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3).requires_grad_()
    mask = torch.tensor([[False, True, False, False, True], [True] * 5])
    ws, ms = ds.split_captions(w, mask, 2)
    assert ws.shape == (4, 2, 3) and ms.shape == (4, 2)  # 3 real words at most: 2 + 1 slots
    ws, ms = ws.reshape(2, 4, 3), ms.reshape(2, 4)
    assert torch.equal(ws[0, :3], w[0, [0, 2, 3]]) and torch.equal(ws[1, :3], w[1, :3])
    assert not ws[:, 3].any()
    assert ms[0].tolist() == [False, False, False, True] and ms[1].all()
    (dw,) = torch.autograd.grad(ws, w, torch.ones_like(ws))
    kept = torch.tensor([[1, 0, 1, 1, 0], [1, 1, 1, 0, 0]], dtype=torch.float32)
    assert torch.equal(dw, kept[..., None].expand(2, 5, 3))  # the n = 3 slots kept
    ws, ms = ds.split_captions(w, mask, 8)  # one sub-caption of the 3 slots
    assert ws.shape == (2, 3, 3) and torch.equal(ws[0], w[0, [0, 2, 3]])
    ws, ms = ds.split_captions(w, torch.ones(2, 5, dtype=torch.bool), 2)  # no word at all
    assert ws.shape == (2, 1, 3) and ms.all()
    pad = (ds.NEG + np.log(np.float32(16))) / 5.0
    s = torch.tensor([[[0.3, -0.2, pad], [pad, pad, pad]]], requires_grad=True)
    out = ds.combine_sub_scores(s, 5.0)
    torch.testing.assert_close(out[0, 0], torch.logsumexp(5.0 * s[0, 0, :2], 0) / 5.0)
    assert out[0, 1].item() == np.float32(pad)
    (g,) = torch.autograd.grad(out, s, torch.tensor([[2.0, 3.0]]))
    torch.testing.assert_close(g[0, 0, :2], 2.0 * torch.softmax(5.0 * s[0, 0, :2].detach(), 0))
    assert g[0, 0, 2].item() == 0.0
    torch.testing.assert_close(g[0, 1], torch.full((3,), 1.0))


def _source_constant(name: str) -> int:
    """``constexpr int <name> = <value>`` from ``csrc/damsm_score.cu``."""
    src = (Path(ds.__file__).resolve().parents[2] / "csrc" / "damsm_score.cu").read_text()
    found = re.findall(rf"constexpr int (?:\w+ = \w+, )?{name} = (\d+)", src)
    assert len(found) == 1, (name, found)
    return int(found[0])


@pytest.mark.parametrize("D", [256, 264, 520, 768, 1024])
def test_tensor_core_plan_mirrors_the_source(D):
    """The bf16 d_regions kernel's plan as ``csrc/damsm_score.cu`` computes
    its shared memory, with the constants read from the source.  D = 256,
    regions resident: at the flagship shape (B = Bc = 128, R = 256, T = 20,
    132 multiprocessors) passes of 32 word rows (48 do not fit beside the
    resident regions), one block per image with all 128 captions (one wave:
    a block takes a multiprocessor's shared memory), within the 227 KB a
    block may use; fewer images get caption splits to fill the card; rows
    per pass are a multiple of 16 and hold a whole caption; T > 64 and
    R > 256 are refused.  D > 256, regions streamed in 64-column chunks:
    words and d_c ``[rows, Dp + 8]``, a and d_sim ``[rows, Rp + 8]`` (bf16),
    a union of the two region chunk buffers and the warps' d_r staging
    tiles, 15 words a row; 32 rows a pass where they fit (to D = 768 at
    R = 256; 16 at D = 1024); T > 32 and D > 1024 are refused."""
    assert (_source_constant("SMEM_LIMIT"), _source_constant("TC_STAGE"),
            _source_constant("TC_MAX_RD")) == (ds.SMEM_LIMIT, ds.TC_STAGE, ds.TC_MAX_RD)
    assert (_source_constant("TCS_KC"), _source_constant("TCS_MAX_D"),
            _source_constant("TCS_MAX_ROWS")) == (ds.TCS_KC, ds.TCS_MAX_D, ds.TCS_ROWS[0])
    stage = 8 * 16 * ds.TC_STAGE  # the warps' d_r staging tiles, fp32
    with pytest.raises(ValueError, match="R <= 256"):
        ds.plan_dr(300, 8, D, 2, 4, 132)
    if D == 256:
        p = ds.plan_dr(256, 20, 256, 128, 128, 132)
        assert (p.rows, p.nsplit, p.captions) == (32, 1, 128)
        assert ds.plan_dr(256, 20, 256, 32, 128, 132)[1:3] == (4, 32)
        # the card tests' edge shapes: 132 images, one split, all captions a block
        assert ds.plan_dr(50, 20, 40, 132, 9, 132) == (64, 1, 9, ds.plan_dr(50, 20, 40, 1, 1, 1).smem)
        assert p.smem == 2 * (256 * 264 + 32 * 4 * 264) + 4 * (stage + 15 * 32 + 4)
        assert p.smem <= ds.SMEM_LIMIT
        assert 2 * (256 * 264 + 48 * 4 * 264) + 4 * (stage + 15 * 48 + 4) > ds.SMEM_LIMIT
        for dims in [(50, 7, 48), (256, 20, 256), (24, 33, 24), (50, 64, 40), (5, 3, 12)]:
            p = ds.plan_dr(*dims, 3, 5, 132)
            assert p.rows % 16 == 0 and p.rows >= dims[1] and p.smem <= ds.SMEM_LIMIT
            assert p.nsplit * p.captions >= 5
        with pytest.raises(ValueError, match="T <= 64"):
            ds.plan_dr(16, 65, 8, 2, 4, 132)
    else:
        dp = -(-D // 16) * 16
        p = ds.plan_dr(256, 16, D, 256, 2048, 132)  # the LN sub-captions at this D
        union = max(2 * 2 * 256 * (ds.TCS_KC + 8), 4 * stage)
        smem = {m: 2 * m * (2 * (dp + 8) + 2 * 264) + union + 4 * (15 * m + 4) for m in (16, 32)}
        assert p == ((32 if smem[32] <= ds.SMEM_LIMIT else 16), 1, 2048, smem[p.rows])
        assert (p.rows == 32) == (D <= 768) and p.smem <= ds.SMEM_LIMIT
        assert ds.plan_dr(256, 16, D, 32, 128, 132)[1:3] == (4, 32)
        # ragged R: the union is the staging tiles where the region buffers are smaller
        q = ds.plan_dr(16, 7, D, 132, 7, 132)
        assert q == (32, 1, 7, 2 * 32 * (2 * (dp + 8) + 2 * 24) + 4 * stage + 4 * (15 * 32 + 4))
        with pytest.raises(ValueError, match="T <= 32"):
            ds.plan_dr(256, 33, D, 2, 4, 132)
        with pytest.raises(ValueError, match="D <= 1024"):
            ds.plan_dr(16, 8, 1032, 2, 4, 132)


@pytest.mark.parametrize("D", [256, 264, 520, 768, 770, 1024])
def test_dw_plan_mirrors_the_source(D):
    """The bf16 d_words kernel's plan (``plan_dw``) as ``csrc/damsm_score.cu``
    computes its shared memory (``tcd_smem_bytes``), with the constants read
    from the source: the pass's words ``[rows, Dp + 8]`` bf16, one bf16
    tile ``[rows, max(Rp + 8, 72)]`` (a, a chunk of d_c, d_sim in turn),
    the two region chunk buffers ``[2, Rp, 72]``, d_w past the region
    chunks it holds in registers ``[rows, (nq - qreg) * 64 + 8]`` fp32 (qreg
    2 from D = 256 to 768, else 0) and 15 words a row.  Rows by D: 64 at
    D = 256, 32 at 520 and 768 (225,168 bytes at 768, where all of d_w in
    shared memory would not fit), 16 above.  The splits of the images: the
    passes counted as if every slot held a word fill the 132
    multiprocessors once, at most one split an image (the LN-like shape:
    one).  T above the rows, R > 256 and D > 1024 are refused."""
    assert (_source_constant("TCD_ROWS_256"), _source_constant("TCD_ROWS_768"),
            _source_constant("TCD_ROWS_1024")) == tuple(ds.TCD_ROWS.values()) == (64, 32, 16)
    assert _source_constant("TCD_QREG") == ds.TCD_QREG == 2
    dp = -(-D // 16) * 16
    nq = -(-dp // 64)
    rows = 64 if D <= 256 else 32 if D <= 768 else 16
    qreg = 2 if 256 < dp <= 768 else 0

    def smem(R, m, regs):
        rp = -(-R // 16) * 16
        return (2 * m * (dp + 8) + 2 * m * max(rp + 8, 72) + 2 * 2 * rp * 72
                + 4 * m * ((nq - regs) * 64 + 8) + 4 * (15 * m + 4))

    T = min(rows, 20)
    p = ds.plan_dw(256, T, D, 128, 128, 132)
    assert (p.rows, p.smem) == (rows, smem(256, rows, qreg)) and p.smem <= ds.SMEM_LIMIT
    assert ds.plan_dw(50, 7, D, 3, 5, 132).smem == smem(50, rows, qreg)
    if D == 768:
        assert p.smem == 225_168 and smem(256, 32, 0) == 241_552 > ds.SMEM_LIMIT
    passes = -(-128 * T // rows)
    assert (p.nsplit, p.captions) == (min(128, -(-132 // passes)), -(-128 // p.nsplit))
    assert ds.plan_dw(256, min(rows, 32), D, 256, 1024, 132)[1:3] == (1, 256)
    assert ds.plan_dw(50, 7, D, 3, 5, 132)[1:3] == (3, 1)
    with pytest.raises(ValueError, match=f"T <= {rows}"):
        ds.plan_dw(256, rows + 1, D, 2, 4, 132)
    with pytest.raises(ValueError, match="R <= 256"):
        ds.plan_dw(257, 8, D, 2, 4, 132)
    with pytest.raises(ValueError, match="D <= 1024"):
        ds.plan_dw(256, 8, 1025, 2, 4, 132)


def test_ln_bf16_d_words_at_the_tensor_core_width_match_jax():
    """The bf16 d_words at the LN word shape's new width (T = 200, D = 768:
    sub-captions of 32 slots in bf16, the tensor-core kernels' rows a pass;
    16 in fp32): the plain version, which the card holds the kernel to, on
    the 32-slot sub-captions through ``damsm_scores`` against JAX
    ``damsm_scores``' word cotangent on the whole captions, the XLA path and
    the Pallas kernel in interpret mode (the all-padded caption's cotangent
    zeroed for Pallas, whose backward gives it one), under ``TOL``; the
    all-padded caption gets exactly 0."""
    b, bc, R, T, D = 2, 3, 256, 200, 768
    width = ds.sub_caption_width(R, T, D, torch.bfloat16)
    assert width == 32 and ds.sub_caption_width(R, T, D, None) == 16
    regions, words, mask, g = _long_problem(b, bc, R, T, D, width, seed=5)
    _, (_, dw) = _port(regions, words, mask, g, torch.bfloat16)
    _, (_, xw) = _jax(regions, words, mask, g, torch.bfloat16, pallas=False)
    g0 = g.copy()
    g0[:, 1] = 0.0
    _, (_, pw) = _jax(regions, words, mask, g0, torch.bfloat16, pallas=True)
    assert np.abs(dw[1]).max() == 0.0
    _close(dw, xw, TOL[torch.bfloat16], "d_words vs XLA")
    _close(dw[[0, 2]], pw[[0, 2]], TOL[torch.bfloat16], "d_words vs Pallas, captions with words")


@pytest.mark.parametrize("R,D", [(256, 256), (50, 40), (24, 24)])
def test_fp32_d_regions_plan_mirrors_the_source(R, D):
    """The fp32 d_regions kernel's plan (``PACKED_FP32``) as
    ``csrc/damsm_score.cu`` computes its shared memory, with the constants
    read from the source: words, d_c and a ``[rows, 260]`` fp32, two chunk
    buffers of a column chunk ``[256, 36]`` (a row chunk ``[32, 260]``
    fits one; d_sim ``[rows, 260]`` takes their place) and 11 words a row,
    the same at every R and D (the tiles are 256 wide).  At the flagship
    shape (B = Bc = 128, T = 20, 132 multiprocessors) 48 rows a pass in one
    split of all 128 captions (225,616 bytes: no partial buffer); fewer
    images get caption splits to fill the card; 56 rows would not fit;
    T > 48, R > 256 and D > 1024 are refused; above D = 256 the wide
    kernel's plan takes over."""
    assert (_source_constant("F32_MAX_RD"), _source_constant("F32_S"), _source_constant("F32_SC"),
            _source_constant("F32_KC"), _source_constant("F32_ROWS")) == (
        ds.F32_MAX_RD, ds.F32_S, ds.F32_SC, ds.F32_KC, ds.F32_ROWS[0])
    assert (ds.F32_MAX_RD, ds.F32_S, ds.F32_SC, ds.F32_KC, ds.F32_ROWS) == (256, 260, 36, 32, (48,))

    def smem(rows):
        return 4 * (3 * rows * 260 + 2 * 256 * 36 + 11 * rows + 4)

    assert 2 * 256 * 36 >= max(32 * 260, 48 * 260)  # a row chunk; d_sim at 48 rows
    p = ds.plan_dr_f32(R, 20, D, 128, 128, 132)
    assert p == (48, 1, 128, smem(48)) and p.smem <= ds.SMEM_LIMIT
    if (R, D) == (256, 256):
        assert p.smem == 225_616
    assert smem(48) <= ds.SMEM_LIMIT < smem(56)
    assert ds.plan_dr_f32(R, 20, D, 32, 128, 132)[1:3] == (4, 32)
    for b, bc, T in [(132, 7, 7), (132, 2, 33), (5, 3, 48), (3, 5, 1)]:
        q = ds.plan_dr_f32(R, T, D, b, bc, 132)
        assert q.rows >= T and q.nsplit * q.captions >= bc
    with pytest.raises(ValueError, match="T <= 48"):
        ds.plan_dr_f32(R, 49, D, 2, 4, 132)
    with pytest.raises(ValueError, match="R <= 256"):
        ds.plan_dr_f32(257, 8, D, 2, 4, 132)
    with pytest.raises(ValueError, match="D <= 1024"):
        ds.plan_dr_f32(R, 8, 1025, 2, 4, 132)
    assert ds.plan_dr_f32(R, 8, 264, 2, 4, 132).smem == ds._f32w_smem(264, 32)


@pytest.mark.parametrize("R,D", [(256, 256), (50, 40), (24, 24)])
def test_fp32_forward_plan_mirrors_the_source(R, D):
    """The fp32 forward kernel's plan (``PACKED_FP32``) as
    ``csrc/damsm_score.cu`` computes its shared memory, with the rows a pass
    read from the source: the fp32 d_regions' carve without its d_c tile,
    words and a ``[rows, 260]`` fp32, the two chunk buffers ``[256, 36]``
    and 11 words a row, the same at every R and D.  At the flagship shape
    (B = Bc = 128, T = 20, 132 multiprocessors) 64 rows a pass in one split
    of all 128 captions (209,680 bytes);
    fewer images get caption splits to fill the card; each plan holds its
    caption; T > 64, R > 256 and D > 1024 are refused; above D = 256 the
    wide kernel's plan takes over."""
    assert (_source_constant("F32_FWD_ROWS"),) == ds.F32_FWD_ROWS == (64,)

    def smem(rows):
        return 4 * (2 * rows * 260 + 2 * 256 * 36 + 11 * rows + 4)

    assert smem(64) == 209_680
    assert smem(64) <= ds.SMEM_LIMIT
    # the kernel's rows of the carve (rel, drel, the 4 column warps' row
    # partials, 5 of the row map) beside its two tiles
    assert smem(64) == ds._f32_smem(64, True) - 4 * 64 * 260
    p = ds.plan_fwd_f32(R, 20, D, 128, 128, 132)
    assert p == (64, 1, 128, smem(64))
    assert ds.plan_fwd_f32(R, 20, D, 32, 128, 132)[1:3] == (4, 32)
    for b, bc, T in [(132, 7, 7), (132, 2, 33), (5, 3, 48), (3, 5, 1), (132, 5, 64)]:
        q = ds.plan_fwd_f32(R, T, D, b, bc, 132)
        assert q.rows >= T and q.nsplit * q.captions >= bc
    with pytest.raises(ValueError, match="T <= 64"):
        ds.plan_fwd_f32(R, 65, D, 2, 4, 132)
    with pytest.raises(ValueError, match="R <= 256"):
        ds.plan_fwd_f32(257, 8, D, 2, 4, 132)
    with pytest.raises(ValueError, match="D <= 1024"):
        ds.plan_fwd_f32(R, 8, 1025, 2, 4, 132)
    assert ds.plan_fwd_f32(R, 8, 264, 2, 4, 132).smem == ds._f32w_smem(264, 32)


@pytest.mark.parametrize("R", [16, 50, 256, 257, 300])
@pytest.mark.parametrize("D", [264, 520, 768, 770, 1024])
def test_wide_fp32_route_rule(D, R):
    """Above D = 256 ``route`` alone puts the fp32 forward and d_regions on
    the wide packed kernels at R <= 256 (``damsm_fwd_f32w_kernel``,
    ``damsm_bwd_dr_f32w_kernel``) and on the CUDA-core kernels at R > 256;
    the d_words stays on the CUDA cores; bf16 keeps its tensor-core
    kernels with the regions streamed."""
    for cd in (None, torch.float32):
        for which in ("fwd", "dr"):
            want = ds.PACKED_FP32 if R <= 256 else ds.CUDA_CORES
            assert ds.route(which, R, D, cd) == want, (which, cd)
            name = ds.kernel_name(which, R, D, cd)
            if want == ds.PACKED_FP32:
                assert name == {"fwd": "damsm_fwd_f32w_kernel<",
                                "dr": "damsm_bwd_dr_f32w_kernel<"}[which]
            else:
                assert name in ("damsm_fwd_kernel<", "damsm_bwd_dr_kernel<float")
        assert ds.route("dw", R, D, cd) == ds.CUDA_CORES
        assert ds.kernel_name("dw", R, D, cd) == "damsm_bwd_dw_kernel<"
    bf16 = ds.kernel_name("fwd", R, D, torch.bfloat16)
    assert bf16 == ("damsm_fwd_tcs_kernel<" if R <= 256 else "damsm_fwd_bf16_kernel<")


@pytest.mark.parametrize("D", [264, 520, 768, 770, 1024])
def test_wide_fp32_plan_mirrors_the_source(D):
    """The wide fp32 forward's and d_regions' plan (256 < D <= 1024) as
    ``csrc/damsm_score.cu`` computes their shared memory, with the
    constants read from the source: the pass's words ``[rows, SW]`` (SW = D
    rounded up to whole 256-feature groups + 4, so rows lie 4 banks apart),
    a ``[rows, 260]``, the two chunk buffers ``[256, 36]`` (d_sim and a group
    of the words, ``[rows, 260]`` each, take their place in the d_regions)
    and 11 words a row, the same for both kernels.  32 rows a pass where
    they fit (to D = 768, 207,248 bytes at the LN shape), else 24; the LN
    word shape's 16-slot sub-captions in one split at 256 images; fewer
    images get splits; T > 32, R > 256 and D > 1024 are refused."""
    assert (_source_constant("F32W_MAX_D"), _source_constant("F32W_ROWS"),
            _source_constant("F32W_ROWS_MIN"), _source_constant("F32W_DG")) == (
        ds.F32W_MAX_D, *ds.F32W_ROWS, ds.F32W_DG)
    assert (ds.F32W_MAX_D, ds.F32W_ROWS, ds.F32W_DG) == (1024, (32, 24), 256)
    sw = -(-D // 256) * 256 + 4
    assert sw % 32 == 4

    def smem(rows):
        return 4 * (rows * (sw + 260) + 2 * 256 * 36 + 11 * rows + 4)

    assert 2 * 32 * 260 <= 2 * 256 * 36  # d_sim and a group of the words
    rows = 32 if smem(32) <= ds.SMEM_LIMIT else 24
    assert (rows == 32) == (D <= 768) and smem(24) <= ds.SMEM_LIMIT
    for plan in (ds.plan_fwd_f32, ds.plan_dr_f32):
        p = plan(256, 16, D, 256, 256 * 13, 132)
        assert p == (rows, 1, 256 * 13, smem(rows))
        assert p.smem == ds._f32w_smem(D, rows)
        if D == 768:
            assert p.smem == 207_248
        assert plan(256, 16, D, 32, 128, 132)[1:3] == (4, 32)
        for b, bc, R, T in [(132, 9, 50, 20), (132, 7, 64, 7), (132, 3, 256, 24), (3, 5, 7, 1)]:
            q = plan(R, T, D, b, bc, 132)
            assert q.rows >= T and q.nsplit * q.captions >= bc
        with pytest.raises(ValueError, match="T <= 32"):
            plan(256, 33, D, 2, 4, 132)
        with pytest.raises(ValueError, match="R <= 256"):
            plan(257, 8, D, 2, 4, 132)
    with pytest.raises(ValueError, match="D <= 1024"):
        ds.plan_fwd_f32(256, 8, 1025, 2, 4, 132)


@pytest.mark.parametrize("R,T,D", [(256, 200, 768), (256, 200, 1024), (50, 77, 520),
                                   (7, 200, 770), (256, 20, 264)])
def test_wide_fp32_sub_caption_width(R, T, D):
    """In fp32 above D = 256 the sub-caption width is the least of T, the
    CUDA-core backward's rows (the d_words) and the wide kernels' rows a
    pass, and both wide plans hold it: 16 at the LN word shape, as before
    (the d_words' rows set it), 9 at D = 1024."""
    width = ds.sub_caption_width(R, T, D, None)
    rows = ds.plan_fwd_f32(R, 1, D, 4, 4, 132).rows
    assert rows == ds.plan_dr_f32(R, 1, D, 4, 4, 132).rows
    assert width == min(T, ds.cuda_core_rows(R, D, backward=True), rows)
    assert ds.plan_fwd_f32(R, width, D, 4, 4, 132).rows >= width
    assert ds.plan_dr_f32(R, width, D, 4, 4, 132).rows >= width
    assert ds.plan(R, width, D, True, 4)[0] >= 1
    if (R, T, D) == (256, 200, 768):
        assert width == 16 == ds.cuda_core_rows(256, 768, backward=True)
    if D == 1024:
        assert width == 9


@pytest.mark.parametrize("D", [256, 264, 520, 768, 1024])
def test_forward_plan_mirrors_the_source(D):
    """The bf16 forward kernel's plan as ``csrc/damsm_score.cu`` computes its
    shared memory: it keeps no d_c, d_sim or staging tiles.  D = 256,
    regions resident: at the flagship shape (B = Bc = 128, R = 256, T = 20,
    132 multiprocessors) passes of 64 word rows fit beside the resident
    regions (d_regions: 32), in one split of all 128 captions; rows per pass
    are a multiple of 16 and hold a whole caption at the card tests' shapes;
    T > 64 is refused.  D > 256, regions streamed in 64-column chunks: words
    ``[rows, Dp + 8]`` and a ``[rows, Rp + 8]`` (bf16), the two region chunk
    buffers and 14 words a row; always 32 rows a pass (the kernel takes no
    other), so at the LN sub-captions (R = 256, T = 16, D = 768, B = 256,
    Bc = 2,048) 142,096 bytes; T > 32 is refused.  R > 256 and D > 1024 are
    refused at every D."""
    assert (_source_constant("TCS_KC"), _source_constant("TCS_MAX_D"),
            _source_constant("TCS_FWD_ROWS")) == (ds.TCS_KC, ds.TCS_MAX_D, 32)
    assert ds.TCS_FWD_ROWS == (32,)
    with pytest.raises(ValueError, match="R <= 256"):
        ds.plan_fwd(300, 8, D, 2, 4, 132)
    with pytest.raises(ValueError, match="D <= 1024"):
        ds.plan_fwd(16, 8, 1032, 2, 4, 132)
    if D == 256:
        p = ds.plan_fwd(256, 20, 256, 128, 128, 132)
        assert p == (64, 1, 128, 206_352)
        assert p.smem == 2 * (256 * 264 + 64 * 2 * 264) + 4 * (14 * 64 + 4) <= ds.SMEM_LIMIT
        assert ds.plan_fwd(256, 20, 256, 32, 128, 132)[1:3] == (4, 32)
        for b, bc, R, T, d in [(3, 5, 50, 7, 48), (2, 3, 5, 3, 12), (4, 7, 256, 20, 256),
                               (132, 7, 64, 7, 40), (132, 9, 50, 20, 40), (132, 2, 24, 33, 24),
                               (132, 3, 50, 64, 40), (132, 40, 256, 20, 256)]:
            p = ds.plan_fwd(R, T, d, b, bc, 132)
            assert p.rows % 16 == 0 and p.rows >= T and p.smem <= ds.SMEM_LIMIT
            assert p.nsplit * p.captions >= bc
        with pytest.raises(ValueError, match="T <= 64"):
            ds.plan_fwd(16, 65, 8, 2, 4, 132)
    else:
        dp = -(-D // 16) * 16
        regions = 2 * 2 * 256 * (ds.TCS_KC + 8)
        p = ds.plan_fwd(256, 16, D, 256, 2048, 132)  # the LN sub-captions at this D
        assert p == (32, 1, 2048, 2 * 32 * ((dp + 8) + 264) + regions + 4 * (14 * 32 + 4))
        assert p.smem <= ds.SMEM_LIMIT
        if D == 768:
            assert p == (32, 1, 2048, 142_096)
            assert (49_664, 16_896, 73_728, 1_808) == (2 * 32 * 776, 2 * 32 * 264, regions,
                                                       4 * (14 * 32 + 4))
        assert ds.plan_fwd(256, 16, D, 32, 128, 132)[1:3] == (4, 32)
        # ragged R: smaller region buffers
        assert ds.plan_fwd(50, 7, D, 132, 9, 132) == (
            32, 1, 9, 2 * 32 * ((dp + 8) + 72) + 2 * 2 * 64 * (ds.TCS_KC + 8) + 4 * (14 * 32 + 4))
        with pytest.raises(ValueError, match="T <= 32"):
            ds.plan_fwd(256, 33, D, 2, 4, 132)


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


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_d_regions_padded_columns_and_words_add_nothing(seed):
    """The streamed bf16 d_regions (D > 256) fills the feature columns past
    D with zeros (D = 520 is a multiple neither of its 16-column tiles nor
    of its 64-column region chunks) and packs only the real words.  Both
    are exact in the plain version, the kernel's reference: zero columns
    appended to regions and words get exactly 0 of d_regions and leave the
    real columns within the summation order (1e-6 of the largest fp32,
    ``TOL`` bf16), and a padded word's values do not reach d_regions."""
    regions, words, mask, g = _problem(b=2, bc=3, r=50, t=7, d=520, seed=seed)
    r = pl.l2_normalize(torch.from_numpy(regions))
    w = pl.l2_normalize(torch.from_numpy(words))
    m = torch.from_numpy(mask)
    gt = torch.from_numpy(g)
    other = pl.l2_normalize(torch.from_numpy(
        np.random.RandomState(seed + 10).randn(*words.shape).astype(np.float32)))
    w2 = torch.where(m[..., None], other, w)
    assert not torch.equal(w, w2)
    pad = 576 - 520  # to the ninth region chunk's end
    rp, wp = torch.nn.functional.pad(r, (0, pad)), torch.nn.functional.pad(w, (0, pad))
    for cd in (None, torch.bfloat16):
        want = ds._plain_vjp("dr", r, w, m, gt, 4.0, 5.0, cd)
        got = ds._plain_vjp("dr", rp, wp, m, gt, 4.0, 5.0, cd)
        assert got.shape == (2, 50, 576) and not got[..., 520:].any()
        scale = 1e-6 if cd is None else TOL[cd]
        _close(got[..., :520].numpy(), want.numpy(), scale, "padded columns")
        torch.testing.assert_close(ds._plain_vjp("dr", r, w2, m, gt, 4.0, 5.0, cd), want,
                                   rtol=0, atol=0)
