"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where there is no GPU:
a CUDA kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch and the CUDA
toolkit (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from xmc_gan_tpu_torch import losses
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa

BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)
# Kernel vs plain version.  fp32: the kernel contracts each g*y+b into one
# FMA, the plain version rounds the product first; with N(0, 1) inputs the
# chain's terms reach ~1e2, so one fp32 rounding (2^-24 relative) of them is
# up to ~1e-5 absolute.  bf16: the same fp32 values rounded once on store, so
# one bf16 ulp, plus that fp32 difference where the result is near zero.
TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (BF16_ULP, 2e-5)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256, 4, 4), (3, 32, 17, 9), (2, 13, 5, 7)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    """Both forms (1 and 2 modulations), the vector path (C a multiple of
    the 16-byte width) and the scalar one (C = 13)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, c, h, w = shape
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    mods = [torch.randn(b, c, generator=gen, device=cuda_device) for _ in range(4)]
    before = fa.FORWARD.launches
    got1 = fa.modulate_lrelu_kernel(x, *mods[:2])
    got2 = fa.double_modulate_lrelu_kernel(x, *mods)
    torch.cuda.synchronize()
    assert fa.FORWARD.launches == before + 2
    assert got2.is_contiguous(memory_format=torch.channels_last) and got2.dtype == dtype
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got1.float(), fa.modulate_lrelu_ref(x, *mods[:2]).float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(got2.float(), fa.double_modulate_lrelu_ref(x, *mods).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernel_takes_bf16_modulation_vectors(cuda_device):
    """The generator hands bf16 gamma/beta in bf16 runs: the wrapper casts
    them to fp32, as the Pallas kernel does."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 64, 8, 8, generator=gen, device=cuda_device).bfloat16().contiguous(
        memory_format=torch.channels_last)
    mods = [torch.randn(2, 64, generator=gen, device=cuda_device).bfloat16() for _ in range(4)]
    got = fa.double_modulate_lrelu_kernel(x, *mods)
    torch.testing.assert_close(got.float(), fa.double_modulate_lrelu_ref(x, *mods).float(),
                               rtol=TOL[torch.bfloat16][0], atol=TOL[torch.bfloat16][1])


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    x = torch.randn(2, 8, 4, 4, device=cuda_device).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="modulation vector on cpu"):
        fa.modulate_lrelu_kernel(x, torch.ones(2, 8), torch.zeros(2, 8))


@pytest.mark.cuda
def test_kernel_takes_misaligned_modulation_vectors(cuda_device):
    """A [B, C] vector that starts 4 bytes past a 16-byte boundary sends the
    launch down the scalar path; the result is the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(2, 32, 6, 6, generator=gen, device=cuda_device).contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(2 * 32 + 1, generator=gen, device=cuda_device)[1:].view(2, 32)
    b = torch.randn(2, 32, generator=gen, device=cuda_device)
    assert g.is_contiguous() and g.data_ptr() % 16 == 4
    torch.testing.assert_close(fa.modulate_lrelu_kernel(x, g, b), fa.modulate_lrelu_ref(x, g, b),
                               rtol=TOL[torch.float32][0], atol=TOL[torch.float32][1])


# fused_affine backward vs plain: dx is the plain version's arithmetic in the
# same order (fp32: up to FMA contraction of d1 * g1; bf16: one rounding on
# store); the [B, C] sums run over H*W in another order (threads, warps,
# blocks and atomics against PyTorch's tree), so they are held to 1e-4 of
# their largest magnitude with a 1e-4 relative part.
BWD_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (BF16_ULP, 2e-5)}
SUM_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nmod", [1, 2])
@pytest.mark.parametrize("shape", [(2, 256, 4, 4), (3, 32, 17, 9), (2, 13, 5, 7),
                                   (4, 64, 64, 64)])
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, nmod, shape):
    """The autograd Function's backward launches the backward kernel once and
    agrees with ``fused_affine_bwd_ref`` on dx and the vector gradients."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    mods = [torch.randn(b, c, generator=gen, device=cuda_device).requires_grad_()
            for _ in range(2 * nmod)]
    dy = torch.randn(shape, generator=gen, device=cuda_device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    fn = fa.modulate_lrelu_kernel if nmod == 1 else fa.double_modulate_lrelu_kernel
    before = fa.BACKWARD.launches
    got = torch.autograd.grad(fn(x, *mods), (x, *mods), dy)
    torch.cuda.synchronize()
    assert fa.BACKWARD.launches == before + 1
    want = fa.fused_affine_bwd_ref(x.detach(), tuple(m.detach() for m in mods), dy)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    rtol, atol = BWD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol, atol=atol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=SUM_TOL, atol=SUM_TOL * w.abs().max().item())


# damsm kernels vs plain.  fp32: the same math in another summation order.
# bf16: both round the products' operands to bf16, but a and the cotangents
# come from fp32 values computed in another order and can round to the
# neighbouring bf16 value; gradients are held to that (one ulp) of their
# largest magnitude.
DAMSM_TOL = {None: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -12, BF16_ULP)}


def _damsm_inputs(device, shape, seed, allpad):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, bc, r_, t, d = shape
    r = torch.nn.functional.normalize(torch.randn(b, r_, d, generator=gen, device=device), dim=-1)
    w = torch.nn.functional.normalize(torch.randn(bc, t, d, generator=gen, device=device), dim=-1)
    lens = torch.randint(1, t + 1, (bc,), generator=gen, device=device)
    mask = torch.arange(t, device=device)[None, :] >= lens[:, None]
    if allpad:
        mask[1] = True
    up = torch.randn(b, bc, generator=gen, device=device)
    return r, w, mask, up


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("shape,allpad", [((3, 5, 50, 7, 48), True), ((2, 3, 5, 3, 12), True),
                                          ((4, 7, 256, 20, 256), False)])
def test_damsm_kernels_match_plain_on_card(cuda_device, cd, shape, allpad):
    """Forward, d_regions and d_words (one launch each) against the plain
    version and its autograd; ragged R/T/D and an all-padded caption."""
    r, w, mask, up = _damsm_inputs(cuda_device, shape, 4, allpad)
    before = (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches)
    ri, wi = r.clone().requires_grad_(), w.clone().requires_grad_()
    out = ds.damsm_scores(ri, wi, mask, 4.0, 5.0, cd)
    dr, dw = torch.autograd.grad(out, (ri, wi), up)
    torch.cuda.synchronize()
    assert (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches) == tuple(
        n + 1 for n in before)
    rr, wr = r.clone().requires_grad_(), w.clone().requires_grad_()
    want = ds.damsm_scores_ref(rr, wr, mask, 4.0, 5.0, cd)
    dr_w, dw_w = torch.autograd.grad(want, (rr, wr), up)
    score_atol, grad_scale = DAMSM_TOL[cd]
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, want.detach(), rtol=1e-5, atol=score_atol)
    torch.testing.assert_close(dr, dr_w, rtol=0, atol=grad_scale * dr_w.abs().max().item())
    torch.testing.assert_close(dw, dw_w, rtol=0, atol=grad_scale * dw_w.abs().max().item())


@pytest.mark.cuda
def test_damsm_skips_d_words_when_words_carry_no_grad(cuda_device):
    """As in the train step: words are data, so only d_regions launches."""
    r, w, mask, up = _damsm_inputs(cuda_device, (3, 4, 16, 5, 8), 5, False)
    r.requires_grad_()
    before = (ds.D_REGIONS.launches, ds.D_WORDS.launches)
    torch.autograd.grad(ds.damsm_scores(r, w, mask), r, up)
    torch.cuda.synchronize()
    assert (ds.D_REGIONS.launches, ds.D_WORDS.launches) == (before[0] + 1, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_word_loss_kernel_backend_matches_plain_on_card(cuda_device, cd):
    """``losses.word_loss`` through the kernels and through the plain path,
    raw (unnormalized) bf16 regions as the train step hands them."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    regions = torch.randn(6, 40, 24, generator=gen, device=cuda_device).bfloat16()
    words = torch.randn(6, 9, 24, generator=gen, device=cuda_device)
    mask = torch.rand(6, 9, generator=gen, device=cuda_device) > 0.6
    mask[:, 0] = False
    labels = losses.make_labels(torch.randn(6, 24, generator=gen, device=cuda_device),
                                True, 0.0)
    vals, grads = [], []
    for backend in ("kernel", "plain"):
        r = regions.clone().requires_grad_()
        loss = losses.word_loss(r, words, mask, labels, True, 0.0, compute_dtype=cd,
                                backend=backend)
        vals.append(loss.detach())
        grads.append(torch.autograd.grad(loss, r)[0].float())
    score_atol, grad_scale = DAMSM_TOL[cd]
    torch.testing.assert_close(vals[0], vals[1], rtol=1e-5, atol=10 * score_atol)
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=(grad_scale + BF16_ULP) * grads[1].abs().max().item())
