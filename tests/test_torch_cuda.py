"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where there is no GPU:
a CUDA kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch and the CUDA
toolkit (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from xmc_gan_tpu_torch import losses
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.profiling import device_kernels

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
# store); the [B, C] sums run over H*W in another order (threads, blocks and
# atomics against PyTorch's tree), so they are held to 1e-4 of their largest
# magnitude with a 1e-4 relative part.  bf16 vectors get their gradients as
# those fp32 sums rounded once to bf16: half a bf16 ulp (2^-8) relative more.
BWD_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (BF16_ULP, 2e-5)}
SUM_TOL = 1e-4
# the epilogue's widths on both train steps: the flagship's C = 256, 32 and
# 64 (at 64², its largest grid per image), the LN-COCO step's 96 and 768;
# then C = 13 (the scalar kernel)
BWD_SHAPES = [(2, 256, 4, 4), (3, 32, 17, 9), (2, 13, 5, 7), (4, 64, 64, 64), (2, 96, 16, 16),
              (2, 768, 4, 4)]


def _bwd_inputs(device, shape, dtype, vec_dtype, nmod, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    mods = [torch.randn(b, c, generator=gen, device=device).to(vec_dtype)
            for _ in range(2 * nmod)]
    dy = torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return x, mods, dy


def _assert_bwd_close(got, want, dtype, vec_dtype):
    rtol, atol = BWD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol, atol=atol)
    extra = BF16_ULP / 2 if vec_dtype == torch.bfloat16 else 0.0
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.float(), w.float(), rtol=SUM_TOL + extra,
                                   atol=SUM_TOL * w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nmod", [1, 2])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, nmod, shape, vec_dtype):
    """The autograd Function's backward launches the backward kernel once and
    agrees with ``fused_affine_bwd_ref`` on dx and the vector gradients,
    which come back in the vectors' dtype (fp32 or bf16, as G's Affine MLPs
    hand them over)."""
    x, mods, dy = _bwd_inputs(cuda_device, shape, dtype, vec_dtype, nmod)
    x.requires_grad_()
    for m in mods:
        m.requires_grad_()
    fn = fa.modulate_lrelu_kernel if nmod == 1 else fa.double_modulate_lrelu_kernel
    before = fa.BACKWARD.launches
    got = torch.autograd.grad(fn(x, *mods), (x, *mods), dy)
    torch.cuda.synchronize()
    assert fa.BACKWARD.launches == before + 1
    want = fa.fused_affine_bwd_ref(x.detach(), tuple(m.detach().float() for m in mods), dy)
    assert got[0].dtype == dtype and all(g.dtype == vec_dtype for g in got[1:])
    _assert_bwd_close(got, want, dtype, vec_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_takes_a_misaligned_view_on_the_scalar_kernel(cuda_device, dtype):
    """x a channels_last view 2 (bf16) or 4 (fp32) bytes past a 16-byte
    boundary: the plan names the scalar kernel, and the result is the plain
    version's."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    base = torch.randn(2 * 6 * 6 * 64 + 1, generator=gen, device=cuda_device).to(dtype)
    x = base[1:].view(2, 6, 6, 64).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16 != 0
    _, mods, dy = _bwd_inputs(cuda_device, (2, 64, 6, 6), dtype, dtype, 2)
    dx = torch.empty_like(x)
    p = fa.plan_bwd(2, 36, 64, dtype, dtype, (x.data_ptr(), dy.data_ptr(), dx.data_ptr()),
                    _sms())
    assert p.kernel == fa.BWD_SCALAR
    got = fa._launch_bwd(x, tuple(mods), dy, 0.2)
    want = fa.fused_affine_bwd_ref(x, tuple(m.float() for m in mods), dy)
    _assert_bwd_close(got, want, dtype, dtype)


@pytest.mark.cuda
def test_backward_entry_refuses_what_the_named_kernel_does_not_take(cuda_device):
    """The C entry returns cudaErrorInvalidValue (1), and launches nothing,
    for the vector kernel at C = 13, at a misaligned x, with a block that is
    no whole number of pixels, and for a grid that misses pixels; the same
    call as planned succeeds."""
    b, c, h, w = 2, 64, 32, 32
    x, mods, dy = _bwd_inputs(cuda_device, (b, c, h, w), torch.float32, torch.float32, 2)
    dx = torch.empty_like(x)
    sums = torch.zeros(4, b, c, device=cuda_device)
    fn = fa.KERNEL.load().xmc_fused_affine_bwd
    stream = torch.cuda.current_stream().cuda_stream
    p = fa.plan_bwd(b, h * w, c, torch.float32, torch.float32,
                    (x.data_ptr(), dy.data_ptr(), dx.data_ptr()), _sms())
    assert p.kernel == fa.BWD_VEC and p.chunks > 1

    def entry(ptr=x.data_ptr(), chans=c, threads=p.threads, chunks=p.chunks):
        return fn(ptr, dy.data_ptr(), dx.data_ptr(), *[m.data_ptr() for m in mods],
                  sums.data_ptr(), b, h * w, chans, 2, 0, 0, 0.2, 0, threads, chunks, p.run,
                  stream)

    assert entry(chans=13) == 1
    assert entry(ptr=x.data_ptr() + 4) == 1
    assert entry(threads=p.threads - 1) == 1
    assert entry(chunks=p.chunks - 1) == 1
    torch.cuda.synchronize()
    assert bool((sums == 0).all())
    assert entry() == 0
    torch.cuda.synchronize()
    assert bool((sums != 0).any())


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _traced_backward_kernels() -> list:
    """For each of ``BWD_SHAPES`` in both dtypes, with vectors in x's dtype:
    the kernel and grid ``plan_bwd`` gives, and the ``fused_affine`` kernels
    and their grids in a whole trace of one call (``device_kernels``; the
    first call, before the trace, loads the library)."""
    device = torch.device("cuda")
    fa.KERNEL.load()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in BWD_SHAPES:
            x, mods, dy = _bwd_inputs(device, shape, dtype, dtype, 2)
            fa._launch_bwd(x, tuple(mods), dy, 0.2)
            torch.cuda.synchronize()
            seen = [k for k in device_kernels(lambda: fa._launch_bwd(x, tuple(mods), dy, 0.2),
                                              expect={r"fused_affine_bwd_": 1})[0]
                    if "fused_affine" in k["name"]]
            b, c, h, w = shape
            p = fa.plan_bwd(b, h * w, c, dtype, dtype, (0, 0, 0), _sms())  # torch aligns
            out.append((fa.bwd_kernel_name(p, dtype, dtype, 2), list(p.grid),
                        [k["name"] for k in seen], [k["grid"] for k in seen]))
    return out


@pytest.mark.cuda
def test_backward_launches_the_planned_kernel(cuda_device):
    """The profiler sees the backward kernel and grid that ``plan_bwd``
    gives, and no other ``fused_affine`` kernel: ``fused_affine_bwd_vec`` at the path
    widths, ``fused_affine_bwd_scalar`` at C = 13.  Traced in a fresh
    process: in this one, a library that first loads after earlier tests'
    traces and library loads can go unrecorded."""
    tests = Path(__file__).resolve().parent
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_cuda as t; "
            "print(json.dumps(t._traced_backward_kernels()))")
    proc = subprocess.run([sys.executable, "-c", code, str(tests.parent), str(tests)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {want.split("<")[0] for want, *_ in traced} == {fa.BWD_VEC, fa.BWD_SCALAR}
    for want, grid, names, grids in traced:
        assert len(names) == 1 and want in names[0] and grids == [grid], (want, grid, names,
                                                                         grids)


# damsm kernels vs plain, the scores against the plain version summed in
# fp64 around the same rounding points (``_exact_scores``).  fp32: the same
# math in another summation order.  bf16: both round the products' operands
# to bf16, but a and the cotangents come from sums in another order and can
# round to the neighbouring bf16 value; gradients are held to that (one ulp)
# of their largest magnitude.
DAMSM_TOL = {None: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -12, BF16_ULP)}


def _exact_scores(r, w, mask, cd):
    """The plain version's scores summed in fp64 (``ds.damsm_scores_ref``
    on fp64 operands), as fp32."""
    return ds.damsm_scores_ref(r.double(), w.double(), mask, 4.0, 5.0, cd).float()


def _damsm_inputs(device, shape, seed, allpad, max_len=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, bc, r_, t, d = shape
    r = torch.nn.functional.normalize(torch.randn(b, r_, d, generator=gen, device=device), dim=-1)
    w = torch.nn.functional.normalize(torch.randn(bc, t, d, generator=gen, device=device), dim=-1)
    lens = torch.randint(1, (max_len or t) + 1, (bc,), generator=gen, device=device)
    mask = torch.arange(t, device=device)[None, :] >= lens[:, None]
    if allpad:
        mask[1] = True
    up = torch.randn(b, bc, generator=gen, device=device)
    return r, w, mask, up


# (B, Bc, R, T, D), an all-padded caption, longest caption (None: T).  Beyond
# the ragged and flagship-width ones, the edges of the bf16 d_regions kernel
# (tensor-core tiles: 16 word rows x 8 regions x 16 features, passes of up to
# 64 packed word rows).  B = 132 images, no fewer than the card's
# multiprocessors, gives one split (``plan_dr``), so each block's passes pack
# runs of several captions: D = 40 (not a multiple of 16) with T = 7 and an
# all-padded caption inside a pass; R = 50 (not a multiple of 8) with T = 20,
# passes whose real word rows are no multiple of 16 and captions that cross
# a 16-row tile, Bc = 9 no multiple of the captions per pass; B != Bc
# throughout; T = 33 with Bc = 2; T = 64 with captions of at most 2 words,
# so that whole 16-row tiles of a pass hold no word.  Then the flagship's
# widths at 132 images of 40 captions: the bf16 forward's passes fill up to
# 64 rows (``plan_fwd``), so each image's captions run in several passes,
# with an all-padded caption.  Then the edges of the streamed bf16 forward
# and d_regions (D > 256: regions in 64-column chunks): D = 520 (a partial
# last chunk, no multiple of 16) with R = 50 and T = 20; D = 770 (rows not
# 16-byte aligned: plain loads, not cp.async) with an all-padded caption
# inside a pass; D = 1024 with captions of at most 2 words, through the
# sub-caption split.  Last, R = 300 (more regions than the tensor-core and
# packed fp32 kernels take), where the forward and d_regions run on the CUDA
# cores: at D = 48 and at D = 768 (their 256-column chunks, 15-slot
# sub-captions).
DAMSM_SHAPES = [((3, 5, 50, 7, 48), True, None), ((2, 3, 5, 3, 12), True, None),
                ((4, 7, 256, 20, 256), False, None), ((132, 7, 64, 7, 40), True, None),
                ((132, 9, 50, 20, 40), False, None), ((132, 2, 24, 33, 24), True, None),
                ((132, 3, 50, 64, 40), False, 2), ((132, 40, 256, 20, 256), True, None),
                ((132, 9, 50, 20, 520), False, None), ((132, 7, 64, 7, 770), True, None),
                ((132, 3, 256, 64, 1024), False, 2), ((4, 5, 300, 20, 48), True, None),
                ((4, 5, 300, 20, 768), True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("shape,allpad,max_len", DAMSM_SHAPES, ids=str)
def test_damsm_kernels_match_plain_on_card(cuda_device, cd, shape, allpad, max_len):
    """Forward, d_regions and d_words (one launch each) against the plain
    version and its autograd; ragged R/T/D, an all-padded caption, the bf16
    tensor-core kernels' tile edges and the bf16 CUDA-core kernels at
    R > 256; the profiler's kernel names show the route the rule picks."""
    r, w, mask, up = _damsm_inputs(cuda_device, shape, 4, allpad, max_len)
    before = (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches)
    ri, wi = r.clone().requires_grad_(), w.clone().requires_grad_()
    got = {}

    def run():
        got["s"] = ds.damsm_scores(ri, wi, mask, 4.0, 5.0, cd)
        got["g"] = torch.autograd.grad(got["s"], (ri, wi), up)

    names = _damsm_kernel_names(run)  # runs it twice: one launch of each kernel a run
    out, (dr, dw) = got["s"], got["g"]
    assert (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches) == tuple(
        n + 2 for n in before)
    for which in ("fwd", "dr", "dw"):
        want = ds.kernel_name(which, shape[2], shape[4], cd)
        assert any(want in n for n in names), (want, names)
    rr, wr = r.clone().requires_grad_(), w.clone().requires_grad_()
    want = ds.damsm_scores_ref(rr, wr, mask, 4.0, 5.0, cd)
    dr_w, dw_w = torch.autograd.grad(want, (rr, wr), up)
    score_atol, grad_scale = DAMSM_TOL[cd]
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, _exact_scores(r, w, mask, cd), rtol=1e-5, atol=score_atol)
    torch.testing.assert_close(dr, dr_w, rtol=0, atol=grad_scale * dr_w.abs().max().item())
    torch.testing.assert_close(dw, dw_w, rtol=0, atol=grad_scale * dw_w.abs().max().item())


def _ln_inputs(device, shape, seed):
    """LN-like inputs: about half the word slots real, padding scattered (as
    ``benchmarks/ln_word_loss.py`` draws it); caption 1 all padded, caption 2
    with its few real words in one sub-caption, the rest all padded."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, bc, r_, t, d = shape
    r = torch.nn.functional.normalize(torch.randn(b, r_, d, generator=gen, device=device), dim=-1)
    w = torch.nn.functional.normalize(torch.randn(bc, t, d, generator=gen, device=device), dim=-1)
    mask = torch.rand(bc, t, generator=gen, device=device) > 0.5
    mask[1] = True
    mask[2] = True
    mask[2, 1:5] = False
    up = torch.randn(b, bc, generator=gen, device=device)
    return r, w, mask, up


def _damsm_kernel_names(fn) -> set[str]:
    """The names of the damsm kernels that ``fn`` launches, from a whole
    trace of its second call (``device_kernels``): the first, before the
    trace, builds, loads and sets up every kernel it launches."""
    fn()
    torch.cuda.synchronize()
    return {k["name"] for k in device_kernels(fn)[0] if "damsm" in k["name"]}


# (shape, compute dtype, the forward's and d_regions' kernels): the LN
# config's word shape (T = 200, D = 768) on the wide packed kernels in fp32,
# and in bf16 the forward and d_regions on the tensor cores with the regions
# streamed; T = 130 at D = 256, whose bf16 sub-captions stay on the tensor
# cores with resident regions and whose fp32 forward and d_regions pack the
# words of its 48-slot sub-captions
LN_CASES = [((16, 16, 256, 200, 768), None,
             ("damsm_fwd_f32w_kernel<", "damsm_bwd_dr_f32w_kernel<")),
            ((16, 16, 256, 200, 768), torch.bfloat16,
             ("damsm_fwd_tcs_kernel<", "damsm_bwd_dr_tcs_kernel<")),
            ((16, 16, 256, 130, 256), torch.bfloat16,
             ("damsm_fwd_tc_kernel<", "damsm_bwd_dr_tc_kernel<")),
            ((16, 16, 256, 130, 256), None,
             ("damsm_fwd_f32_kernel<", "damsm_bwd_dr_f32_kernel<"))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cd,kernels", LN_CASES, ids=str)
def test_damsm_long_captions_match_plain_on_card(cuda_device, shape, cd, kernels):
    """Captions longer than a block's rows, as sub-captions: scores,
    d_regions and d_words (one launch each) against the plain version on
    the whole captions, under the same tolerances; the launches take the
    route the rule names for each kernel (``ds.route``); the
    all-padded caption scores exactly the plain value and gets no d_words."""
    b, bc, R, T, D = shape
    assert ds.sub_caption_width(R, T, D, cd) < T
    assert (ds.route("fwd", R, D, cd) == ds.TENSOR_CORES) == ("_tc" in kernels[0])
    assert (ds.route("dr", R, D, cd) == ds.TENSOR_CORES) == ("_tc" in kernels[1])
    r, w, mask, up = _ln_inputs(cuda_device, shape, 12)
    ri, wi = r.clone().requires_grad_(), w.clone().requires_grad_()
    before = (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches)
    out = {}

    def run():
        out["s"] = ds.damsm_scores(ri, wi, mask, 4.0, 5.0, cd)
        out["g"] = torch.autograd.grad(out["s"], (ri, wi), up)

    names = _damsm_kernel_names(run)  # runs it twice: one launch of each kernel a run
    assert (ds.FORWARD.launches, ds.D_REGIONS.launches, ds.D_WORDS.launches) == tuple(
        n + 2 for n in before)
    launched = kernels + (ds.kernel_name("dw", R, D, cd),)  # bf16: tensor cores, fp32: CUDA cores
    for want in launched:
        assert any(want in n for n in names), (want, names)
    assert not [n for n in names if "_tc" in n and not any(k in n for k in launched)], names
    if cd is not None:
        assert not [n for n in names if "damsm_fwd_bf16_kernel<" in n], names
    rr, wr = r.clone().requires_grad_(), w.clone().requires_grad_()
    want = ds.damsm_scores_ref(rr, wr, mask, 4.0, 5.0, cd)
    dr_w, dw_w = torch.autograd.grad(want, (rr, wr), up)
    score_atol, grad_scale = DAMSM_TOL[cd]
    s, (dr, dw) = out["s"], out["g"]
    assert bool(torch.isfinite(s).all())
    assert torch.equal(s[:, 1], want[:, 1].detach())
    assert dw[1].abs().max().item() == 0.0
    torch.testing.assert_close(s, _exact_scores(r, w, mask, cd), rtol=1e-5, atol=score_atol)
    torch.testing.assert_close(dr, dr_w, rtol=0, atol=grad_scale * dr_w.abs().max().item())
    torch.testing.assert_close(dw, dw_w, rtol=0, atol=grad_scale * dw_w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_damsm_cuda_core_d_regions_is_deterministic_at_d768(cuda_device, cd):
    """Two CUDA-core d_regions launches on D = 768 sub-captions (256-column
    chunks, split partial sums) are bit-equal: at R = 300, more regions
    than the packed and tensor-core kernels take, so ``route`` keeps them
    on the CUDA cores in both compute dtypes."""
    assert ds.route("dr", 300, 768, cd) == ds.CUDA_CORES
    r, w, mask, up = _ln_inputs(cuda_device, (8, 8, 300, 200, 768), 13)
    w_sub, m_sub = ds.split_captions(w, mask, ds.sub_caption_width(300, 200, 768, cd))
    g = up.repeat_interleave(w_sub.shape[0] // 8, dim=1)
    out = {}
    names = _damsm_kernel_names(lambda: out.update(
        first=ds._launch_bwd("dr", r, w_sub, m_sub, g, 4.0, 5.0, cd)))
    assert any(ds.kernel_name("dr", 300, 768, cd) in n for n in names), names
    again = ds._launch_bwd("dr", r, w_sub, m_sub, g, 4.0, 5.0, cd)
    torch.cuda.synchronize()
    assert torch.equal(out["first"], again)


@pytest.mark.cuda
def test_damsm_bf16_d_regions_is_deterministic_and_ignores_padded_captions(cuda_device):
    """Two launches of the bf16 (tensor-core) d_regions are bit-equal, and the
    all-padded caption's upstream cotangent changes nothing: it adds 0."""
    r, w, mask, up = _damsm_inputs(cuda_device, (8, 24, 256, 20, 256), 9, allpad=True)
    first = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16)
    again = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16)
    up2 = up.clone()
    up2[:, 1] = 100.0
    moved = ds._launch_bwd("dr", r, w, mask, up2, 4.0, 5.0, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, moved)
    want = ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16)
    torch.testing.assert_close(first, want, rtol=0,
                               atol=DAMSM_TOL[torch.bfloat16][1] * want.abs().max().item())


@pytest.mark.cuda
def test_damsm_streamed_d_regions_is_deterministic_and_ignores_padded_captions(cuda_device):
    """The same for the bf16 d_regions with streamed regions (D = 768, the
    LN width, 16-slot captions): two launches
    bit-equal, the all-padded caption's cotangent adds 0, and the result
    within one bf16 ulp of the largest gradient of the plain version."""
    r, w, mask, up = _damsm_inputs(cuda_device, (8, 24, 256, 16, 768), 14, allpad=True)
    names = _damsm_kernel_names(
        lambda: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16))
    assert any("damsm_bwd_dr_tcs_kernel<" in n for n in names), names
    first = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16)
    again = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16)
    up2 = up.clone()
    up2[:, 1] = 100.0
    moved = ds._launch_bwd("dr", r, w, mask, up2, 4.0, 5.0, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, moved)
    want = ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16)
    torch.testing.assert_close(first, want, rtol=0,
                               atol=DAMSM_TOL[torch.bfloat16][1] * want.abs().max().item())


# (B, Bc, R, T, D), an all-padded caption, longest caption (None: T): the
# bf16 d_words on the tensor cores (``plan_dw``: 64 word rows a pass at
# D <= 256, 32 to D = 768, 16 above; the regions streamed at every D) at the
# flagship word shape; at the LN word shape's 32-slot sub-captions (16
# images, LN-drawn mask: ``ln``); at the streamed kernels' edges: D = 264
# (5 of the 12 chunks the 32-row kernel holds, 3 of them in shared memory),
# D = 520 with R = 50 (a partial last region chunk, d_w's first two chunks in
# registers), D = 770 (rows not 16-byte aligned: plain loads), D = 1024 with
# captions of at most 2 words (16-row passes of many captions); and R = 50,
# D = 48 (one region chunk, 64-row passes)
DW_TC_SHAPES = [((128, 128, 256, 20, 256), True, None, False),
                ((16, 16, 256, 200, 768), True, None, True),
                ((16, 12, 256, 20, 264), True, None, False),
                ((132, 9, 50, 20, 520), True, None, False),
                ((132, 7, 64, 7, 770), True, None, False),
                ((132, 3, 256, 64, 1024), True, 2, False),
                ((3, 5, 50, 7, 48), True, None, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,allpad,max_len,ln", DW_TC_SHAPES, ids=str)
def test_damsm_tensor_core_d_words_matches_plain_on_card(cuda_device, shape, allpad, max_len,
                                                         ln):
    """The bf16 d_words kernel (``damsm_bwd_dw_tcs_kernel``) on the
    sub-captions ``damsm_scores`` hands it, with each sub-caption's
    caption cotangent, against the plain version's autograd on the same
    inputs within one bf16 ulp of the largest gradient; the all-padded
    caption's d_words and every padded slot's exactly 0; two launches
    bit-equal; the profiler shows the kernel ``kernel_name`` names."""
    b, bc, R, T, D = shape
    assert ds.route("dw", R, D, torch.bfloat16) == ds.TENSOR_CORES
    if ln:
        r, w, mask, up = _ln_inputs(cuda_device, shape, 17)
    else:
        r, w, mask, up = _damsm_inputs(cuda_device, shape, 17, allpad, max_len)
    w_sub, m_sub = ds.split_captions(w, mask, ds.sub_caption_width(R, T, D, torch.bfloat16))
    k = w_sub.shape[0] // bc
    g = up.repeat_interleave(k, dim=1)
    out = {}
    before = ds.D_WORDS.launches
    names = _damsm_kernel_names(lambda: out.update(
        first=ds._launch_bwd("dw", r, w_sub, m_sub, g, 4.0, 5.0, torch.bfloat16)))
    again = ds._launch_bwd("dw", r, w_sub, m_sub, g, 4.0, 5.0, torch.bfloat16)
    torch.cuda.synchronize()
    assert ds.D_WORDS.launches == before + 3
    assert any(ds.kernel_name("dw", R, D, torch.bfloat16) in n for n in names), names
    assert "damsm_bwd_dw_tcs_kernel<" == ds.kernel_name("dw", R, D, torch.bfloat16)
    got = out["first"]
    assert torch.equal(got, again)
    assert got.view(bc, k, *got.shape[1:])[1].abs().max().item() == 0.0
    assert got[m_sub].abs().max().item() == 0.0
    want = ds._plain_vjp("dw", r, w_sub, m_sub, g, 4.0, 5.0, torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=DAMSM_TOL[torch.bfloat16][1] * want.abs().max().item())


# the fp32 d_regions with packed words: D = 42 (no multiple of 4: plain
# loads, scalar d_r stores) and 40, R = 50, T = 33 (some passes of one
# caption), T = 48 (a pass of one caption), B != Bc, an all-padded
# caption
F32_DR_SHAPES = [((132, 6, 40, 11, 42), True), ((132, 9, 50, 33, 40), True),
                 ((8, 24, 256, 20, 256), True), ((5, 3, 256, 48, 256), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,allpad", F32_DR_SHAPES, ids=str)
def test_damsm_fp32_d_regions_is_deterministic_and_ignores_padded_captions(cuda_device, shape,
                                                                          allpad):
    """The fp32 d_regions with packed real words and streamed regions
    (``route`` PACKED_FP32): the launch is its kernel, two launches are
    bit-equal, the all-padded caption's cotangent adds 0, and the result is
    within ``DAMSM_TOL`` of the plain version."""
    r, w, mask, up = _damsm_inputs(cuda_device, shape, 17, allpad)
    b, bc, R, T, D = shape
    assert ds.route("dr", R, D, None) == ds.PACKED_FP32
    names = _damsm_kernel_names(lambda: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, None))
    assert any("damsm_bwd_dr_f32_kernel<" in n for n in names), names
    want = ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, None)
    up2 = up.clone()
    up2[:, 1] = 100.0
    first = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, None)
    again = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, None)
    moved = ds._launch_bwd("dr", r, w, mask, up2, 4.0, 5.0, None)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first, moved) == allpad
    torch.testing.assert_close(first, want, rtol=0,
                               atol=DAMSM_TOL[None][1] * want.abs().max().item())


# the wide fp32 forward and d_regions (256 < D <= 1024): (shape, LN-drawn
# mask, longest caption): the LN word shape at batch 32 (about half the
# slots real, scattered, caption 2 one sub-caption of 4 words), then the
# edges: D = 520 (a partial last chunk and group) at R = 50, D = 770 (rows
# not 16-byte aligned: plain loads; 24 rows a pass), D = 1024 (24 rows a
# pass, 9-slot sub-captions) with captions of at most 2 words, and 16-slot
# captions at D = 768 with Bc = 24; caption 1 all padded in each
F32W_SHAPES = [((32, 32, 256, 200, 768), True, None), ((132, 9, 50, 20, 520), False, None),
               ((132, 7, 64, 7, 770), False, None), ((132, 3, 256, 64, 1024), False, 2),
               ((8, 24, 256, 16, 768), False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ln,max_len", F32W_SHAPES, ids=str)
def test_damsm_wide_fp32_matches_plain_and_is_deterministic(cuda_device, shape, ln, max_len):
    """The wide fp32 forward and d_regions through ``damsm_scores``: the
    launches are the wide kernels (``route`` PACKED_FP32), the scores lie
    within ``DAMSM_TOL`` of the plain version summed in fp64 and d_regions
    within it of the plain version's autograd, two runs are bit-equal, the
    all-padded caption scores exactly the plain value, and its cotangent
    (100 in the second run) moves no d_regions."""
    b, bc, R, T, D = shape
    assert ds.route("fwd", R, D, None) == ds.route("dr", R, D, None) == ds.PACKED_FP32
    if ln:
        r, w, mask, up = _ln_inputs(cuda_device, shape, 19)
    else:
        r, w, mask, up = _damsm_inputs(cuda_device, shape, 19, True, max_len)
    up2 = up.clone()
    up2[:, 1] = 100.0
    out = {}

    def run(u):
        ri = r.clone().requires_grad_()
        s = ds.damsm_scores(ri, w, mask, 4.0, 5.0, None)
        return s, torch.autograd.grad(s, ri, u)[0]

    names = _damsm_kernel_names(lambda: out.update(first=run(up)))
    assert any("damsm_fwd_f32w_kernel<" in n for n in names), names
    assert any("damsm_bwd_dr_f32w_kernel<" in n for n in names), names
    s, dr = out["first"]
    s2, dr2 = run(up2)
    want_dr = ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, None)
    plain_pad = ds.damsm_scores_ref(r, w[1:2], mask[1:2], 4.0, 5.0, None)
    torch.cuda.synchronize()
    assert torch.equal(s, s2) and torch.equal(dr, dr2)
    assert bool(torch.isfinite(s).all())
    assert torch.equal(s[:, 1:2], plain_pad)
    torch.testing.assert_close(s, _exact_scores(r, w, mask, None), rtol=1e-5,
                               atol=DAMSM_TOL[None][0])
    torch.testing.assert_close(dr, want_dr, rtol=0,
                               atol=DAMSM_TOL[None][1] * want_dr.abs().max().item())


@pytest.mark.cuda
def test_damsm_bf16_forward_is_deterministic_and_scores_padded_captions(cuda_device):
    """Two launches of the bf16 (tensor-core) forward are bit-equal, every
    score is finite, and the all-padded caption, which takes no row of any
    pass, scores exactly what the plain version gives it, (-1e30 + log T) /
    gamma2."""
    r, w, mask, _ = _damsm_inputs(cuda_device, (8, 24, 256, 20, 256), 11, allpad=True)
    first = ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16)
    again = ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16)
    want = ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert bool(torch.isfinite(first).all())
    assert torch.equal(first[:, 1], want[:, 1])
    torch.testing.assert_close(first, _exact_scores(r, w, mask, torch.bfloat16), rtol=1e-5,
                               atol=DAMSM_TOL[torch.bfloat16][0])


# the fp32 forward with packed words: the fp32 d_regions' shapes, and T = 64
# (captions of up to 64 real words: passes of one caption, up to 64 rows)
F32_FWD_SHAPES = F32_DR_SHAPES + [((5, 3, 256, 64, 256), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,allpad", F32_FWD_SHAPES, ids=str)
def test_damsm_fp32_forward_is_deterministic_and_scores_padded_captions(cuda_device, shape,
                                                                       allpad):
    """The fp32 forward with packed real words and streamed regions
    (``route`` PACKED_FP32): the launch is its kernel, two launches are
    bit-equal, every score is finite, an all-padded caption (it takes no
    row of any pass) scores exactly the plain version's (-1e30 + log T) /
    gamma2, and the scores are within ``DAMSM_TOL`` of the plain version
    summed in fp64."""
    r, w, mask, _ = _damsm_inputs(cuda_device, shape, 18, allpad)
    b, bc, R, T, D = shape
    assert ds.route("fwd", R, D, None) == ds.PACKED_FP32
    names = _damsm_kernel_names(lambda: ds._launch_fwd(r, w, mask, 4.0, 5.0, None))
    assert any("damsm_fwd_f32_kernel<" in n for n in names), names
    first = ds._launch_fwd(r, w, mask, 4.0, 5.0, None)
    again = ds._launch_fwd(r, w, mask, 4.0, 5.0, None)
    want = ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, None)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert bool(torch.isfinite(first).all())
    if allpad:
        assert torch.equal(first[:, 1], want[:, 1])
    torch.testing.assert_close(first, _exact_scores(r, w, mask, None), rtol=1e-5,
                               atol=DAMSM_TOL[None][0])


@pytest.mark.cuda
def test_damsm_streamed_forward_is_deterministic_and_scores_padded_captions(cuda_device):
    """The bf16 forward with streamed regions (D = 768, the LN width, 16-slot
    captions as the LN sub-captions): the launch is the streamed kernel,
    two launches are bit-equal, the all-padded caption scores exactly the
    plain version's (-1e30 + log T) / gamma2, and the scores are within
    ``DAMSM_TOL`` of the plain version."""
    r, w, mask, _ = _damsm_inputs(cuda_device, (8, 24, 256, 16, 768), 16, allpad=True)
    names = _damsm_kernel_names(lambda: ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16))
    assert any("damsm_fwd_tcs_kernel<" in n for n in names), names
    first = ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16)
    again = ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16)
    want = ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert bool(torch.isfinite(first).all())
    assert torch.equal(first[:, 1], want[:, 1])
    torch.testing.assert_close(first, _exact_scores(r, w, mask, torch.bfloat16), rtol=1e-5,
                               atol=DAMSM_TOL[torch.bfloat16][0])


@pytest.mark.cuda
def test_damsm_phase_counters_count_and_change_nothing(cuda_device):
    """The build with the phase counters (``xmc_gan_tpu_torch/damsm_phases.py``)
    counts every phase of the bf16 tensor-core d_regions and forward
    (regions resident, and streamed at D = 768) and of the fp32 d_regions
    and forward with packed words (at D = 256, and the wide ones at
    D = 768), and the passes, and nothing outside each kernel's phases, and
    gives the same d_regions and scores bit for bit."""
    from xmc_gan_tpu_torch import damsm_phases

    r, w, mask, up = _damsm_inputs(cuda_device, (4, 24, 256, 20, 256), 10, allpad=True)
    rs, ws, ms, us = _damsm_inputs(cuda_device, (4, 24, 256, 16, 768), 10, allpad=True)
    lib = damsm_phases.phase_library()
    for kernel, launch in (
            ("d_regions", lambda **kw: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0,
                                                      torch.bfloat16, **kw)),
            ("d_regions, streamed", lambda **kw: ds._launch_bwd("dr", rs, ws, ms, us, 4.0, 5.0,
                                                                torch.bfloat16, **kw)),
            ("forward", lambda **kw: ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16,
                                                    **kw)),
            ("forward, streamed", lambda **kw: ds._launch_fwd(rs, ws, ms, 4.0, 5.0,
                                                              torch.bfloat16, **kw)),
            ("d_regions, fp32", lambda **kw: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0,
                                                            None, **kw)),
            ("forward, fp32", lambda **kw: ds._launch_fwd(r, w, mask, 4.0, 5.0, None, **kw)),
            ("d_regions, fp32 wide", lambda **kw: ds._launch_bwd("dr", rs, ws, ms, us, 4.0, 5.0,
                                                                 None, **kw)),
            ("forward, fp32 wide", lambda **kw: ds._launch_fwd(rs, ws, ms, 4.0, 5.0, None,
                                                               **kw))):
        want = launch()
        assert lib.load().xmc_damsm_phases_reset() == 0
        got = launch(library=lib)
        torch.cuda.synchronize()
        cycles = damsm_phases.read_phases(lib)
        assert torch.equal(got, want), kernel
        assert cycles[damsm_phases.PASSES] > 0, kernel
        phases = damsm_phases.KERNEL_PHASES[kernel]
        assert all(cycles[k] > 0 for k in phases), (kernel, cycles)
        assert all(cycles[k] == 0 for k in damsm_phases.PHASES if k not in phases), (kernel, cycles)


# (B_local, B_global, R, T, D): the row blocks of a data-parallel rank, its
# images against every caption (B != Bc): the flagship step at 2 x 128 rows
# and a 4-of-8 block at the same word shape
ROW_BLOCKS = [(128, 256, 256, 20, 256), (4, 8, 256, 20, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("shape", ROW_BLOCKS, ids=str)
def test_damsm_row_block_matches_plain_on_card(cuda_device, cd, shape):
    """A data-parallel rank's word scores (``parallel.sharded_word_scores``):
    the forward and d_regions of the last ``B_local`` of ``B_global`` images
    against all ``B_global`` captions, the words without gradient as in the
    step, against the plain version and its autograd; the kernels the route
    names, no d_words; and bit-equal to the same rows of one launch on all
    ``B_global`` images (seen on an H100 80GB HBM3, 700 W, in both compute
    dtypes: a pair's score and its d_regions do not depend on the other
    images)."""
    b, bc, R, T, D = shape
    r, w, mask, up = _damsm_inputs(cuda_device, (bc, bc, R, T, D), 8, False)
    full = ds._launch_fwd(r, w, mask, 4.0, 5.0, cd)[bc - b:]
    full_dr = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, cd)[bc - b:]
    r, up = r[bc - b:].contiguous(), up[bc - b:].contiguous()
    ri, got = r.clone().requires_grad_(), {}

    def run():
        got["s"] = ds.damsm_scores(ri, w, mask, 4.0, 5.0, cd)
        got["dr"], = torch.autograd.grad(got["s"], ri, up)

    names = _damsm_kernel_names(run)
    for which in ("fwd", "dr"):
        want = ds.kernel_name(which, R, D, cd)
        assert any(want in n for n in names), (want, names)
    assert not any("damsm_bwd_dw" in n for n in names), names
    score_atol, grad_scale = DAMSM_TOL[cd]
    assert got["s"].shape == (b, bc)
    torch.testing.assert_close(got["s"], _exact_scores(r, w, mask, cd), rtol=1e-5,
                               atol=score_atol)
    want_dr = ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, cd)
    torch.testing.assert_close(got["dr"], want_dr, rtol=0,
                               atol=grad_scale * want_dr.abs().max().item())
    assert torch.equal(got["s"], full) and torch.equal(got["dr"], full_dr)


# (B_local, B_global, cols, R, T, D): the column blocks of a tensor-parallel
# rank, its B_local images against its ``cols`` of the B_global captions:
# the LN-COCO step at a global batch of 64 over tp = 2 ([64, 32], T = 200,
# D = 768) and 4 images against 4 of 8 captions at the flagship word shape
COL_BLOCKS = [(64, 64, 32, 256, 200, 768), (4, 8, 4, 256, 20, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("shape", COL_BLOCKS, ids=str)
def test_damsm_col_block_matches_plain_on_card(cuda_device, cd, shape):
    """A tensor-parallel rank's word scores (``parallel.sharded_word_scores``'
    column blocks): the forward and d_regions of the first ``B_local``
    images against the last ``cols`` captions, through ``damsm_scores``,
    the words without gradient as in the step, against the plain version
    and its autograd, on the kernels the route names (no d_words); and
    within the same tolerance of that block of one launch on the whole
    batch (``damsm_scores`` packs each batch's words to its own longest
    caption, so the sub-captions may differ)."""
    b, bc, cols, R, T, D = shape
    if T == 200:
        r, w, mask, up = _ln_inputs(cuda_device, (bc, bc, R, T, D), 23)
    else:
        r, w, mask, up = _damsm_inputs(cuda_device, (bc, bc, R, T, D), 8, False)
    full = ds.damsm_scores(r, w, mask, 4.0, 5.0, cd)[:b, bc - cols:]
    r, w, mask = r[:b].contiguous(), w[bc - cols:].contiguous(), mask[bc - cols:].contiguous()
    up = up[:b, bc - cols:].contiguous()
    ri, got = r.clone().requires_grad_(), {}

    def run():
        got["s"] = ds.damsm_scores(ri, w, mask, 4.0, 5.0, cd)
        got["dr"], = torch.autograd.grad(got["s"], ri, up)

    names = _damsm_kernel_names(run)
    for which in ("fwd", "dr"):
        want = ds.kernel_name(which, R, D, cd)
        assert any(want in n for n in names), (want, names)
    assert not any("damsm_bwd_dw" in n for n in names), names
    score_atol, grad_scale = DAMSM_TOL[cd]
    assert got["s"].shape == (b, cols)
    torch.testing.assert_close(got["s"], _exact_scores(r, w, mask, cd), rtol=1e-5,
                               atol=score_atol)
    torch.testing.assert_close(got["s"], full, rtol=1e-5, atol=score_atol)
    want_dr = ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, cd)
    torch.testing.assert_close(got["dr"], want_dr, rtol=0,
                               atol=grad_scale * want_dr.abs().max().item())


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


# cross_attention kernel vs plain.  fp32: the same math in another order (the
# kernel keeps scores in log2 units and rescales its running sums once per
# word tile); with N(0, 1) operands at D = 256 the scores reach ~1e2, and one
# fp32 rounding of them moves a softmax weight by ~1e-5 relative, so 1e-4
# absolute.  bf16: both compute in fp32 and round once on store, so one bf16
# ulp of the value where the two fp32 results straddle a rounding boundary.
ATTN_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (BF16_ULP, 1e-4)}
# (B, G, N, T, D, strided): the ten In-sampler launches of a 256², NCH=32
# request at batch 2, the Out launch at batch 128, the JAX package's kernel
# shapes, a D = 256 shape and a ragged one; then attn_grouped's edges
# (``ca.plan``): N no multiple of a tile, T at the cap, G = 8 and 32, the
# In sampler's operands as they come on the card ("planes": the queries
# [B, G, D, N] in memory, as a CUDA GroupNorm leaves them, the keys
# [B, G, D, T]) and its keys alone ("sampler"), blocks that walk more tiles
# than the slabs they hold (batch 8), and the shapes next to it that
# attn_small takes: T = 33, G = 12, dense queries, planes off 16 bytes
ATTN_SHAPES = [(2, 16, n, 15, 4, True) for n in (256, 1024, 4096, 16384, 65536)] + [
    (128, 1, 16, 15, 4, False), (2, 1, 64, 20, 32, False), (2, 1, 300, 260, 32, False),
    (4, 1, 1024, 200, 256, False), (3, 2, 77, 33, 48, True)]
GROUPED_SHAPES = ATTN_SHAPES[:5] + [
    (3, 16, 77, 15, 4, True), (3, 16, 80, 15, 4, "planes"), (2, 16, 300, 32, 4, "sampler"),
    (3, 8, 96, 20, 4, "planes"), (2, 32, 130, 15, 4, True), (2, 16, 4096, 15, 4, "planes"),
    (8, 16, 65536, 15, 4, "planes")]
ATTN_SHAPES += GROUPED_SHAPES[5:] + [
    (2, 16, 300, 33, 4, True), (2, 12, 50, 15, 4, True), (2, 16, 300, 15, 4, False),
    (2, 16, 77, 15, 4, "planes")]


def _attn_inputs(device, shape, seed, allpad):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, g, n, t, d, strided = shape
    if strided:  # the In sampler's layout: [B, N, G, D] in memory, viewed as [B, G, N, D]
        q = torch.randn(b, n, g, d, generator=gen, device=device).transpose(1, 2)
        k = torch.randn(b, t, g, d, generator=gen, device=device).transpose(1, 2)
        if strided in ("sampler", "planes"):  # [B, G, D, T] in memory: a d-stride of T
            k = k.permute(0, 1, 3, 2).contiguous().transpose(2, 3)
        if strided == "planes":  # [B, G, D, N] in memory: an n-stride of 1
            q = q.permute(0, 1, 3, 2).contiguous().transpose(2, 3)
        v = k
    else:
        q = torch.randn(b, g, n, d, generator=gen, device=device).squeeze(1)
        k, v = (torch.randn(b, g, t, d, generator=gen, device=device).squeeze(1)
                for _ in range(2))
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=device)
    mask = torch.arange(t, device=device)[None, :] >= lens[:, None]
    if allpad:
        mask[0] = True
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_cross_attention_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    """One launch per call; a fully padded first row gives 0 in both."""
    q, k, v, mask = _attn_inputs(cuda_device, shape, 7, allpad=True)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = ca.FORWARD.launches
    got = ca.masked_cross_attention_kernel(q, k, v, mask, 0.7)
    torch.cuda.synchronize()
    assert ca.FORWARD.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ca.masked_cross_attention_ref(q, k, v, mask, 0.7)
    assert bool((got[0] == 0).all()) and bool((want[0] == 0).all())
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cross_attention_refuses_grad_on_card(cuda_device):
    """Under grad, a shape the backward's plan does not take (D > 32, T >
    256) raises ValueError before any launch; under no_grad it runs."""
    for shape in ((2, 1, 8, 5, 48, False), (2, 1, 8, 257, 4, False)):
        q, k, v, mask = _attn_inputs(cuda_device, shape, 8, allpad=False)
        before = (ca.FORWARD.launches, ca.BACKWARD.launches)
        with pytest.raises(ValueError, match="backward takes"):
            ca.masked_cross_attention_kernel(q.requires_grad_(), k, v, mask)
        assert (ca.FORWARD.launches, ca.BACKWARD.launches) == before
        with torch.no_grad():
            ca.masked_cross_attention_kernel(q, k, v, mask)
        assert ca.FORWARD.launches == before[0] + 1


# kernel's backward vs its plain version: each gradient to rtol and to atol
# times its largest magnitude.  fp32: the same math in another order (exp2
# of log2-unit scores; dk and dv summed over the queries in tile order):
# (1e-4, 1e-5).  bf16: both round once on store from fp32, so one bf16 ulp
ATTN_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (BF16_ULP, 1e-5)}
# the 64² step's In shapes (batch cut to 4) as rows and as planes, its Out
# shape, and the plan's edges: a ragged T, D = 12 at T = 33, T = 200 and the
# widest plan (T = 256, D = 32) on attn_bwd; on attn_bwd_warp T = 1, 20 and
# 32 (TMAX 32: more than 32 P and dS rows), N = 1, N = 33 (a second warp
# with one query) and N = 77 as planes (a ragged vector of four queries), and
# D = 3 (every operand read a value at a time)
ATTN_BWD_SHAPES = [(4, 16, n, 15, 4, lay) for n in (256, 1024, 4096) for lay in (True, "planes")] + [
    (88, 1, 16, 15, 4, False), (3, 16, 77, 7, 4, "sampler"), (3, 1, 50, 33, 12, False),
    (2, 16, 300, 200, 4, "sampler"), (2, 1, 100, 256, 32, False),
    (5, 16, 77, 1, 4, "planes"), (4, 16, 300, 20, 4, True), (4, 16, 130, 32, 4, "sampler"),
    (4, 16, 1, 15, 4, False), (4, 16, 33, 15, 4, "planes"), (4, 16, 77, 15, 4, "planes"),
    (4, 2, 50, 15, 3, False)]


def _bwd_case(device, shape, dtype, seed):
    q, k, _, _ = _attn_inputs(device, shape, seed, allpad=False)
    q, k = q.to(dtype), k.to(dtype)
    mask = _padded_rows_mask(device, shape[0], shape[3])  # rows 0, 3, ... fully padded
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    return q, k, mask, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_BWD_SHAPES, ids=str)
def test_cross_attention_backward_matches_plain_on_card(cuda_device, dtype, shape):
    """The planned backward kernel against ``masked_cross_attention_bwd_ref``,
    k passed as v; fully padded rows (0, 3, ...) get zero gradients,
    one-word rows (1, 4, ...) exactly zero dq and dk; two launches give
    equal bits; dq has q's strides."""
    q, k, mask, dout = _bwd_case(cuda_device, shape, dtype, 13)
    _assert_bwd_matches_plain(q, k, mask, dout, dtype)


def _assert_bwd_matches_plain(q, k, mask, dout, dtype):
    before = ca.BACKWARD.launches
    got = ca._launch_bwd(q, k, k, mask, dout, 0.7)
    again = ca._launch_bwd(q, k, k, mask, dout, 0.7)
    want = ca.masked_cross_attention_bwd_ref(q, k, k, mask, dout, 0.7)
    torch.cuda.synchronize()
    assert ca.BACKWARD.launches == before + 2
    rtol, frac = ATTN_BWD_TOL[dtype]
    lens = (~mask).sum(dim=1)
    for name, a, b_, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == w.shape and torch.equal(a, b_), name
        torch.testing.assert_close(a.float(), w.float(), rtol=rtol,
                                   atol=frac * w.float().abs().max().item())
        for i in range(q.shape[0]):
            if lens[i] == 0 or (lens[i] == 1 and name != "dv"):
                assert bool((a[i] == 0).all()) and bool((w[i] == 0).all()), (name, i)
    assert got[0].stride() == q.stride()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(88, 1, 16, 15, 4, False), (4, 16, 1024, 15, 4, "planes"),
                                   (4, 16, 300, 20, 4, True)], ids=str)
def test_cross_attention_backward_large_norm_and_sliced_upstream(cuda_device, dtype, shape):
    """Queries of norm ~30 (scores up to ~30 x 0.7 |k|: the exact maximum
    matters) and dO a slice of a wider gradient, as the Out block's
    concatenation hands it over (rows at an n-stride of 360, offset 356)."""
    q, k, mask, _ = _bwd_case(cuda_device, shape, dtype, 17)
    q = (q.float() * 15.0).to(dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    wide = torch.randn((*q.shape[:-1], 360), generator=gen, device=cuda_device).to(dtype)
    dout = wide[..., 356:]
    assert not dout.is_contiguous()
    _assert_bwd_matches_plain(q, k, mask, dout, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_trains_through_the_backward_kernel(cuda_device, dtype):
    """Under grad the wrapper returns a differentiable output: one forward
    and one backward launch, q's gradient the kernel's dq and k's (passed as
    v) dk + dv, through the In sampler's mean over the queries."""
    q, k, mask, _ = _bwd_case(cuda_device, (4, 16, 1024, 15, 4, "planes"), dtype, 14)
    qg, kg = q.detach().requires_grad_(), k.detach().requires_grad_()
    before = (ca.FORWARD.launches, ca.BACKWARD.launches)
    out = ca.masked_cross_attention_kernel(qg, kg, kg, mask)
    seen = {}
    out.register_hook(lambda g: seen.__setitem__("dout", g))
    (out.mean(dim=2).float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (ca.FORWARD.launches, ca.BACKWARD.launches) == (before[0] + 1, before[1] + 1)
    dq, dk, dv = ca._launch_bwd(q, k, k, mask, seen["dout"], 1.0)
    assert torch.equal(qg.grad, dq) and torch.equal(kg.grad, dk + dv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 300, 15, 4, "planes"), (3, 16, 130, 32, 4, True),
                                   (88, 1, 16, 15, 4, False), (3, 2, 50, 15, 3, False)], ids=str)
def test_cross_attention_backward_with_values_apart_from_keys(cuda_device, dtype, shape):
    """Values that are not the keys (the samplers pass the keys as the
    values; ``attn_bwd_warp`` then reads a word once): the same checks as
    above, dk and dv each against the plain version."""
    q, k, mask, dout = _bwd_case(cuda_device, shape, dtype, 19)
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    v = torch.randn(k.shape, generator=gen, device=cuda_device).to(dtype)
    got = ca._launch_bwd(q, k, v, mask, dout, 0.7)
    again = ca._launch_bwd(q, k, v, mask, dout, 0.7)
    want = ca.masked_cross_attention_bwd_ref(q, k, v, mask, dout, 0.7)
    torch.cuda.synchronize()
    rtol, frac = ATTN_BWD_TOL[dtype]
    for a, b_, w in zip(got, again, want):
        assert torch.equal(a, b_)
        torch.testing.assert_close(a.float(), w.float(), rtol=rtol,
                                   atol=frac * w.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 300, 15, 4, "planes"), (3, 16, 77, 32, 4, True),
                                   (88, 1, 16, 15, 4, False), (3, 1, 50, 40, 4, False)], ids=str)
def test_cross_attention_backward_with_scattered_padding(cuda_device, dtype, shape):
    """Padded words anywhere in a caption, not only at its end: each row's
    real words are compacted in order (row 0 all padded, row 1 one real word
    in the middle, the rest every third word padded)."""
    q, k, _, dout = _bwd_case(cuda_device, shape, dtype, 21)
    b, t = shape[0], shape[3]
    words, rows = torch.arange(t, device=cuda_device), torch.arange(b, device=cuda_device)
    mask = (words[None, :] + rows[:, None]) % 3 == 0
    mask[0] = True
    mask[1] = True
    mask[1, t // 2] = False
    got = ca._launch_bwd(q, k, k, mask, dout, 0.7)
    want = ca.masked_cross_attention_bwd_ref(q, k, k, mask, dout, 0.7)
    torch.cuda.synchronize()
    rtol, frac = ATTN_BWD_TOL[dtype]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=rtol,
                                   atol=frac * w.float().abs().max().item())
        assert bool((a[0] == 0).all()), name
        if name != "dv":
            assert bool((a[1] == 0).all()), name


def _traced_attention_backward_kernels() -> list:
    """For each dtype and a shape of each template: the kernel ``plan_bwd``
    names and the backward kernels of a whole trace of one launch
    (``attn_bwd_warp`` at TMAX 16 and 32, ``attn_bwd`` at T = 33 and at each
    D bound past 4)."""
    device = torch.device("cuda")
    ca.KERNEL.load()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 16, 1024, 15, 4, "planes"), (2, 1, 16, 20, 4, False),
                      (2, 1, 64, 33, 4, False), (2, 1, 64, 20, 8, False),
                      (2, 1, 64, 20, 32, False)):
            q, k, mask, dout = _bwd_case(device, shape, dtype, 15)
            ca._launch_bwd(q, k, k, mask, dout, 1.0)
            torch.cuda.synchronize()
            seen = device_kernels(lambda: ca._launch_bwd(q, k, k, mask, dout, 1.0),
                                  expect={r"attn_bwd(_warp)?<": 1})[0]
            q4 = q if q.dim() == 4 else q.unsqueeze(1)
            p = ca.plan_bwd(*q4.shape[:3], shape[3], shape[4], dtype)
            out.append((ca.bwd_kernel_name(p, dtype),
                        sorted({x["name"] for x in seen if "attn_bwd" in x["name"]})))
    return out


@pytest.mark.cuda
def test_cross_attention_backward_launches_the_planned_kernel(cuda_device):
    """The profiler sees the kernel ``plan_bwd`` names (in a fresh process,
    as ``test_cross_attention_launches_the_planned_kernel``)."""
    tests = Path(__file__).resolve().parent
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_cuda as t; "
            "print(json.dumps(t._traced_attention_backward_kernels()))")
    proc = subprocess.run([sys.executable, "-c", code, str(tests.parent), str(tests)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [w.split("<")[0] for w, _ in got[:5]] == ["attn_bwd_warp"] * 2 + ["attn_bwd"] * 3
    for want, names in got:
        assert names and all(want in nm for nm in names), (want, names)


def _padded_rows_mask(device, b, t):
    """Rows 0, 3, 5, ... fully padded, rows 1, 4, ... one word, the rest half."""
    lens = torch.tensor([(0, 1, t // 2)[i % 3] for i in range(b)], device=device)
    return torch.arange(t, device=device)[None, :] >= lens[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GROUPED_SHAPES, ids=str)
def test_attn_grouped_padded_rows_and_equal_bits(cuda_device, dtype, shape):
    """attn_grouped at its shapes with fully padded rows in several b (0 in
    both) and one-word rows; two launches give equal bits."""
    b, g, n, t, d, _ = shape
    q, k, v, _ = _attn_inputs(cuda_device, shape, 9, allpad=False)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    mask = _padded_rows_mask(cuda_device, b, t)
    assert ca.plan_for(q, k).kernel == ca.GROUPED
    got = ca.masked_cross_attention_kernel(q, k, v, mask, 0.7)
    again = ca.masked_cross_attention_kernel(q, k, v, mask, 0.7)
    torch.cuda.synchronize()
    want = ca.masked_cross_attention_ref(q, k, v, mask, 0.7)
    for i in range(0, b, 3):
        assert bool((got[i] == 0).all()) and bool((want[i] == 0).all())
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(got, again)


def _traced_attention_kernels(dtype_name: str) -> list:
    """For each of an In shape with its queries as planes and as rows and
    the Out shape: the kernel ``plan`` names and the attention kernels in
    a whole trace of one call (``device_kernels``; the first call, before
    the trace, loads the library)."""
    dtype = getattr(torch, dtype_name)
    device = torch.device("cuda")
    ca.KERNEL.load()
    out = []
    for shape in ((2, 16, 1024, 15, 4, "planes"), (2, 16, 1024, 15, 4, "sampler"),
                  (128, 1, 16, 15, 4, False)):
        q, k, v, mask = (x.to(dtype) if x.is_floating_point() else x
                         for x in _attn_inputs(device, shape, 10, allpad=False))
        ca.masked_cross_attention_kernel(q, k, v, mask)
        torch.cuda.synchronize()
        seen = device_kernels(lambda: ca.masked_cross_attention_kernel(q, k, v, mask),
                              expect={r"attn_(small|wide|grouped)<": 1})[0]
        out.append((ca.kernel_name(ca.plan_for(q, k), dtype, shape[4]),
                    sorted({k["name"] for k in seen if "attn_" in k["name"]})))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_launches_the_planned_kernel(cuda_device, dtype):
    """The profiler sees the kernel that ``plan`` names, and no other
    attention kernel: attn_grouped at an In shape, its queries as planes and
    as rows, attn_small at the Out shape.  Traced in a fresh process: in
    this one, a library that first loads after earlier tests' traces and
    library loads can go unrecorded."""
    tests = Path(__file__).resolve().parent
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_cuda as t; "
            "print(json.dumps(t._traced_attention_kernels(sys.argv[3])))")
    proc = subprocess.run([sys.executable, "-c", code, str(tests.parent), str(tests), dtype],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for want, names in json.loads(proc.stdout.strip().splitlines()[-1]):
        assert names and all(want in nm for nm in names), (want, names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [True, "planes"])
def test_attn_grouped_takes_the_exact_max_where_the_bound_is_wide(cuda_device, dtype, layout):
    """Rows whose score bound |q| max|k| exceeds 32 (log2 units): the warp
    takes the exact maximum as the shift, beside rows that keep the bound;
    both within the tolerance, no row underflows to 0."""
    q, k, v, mask = _attn_inputs(cuda_device, (3, 16, 256, 15, 4, layout), 11, allpad=False)
    q.mul_(torch.where(torch.arange(256, device=cuda_device) % 64 < 32, 40.0, 1.0)[:, None])
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    assert ca.plan_for(q, k).kernel == ca.GROUPED
    got = ca.masked_cross_attention_kernel(q, k, v, mask, 0.7)
    want = ca.masked_cross_attention_ref(q, k, v, mask, 0.7)
    torch.cuda.synchronize()
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert bool((got.float().abs().sum(-1) > 0).all())


# the concept discriminator's four modulate_lrelu inputs at NCH 32, 64²
# (batch cut to 8)
BWD2_SHAPES = [(8, 128, 32, 32), (8, 128, 16, 16), (8, 128, 8, 8), (8, 128, 4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD2_SHAPES)
def test_double_backward_kernel_matches_plain_on_card(cuda_device, dtype, vec_dtype, shape):
    """The single form differentiated twice (``create_graph``, then the
    gradient of a weighted sum of dx, dgamma and dbeta) launches the
    double-backward kernel once and agrees with ``fused_affine_bwd2_ref``:
    g_x and g_dy are the plain version's products in the same order (bf16:
    rounded once on store), g_gamma a sum over H*W in another order
    (``SUM_TOL``); beta gets no gradient."""
    x, mods, dy = _bwd_inputs(cuda_device, shape, dtype, vec_dtype, 1, seed=5)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    b, c = shape[:2]
    a = torch.randn(shape, generator=gen, device=cuda_device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    cc, e = (torch.randn(b, c, generator=gen, device=cuda_device).to(vec_dtype) for _ in "ce")
    x.requires_grad_()
    dy.requires_grad_()
    g, beta = (m.requires_grad_() for m in mods)
    dx, dg, db = torch.autograd.grad(fa.modulate_lrelu_kernel(x, g, beta), (x, g, beta), dy,
                                     create_graph=True)
    before = fa.DOUBLE_BACKWARD.launches
    got = torch.autograd.grad((a * dx).float().sum() + (cc * dg).float().sum()
                              + (e * db).float().sum(), (x, dy, g, beta), allow_unused=True)
    torch.cuda.synchronize()
    assert fa.DOUBLE_BACKWARD.launches == before + 1
    assert got[3] is None
    want = fa.fused_affine_bwd2_ref(x.detach(), g.detach(), beta.detach(), dy.detach(), a, cc, e)
    rtol, atol = BWD_TOL[dtype]
    for t, w in ((got[0], want[0]), (got[1], want[1])):
        assert t.dtype == dtype
        torch.testing.assert_close(t.float(), w.float(), rtol=rtol, atol=atol)
    extra = BF16_ULP / 2 if vec_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got[2].float(), want[2].float(), rtol=SUM_TOL + extra,
                               atol=SUM_TOL * want[2].float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_double_backward_refuses_the_scalar_kernels_shapes(cuda_device, dtype):
    """At C = 13, where ``plan_bwd`` names the scalar backward kernel, the
    double backward raises before any launch: it has only the vector
    kernel.  The single backward still runs there."""
    x, mods, dy = _bwd_inputs(cuda_device, (2, 13, 5, 7), dtype, dtype, 1, seed=5)
    x.requires_grad_()
    g, beta = (m.requires_grad_() for m in mods)
    dx, dg, _ = torch.autograd.grad(fa.modulate_lrelu_kernel(x, g, beta), (x, g, beta), dy,
                                    create_graph=True)
    before = fa.DOUBLE_BACKWARD.launches
    with pytest.raises(ValueError, match="multiple of .* 16-byte aligned"):
        torch.autograd.grad(dx.float().sum() + dg.float().sum(), x)
    assert fa.DOUBLE_BACKWARD.launches == before


@pytest.mark.cuda
def test_magp_through_concept_netd_runs_the_double_backward(cuda_device):
    """MAGP through ``CONCEPT_NETD`` (NCH 4, 64², batch 4, fp32 with TF32
    off) on the card: one double-backward launch for each of D's four
    ``ConceptResD`` epilogues, and the penalty and its gradient in D's
    parameters as on the CPU (1e-4 relative; gradients to 1e-4 of each
    tensor's largest magnitude: cuDNN's and the CPU's convolutions sum in
    another order)."""
    from xmc_gan_tpu_torch.config import cfg_from_dict
    from xmc_gan_tpu_torch.models.df_concept_gan import NetD
    from xmc_gan_tpu_torch.train import refresh_spectral

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg_from_dict({"TRAIN": {"NCH": 4, "NEF": 16, "HE_INIT": True}, "IMG": {"SIZE": 64},
                         "DISC": {"ENCODER_NAME": "CONCEPT_NETD", "SPEC_NORM": True,
                                  "SENT_MATCH": True}})
    d_cpu = NetD(cfg, gen=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for blk in d_cpu.downblocks:
            blk.gamma.fill_(1.0)  # open the gates: the concept branches count
    refresh_spectral(d_cpu, 20)  # sigma near each weight's norm
    gen = torch.Generator().manual_seed(1)
    imgs = torch.rand(4, 3, 64, 64, generator=gen) * 2 - 1
    sent = torch.randn(4, 16, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        d = d_cpu if dev == "cpu" else NetD(cfg, gen=torch.Generator()).to(dev)
        if dev == "cuda":
            d.load_state_dict(d_cpu.state_dict())
        before = fa.DOUBLE_BACKWARD.launches
        pen = losses.magp_penalty(lambda i, s: d.d_all(i, s)[0].float().sum(),
                                  imgs.to(dev).contiguous(memory_format=torch.channels_last),
                                  sent.to(dev))
        grads = torch.autograd.grad(pen, list(d.parameters()), allow_unused=True)
        out[dev] = (pen.item(), [None if g_ is None else g_.cpu() for g_ in grads],
                    fa.DOUBLE_BACKWARD.launches - before)
    assert out["cpu"][2] == 0 and out["cuda"][2] == 4
    assert 0 < out["cpu"][0] < float("inf")
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    for g_card, g_cpu in zip(out["cuda"][1], out["cpu"][1]):
        if g_cpu is not None:
            torch.testing.assert_close(g_card, g_cpu, rtol=0,
                                       atol=1e-4 * g_cpu.abs().max().item() + 1e-12)


EXPORT_KERNEL = {"DF_GEN": (r"fused_affine_(vec|scalar)<", 10),
                 "CONCEPT_OUTATTN_GEN": (r"attn_small<", 6)}  # launches of one 64² request


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gen", sorted(EXPORT_KERNEL))
def test_exported_sampler_launches_its_kernels(cuda_device, tmp_path, gen, dtype):
    """An exported sampler (``utils/export.py``, symbolic batch) saved and
    loaded serves on the card through the hand kernels, counted by the
    wrapper and by the profiler's names, and gives ``make_sample_fn``'s
    images on the same weights: fp32 with TF32 off to 1e-5, bf16 to one
    bf16 ulp of the [-1, 1] output (the same operators: bit-equal is
    expected)."""
    from xmc_gan_tpu_torch.config import cfg_from_dict
    from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
    from xmc_gan_tpu_torch.utils.export import export_sampler, load_sampler, save_sampler

    cfg = cfg_from_dict({"TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": 16},
                         "GEN": {"ENCODER_NAME": gen}, "IMG": {"SIZE": 64},
                         "TEXT": {"EMBEDDING_DIM": 48, "MAX_LENGTH": 8, "ENCODER_DIR": ""}})
    ep, _ = export_sampler(cfg, dtype=dtype, device="cuda")
    serve = load_sampler(save_sampler(str(tmp_path / "s.pt2"), ep))
    g = make_generator(cfg, dtype, "cuda")
    rand = torch.Generator().manual_seed(3)  # non-zero gates: every branch counts
    params = {k: (v.cpu() + 0.05 * torch.randn(v.shape, generator=rand)).cuda()
              for k, v in g.state_dict().items()}
    g.load_state_dict(params)
    sample = make_sample_fn(cfg, g)
    b = 5
    args = [torch.randn(b, 16, generator=rand), torch.randn(b, 48, generator=rand)]
    if gen != "DF_GEN":
        args += [torch.randn(b, 8, 48, generator=rand), torch.arange(8)[None] >= torch.tensor(
            [[1], [8], [3], [5], [2]])]
    args = [a.cuda() for a in args]
    want = sample(*args)
    serve(params, *args)
    pattern, n = EXPORT_KERNEL[gen]
    count = fa.FORWARD if gen == "DF_GEN" else ca.FORWARD
    before = count.launches
    got = serve(params, *args)
    torch.cuda.synchronize()
    assert count.launches == before + n
    device_kernels(lambda: serve(params, *args), expect={pattern: n})
    assert got.shape == (b, 64, 64, 3) and got.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else BF16_ULP
    assert (got - want).abs().max().item() <= tol
