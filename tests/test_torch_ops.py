"""The port's ops layer against the JAX package: initializers, the upsample
fold, spectral-norm conv/dense on stored u/v, the modulation epilogue (plain
version vs ``xmc_gan_tpu.ops.fused`` and the Pallas kernels in interpret mode),
and the CUDA kernel wrapper's guards.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, marker ``cuda``)."""

import contextlib
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from xmc_gan_tpu.ops import fused as jax_fused
from xmc_gan_tpu.ops.modules import SNConv as JaxSNConv
from xmc_gan_tpu.ops.modules import SNDense as JaxSNDense
from xmc_gan_tpu.ops.modules import upsample_nearest_2x as jax_upsample
from xmc_gan_tpu.ops.pallas.fused_affine import (
    double_modulate_lrelu_pallas,
    modulate_lrelu_pallas,
)
from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.models.common import affine_out_inits, inits
from xmc_gan_tpu_torch.models.df_gan import epilogue_shapes
from xmc_gan_tpu_torch.ops import fused
from xmc_gan_tpu_torch.ops.cuda import build as cuda_build
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.ops.initializers import he_normal_fan_in, torch_default_kernel_init
from xmc_gan_tpu_torch.ops.modules import (
    SNConv,
    SNDense,
    fold_upsample_kernel,
    upsample_nearest_2x,
)
from xmc_gan_tpu_torch.utils.convert import conv_state_dict, dense_state_dict

BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)
CFG_DIR = Path(__file__).resolve().parents[1] / "xmc_gan_tpu" / "cfg"


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.tensor(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_initializers_match_reference_statistics():
    """He fan-in normal: std sqrt(2/fan_in); PyTorch default: U(+-1/sqrt(fan_in))."""
    w = torch.empty(256, 64, 3, 3)
    he_normal_fan_in(w, _gen())
    assert abs(w.std().item() - math.sqrt(2 / (64 * 9))) < 0.01 * math.sqrt(2 / (64 * 9))
    torch_default_kernel_init(w, _gen())
    bound = 1 / math.sqrt(64 * 9)
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.99 * bound
    b = torch.empty(1000)
    inits(False, 10)[1](b, _gen())
    assert b.abs().max().item() <= 1 / math.sqrt(10)
    k, gb = affine_out_inits(False, gamma=True, fan_in=256)
    k(w, _gen()), gb(b, _gen())
    assert w.abs().max().item() == 0 and bool((b == 1).all())
    k, gb = affine_out_inits(True, gamma=True, fan_in=256)
    assert k is he_normal_fan_in
    gb(b, _gen())
    assert b.abs().max().item() == 0


def test_fold_equals_upsample_then_conv():
    """conv_transpose2d with the folded (unflipped) taps == upsample -> conv3x3.
    Tolerance: fp32 summation order only (1e-5)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 5, 6, 7).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 5, 3, 3).astype(np.float32))
    want = torch.nn.functional.conv2d(upsample_nearest_2x(x), w, padding=1)
    got = torch.nn.functional.conv_transpose2d(x, fold_upsample_kernel(w), stride=2, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_upsample_matches_jax():
    x = np.random.RandomState(1).randn(2, 3, 5, 4).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(upsample_nearest_2x(_nchw(x))), want)


@pytest.mark.parametrize("pre_upsample", [True, False])
def test_snconv_matches_jax(pre_upsample):
    """3x3/pad-1 SNConv, folded (vs the JAX pre-flipped input-dilated fold) and
    plain.  Tolerance: fp32 summation order (1e-5)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    m = JaxSNConv(7, 3, padding=1, pre_upsample=pre_upsample)
    params = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), x)["params"])
    params["bias"] = rng.randn(7).astype(np.float32)
    want = np.asarray(m.apply({"params": params}, x))
    port = SNConv(8, 7, 3, padding=1, pre_upsample=pre_upsample, gen=_gen())
    port.load_state_dict(conv_state_dict(params), strict=True)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "conv3x3", "conv4x4s2"])
def test_spectral_norm_on_stored_uv_matches_jax(kind):
    """Spectral norm with the stored u/v (the JAX non-mutable branch); conv v
    re-ordered from the JAX (kH, kW, I) to the torch (I, kH, kW) flattening.
    Tolerance: fp32 (1e-5)."""
    rng = np.random.RandomState(3)
    if kind == "dense":
        x = rng.randn(4, 9).astype(np.float32)
        m = JaxSNDense(5, spec_norm=True)
        port = SNDense(9, 5, spec_norm=True, gen=_gen())
        to_sd, to_port, from_port = dense_state_dict, torch.from_numpy, lambda t: t.numpy()
    else:
        k, s, p = (3, 1, 1) if kind == "conv3x3" else (4, 2, 1)
        x = rng.randn(2, 8, 8, 6).astype(np.float32)
        m = JaxSNConv(5, k, strides=s, padding=p, use_bias=False, spec_norm=True)
        port = SNConv(6, 5, k, stride=s, padding=p, use_bias=False, spec_norm=True, gen=_gen())
        to_sd, to_port, from_port = conv_state_dict, _nchw, _nhwc
    variables = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), x))
    want = np.asarray(m.apply(variables, x))  # spectral collection not mutable
    port.load_state_dict(to_sd(variables["params"], variables["spectral"]), strict=True)
    with torch.no_grad():
        got = from_port(port(to_port(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _epilogue_inputs(seed, shape=(2, 16, 4, 4), nmod=2):
    rng = np.random.RandomState(seed)
    b, c, h, w = shape
    x = rng.randn(b, h, w, c).astype(np.float32)
    mods = [rng.randn(b, c).astype(np.float32) for _ in range(2 * nmod)]
    return x, mods


@pytest.mark.parametrize("nmod", [1, 2])
def test_plain_epilogue_matches_jax_fp32(nmod):
    """Plain version vs ``ops/fused.py`` and vs the Pallas kernel (interpret
    mode).  Tolerance: 1e-6, fp32 rounding of the same expression."""
    x, mods = _epilogue_inputs(4, nmod=nmod)
    jax_plain = jax_fused.modulate_lrelu if nmod == 1 else jax_fused.double_modulate_lrelu
    pallas = modulate_lrelu_pallas if nmod == 1 else double_modulate_lrelu_pallas
    port = fa.modulate_lrelu_ref if nmod == 1 else fa.double_modulate_lrelu_ref
    got = _nhwc(port(_nchw(x), *map(torch.from_numpy, mods)))
    np.testing.assert_allclose(got, np.asarray(jax_plain(x, *mods)), rtol=1e-6, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas(jnp.asarray(x), *map(jnp.asarray, mods)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nmod", [1, 2])
def test_plain_epilogue_matches_pallas_bf16(nmod):
    """bf16: fp32 math and one rounding on store, like the Pallas kernel —
    within one bf16 ulp of it.  The JAX plain epilogue rounds every bf16
    product and sum inside the chain, whose terms can be larger than the
    result, so it is held to a looser bound: 4 ulps relative plus 2^-6
    absolute (two ulps at the O(1) scale of these operands)."""
    x, mods = _epilogue_inputs(5, shape=(2, 32, 8, 8), nmod=nmod)
    xb = jnp.asarray(x, jnp.bfloat16)
    pallas = modulate_lrelu_pallas if nmod == 1 else double_modulate_lrelu_pallas
    port = fa.modulate_lrelu_ref if nmod == 1 else fa.double_modulate_lrelu_ref
    got_t = port(_nchw(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                 *map(torch.from_numpy, mods))
    assert got_t.dtype == torch.bfloat16
    got = _nhwc(got_t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas(xb, *map(jnp.asarray, mods)).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)
    jax_plain = jax_fused.modulate_lrelu if nmod == 1 else jax_fused.double_modulate_lrelu
    want_plain = jax_plain(xb, *[jnp.asarray(m, jnp.bfloat16) for m in mods])
    np.testing.assert_allclose(got, np.asarray(want_plain.astype(jnp.float32)),
                               rtol=4 * BF16_ULP, atol=2.0 ** -6)


def test_seam_uses_plain_version_on_cpu_without_counting():
    x, mods = _epilogue_inputs(6)
    xt, mt = _nchw(x), list(map(torch.from_numpy, mods))
    before = fa.FORWARD.launches
    torch.testing.assert_close(fused.double_modulate_lrelu(xt, *mt),
                               fa.double_modulate_lrelu_ref(xt, *mt), rtol=0, atol=0)
    torch.testing.assert_close(fused.modulate_lrelu(xt, *mt[:2]),
                               fa.modulate_lrelu_ref(xt, *mt[:2]), rtol=0, atol=0)
    want = mt[0][:, :, None, None] * xt + mt[1][:, :, None, None]
    torch.testing.assert_close(fused.modulate(xt, *mt[:2]), want, rtol=0, atol=0)
    assert fa.FORWARD.launches == before


@pytest.mark.parametrize("nmod", [1, 2])
@pytest.mark.parametrize("dy_layout", ["channels_last", "contiguous"])
def test_backward_matches_jax_vjp_fp32(nmod, dy_layout):
    """The autograd Function's CPU backward (``fused_affine_bwd_ref``) against
    ``jax.vjp`` of the JAX plain epilogue (``ops/fused.py``): dx and the
    modulation vectors' gradients, summed over H*W.  Including the kink: a
    few inputs sit exactly where g0 * x + b0 = 0, where LeakyReLU's
    derivative is 1 in both (``jnp.where(y >= 0, ...)``).  Tolerance:
    fp32 sums in another order (1e-5)."""
    x, mods = _epilogue_inputs(8, shape=(2, 8, 5, 3), nmod=nmod)
    x[0, 0, 0, :] = -mods[1][0] / mods[0][0]  # g0 * x + b0 == 0 up to rounding
    x[0, 0, 0, 0] = 0.0
    mods[1][0, 0] = 0.0  # ... and exactly 0 at one element
    dy = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    jax_plain = jax_fused.modulate_lrelu if nmod == 1 else jax_fused.double_modulate_lrelu
    _, vjp = jax.vjp(jax_plain, jnp.asarray(x), *map(jnp.asarray, mods))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    xt = _nchw(x).requires_grad_()
    mt = [torch.from_numpy(m).requires_grad_() for m in mods]
    dyt = _nchw(dy)
    if dy_layout == "contiguous":
        dyt = dyt.contiguous()
    fn = fa.modulate_lrelu_kernel if nmod == 1 else fa.double_modulate_lrelu_kernel
    before = fa.BACKWARD.launches
    got = torch.autograd.grad(fn(xt, *mt), (xt, *mt), dyt)
    assert fa.BACKWARD.launches == before  # CPU tensors: the plain version
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got[0]), want[0], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_backward_keeps_input_dtypes():
    """bf16 x gives a bf16 dx; bf16 vectors give bf16 vector gradients (the
    sums are taken in fp32, then cast); only G's epilogue is differentiated,
    and only once."""
    x, mods = _epilogue_inputs(10)
    xt = _nchw(x).bfloat16().requires_grad_()
    mt = [torch.from_numpy(m).bfloat16().requires_grad_() for m in mods]
    y = fa.double_modulate_lrelu_kernel(xt, *mt)
    dy = torch.ones_like(y, requires_grad=True)
    grads = torch.autograd.grad(y, (xt, *mt), dy, create_graph=True)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 5
    with pytest.raises(RuntimeError, match="differentiate twice"):
        grads[1].float().sum().backward()


@pytest.mark.parametrize("nmod", [1, 2])
def test_backward_matches_jax_vjp_bf16_vectors(nmod):
    """bf16 x, dy and vectors, as G's bf16 train step hands them over: the
    autograd Function's CPU backward against ``jax.vjp`` of the JAX plain
    epilogue computed in fp32 on the same (bf16-representable) values.  Both
    take the products of bf16 values exactly in fp32, so the port's results
    are the fp32 ones rounded once to bf16: dx within half a bf16 ulp
    relative (2^-8) of JAX's, plus 1e-6 absolute for the fp32 terms' own
    rounding; the vector gradients, fp32 sums over H*W in another order
    before that rounding, within one bf16 ulp relative (2^-7) plus 1e-5."""
    x, mods = _epilogue_inputs(11, shape=(2, 24, 6, 5), nmod=nmod)
    dy = np.random.RandomState(12).randn(*x.shape).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    xt = _nchw(x).bfloat16()
    mt = [bf(m) for m in mods]
    dyt = _nchw(dy).bfloat16()
    jax_plain = jax_fused.modulate_lrelu if nmod == 1 else jax_fused.double_modulate_lrelu
    as32 = lambda t: t.float().numpy()
    _, vjp = jax.vjp(jax_plain, jnp.asarray(_nhwc(xt)), *(jnp.asarray(as32(m)) for m in mt))
    want = [np.asarray(g) for g in vjp(jnp.asarray(_nhwc(dyt)))]
    xt.requires_grad_()
    for m in mt:
        m.requires_grad_()
    fn = fa.modulate_lrelu_kernel if nmod == 1 else fa.double_modulate_lrelu_kernel
    got = torch.autograd.grad(fn(xt, *mt), (xt, *mt), dyt)
    assert [g.dtype for g in got] == [torch.bfloat16] * (1 + 2 * nmod)
    np.testing.assert_allclose(_nhwc(got[0]), want[0], rtol=BF16_ULP / 2, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=BF16_ULP, atol=1e-5)


def _path_shapes(config: str) -> list[tuple[int, int, int, int]]:
    """The epilogue backward's inputs of one train step: the 14 of the
    flagship_word step (256², NCH=32, batch 128) or of the LN-COCO one
    (NCH=96, batch 256), or the 40 of the ``concept_out_df_gan.yml`` one
    (64², NCH=32, batch 88: ``CONCEPT_NETD``'s four 5 times, G's twenty)."""
    if config == "concept":
        from xmc_gan_tpu_torch.models.df_concept_gan import (
            disc_modulation_shapes,
            modulation_shapes,
        )

        cfg = cfg_from_file(str(CFG_DIR / "concept_out_df_gan.yml"))
        bs = cfg.TRAIN.BATCH_SIZE
        return 5 * disc_modulation_shapes(cfg, bs) + modulation_shapes(cfg, bs)
    if config == "flagship":
        cfg = cfg_from_dict({"IMG": {"SIZE": 256}, "TEXT": {"ENCODER_DIR": ""}},
                            base=cfg_from_file(str(CFG_DIR / "df_gan_damsm.yml")))
        return epilogue_shapes(cfg, 128)
    cfg = cfg_from_file(str(CFG_DIR / "ln_coco_256.yml"))
    return epilogue_shapes(cfg, cfg.TRAIN.BATCH_SIZE)


@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config", ["flagship", "ln", "concept"])
def test_plan_bwd_takes_every_path_shape_on_the_vector_kernel(config, dtype, vec_dtype):
    """Every epilogue input of the three train steps (C a multiple of 8
    each) plans ``fused_affine_bwd_vec``, in both dtypes and with vectors of
    either dtype: a block is a whole number of pixels (threads a multiple
    of C / width, at most 256), the grid covers H*W exactly once per image
    with runs of whole block steps, and the card holds several blocks a
    multiprocessor."""
    shapes = _path_shapes(config)
    assert len(shapes) == (40 if config == "concept" else 14)
    width = 16 // torch.empty((), dtype=dtype).element_size()
    for b, c, h, w in shapes:
        p = fa.plan_bwd(b, h * w, c, dtype, vec_dtype, (0, 256, 512), sms=132)
        assert p.kernel == fa.BWD_VEC
        lanes = c // width
        assert p.threads % lanes == 0 and p.threads <= 256 and p.threads > 256 - lanes
        rows = p.threads // lanes
        assert p.run % rows == 0 and p.chunks * p.run >= h * w > (p.chunks - 1) * p.run
        assert p.grid == (p.chunks, b, 1)
        assert b * p.chunks >= min(132, b)
        assert p.chunks <= max(1, math.ceil(132 * fa._BWD_BLOCKS_PER_SM / b))
        assert fa.bwd_kernel_name(p, dtype, vec_dtype, 2).startswith("fused_affine_bwd_vec<")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_bwd_takes_the_scalar_kernel_at_its_edges(dtype):
    """C = 13 (no multiple of the 16-byte width), x 2 bytes off a 16-byte
    boundary, dy or dx off one, and a pixel wider than 256 chunks take
    ``fused_affine_bwd_scalar``: 32 x 8 threads, one block column per 32
    channels, runs of whole 8-pixel steps covering H*W."""
    width = 16 // torch.empty((), dtype=dtype).element_size()
    cases = [(4, 35, 13, (0, 0, 0)), (2, 36, 64, (2, 0, 0)), (2, 36, 64, (0, 4, 0)),
             (2, 36, 64, (0, 0, 8)), (2, 9, 257 * width, (0, 0, 0))]
    for b, hw, c, ptrs in cases:
        p = fa.plan_bwd(b, hw, c, dtype, torch.bfloat16, ptrs, sms=132)
        assert p.kernel == fa.BWD_SCALAR and p.threads == 256
        assert p.grid[0] == math.ceil(c / 32) and p.grid[2] == b
        assert p.run % 8 == 0 and p.chunks * p.run >= hw > (p.chunks - 1) * p.run
        assert fa.bwd_kernel_name(p, dtype, torch.bfloat16, 1) == (
            f"fused_affine_bwd_scalar<{'float' if dtype == torch.float32 else '__nv_bfloat16'}, "
            "__nv_bfloat16, 1>")
    assert fa.plan_bwd(2, 36, 64, dtype, dtype, (16, 32, 48), sms=132).kernel == fa.BWD_VEC


def test_plan_bwd_raises_for_what_no_kernel_takes():
    with pytest.raises(ValueError, match="B <= 65535"):
        fa.plan_bwd(70000, 16, 32, torch.float32, torch.float32, (0, 0, 0), sms=132)
    with pytest.raises(ValueError, match="C >= 1"):
        fa.plan_bwd(2, 16, 0, torch.float32, torch.float32, (0, 0, 0), sms=132)
    with pytest.raises(ValueError, match="H\\*W"):
        fa.plan_bwd(2, 2**29, 8, torch.float32, torch.float32, (0, 0, 0), sms=132)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.plan_bwd(2, 16, 32, torch.float16, torch.float32, (0, 0, 0), sms=132)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.plan_bwd(2, 16, 32, torch.float32, torch.float64, (0, 0, 0), sms=132)


@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nmod", [1, 2])
def test_launch_bwd_hands_the_entry_the_plan(monkeypatch, nmod, vec_dtype):
    """What ``_launch_bwd`` passes the C entry, with the library and the
    stream faked: x, a channels_last dy and the vectors as they are (no
    cast, no copy), one zeroed fp32 ``[2 * nmod, B, C]`` sums buffer, the
    shape, both dtype codes and the plan's kernel and grid; the vector
    gradients come back in the vectors' dtype, from that one buffer (one
    cast for bf16 vectors, none for fp32).  A dy that is not channels_last
    is copied once, and counted."""
    calls, zeros = [], []

    class Lib:
        @staticmethod
        def xmc_fused_affine_bwd(*args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    real_zeros = torch.zeros

    def counting_zeros(*args, **kwargs):
        zeros.append((args, kwargs))
        return real_zeros(*args, **kwargs)

    monkeypatch.setattr(fa.KERNEL, "load", lambda: Lib)
    monkeypatch.setattr(fa, "_multiprocessors", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    monkeypatch.setattr(torch, "zeros", counting_zeros)
    b, c, h, w = 2, 24, 5, 3
    x = torch.randn(b, h, w, c).permute(0, 3, 1, 2).bfloat16()
    dy = torch.randn(b, h, w, c).permute(0, 3, 1, 2).bfloat16()
    mods = tuple(torch.randn(b, c).to(vec_dtype) for _ in range(2 * nmod))
    before, copies = fa.BACKWARD.launches, fa.DY_COPIES.launches
    dx, *grads = fa._launch_bwd(x, mods, dy, 0.2)
    args = calls[-1]
    assert fa.BACKWARD.launches == before + 1 and fa.DY_COPIES.launches == copies
    assert len(zeros) == 1 and zeros[0][0][0] == (2 * nmod, b, c)
    assert zeros[0][1]["dtype"] == torch.float32
    vecs = [m.data_ptr() for m in mods] * (2 // nmod)
    assert args[:3] == (x.data_ptr(), dy.data_ptr(), dx.data_ptr())
    assert list(args[3:7]) == vecs
    p = fa.plan_bwd(b, h * w, c, torch.bfloat16, vec_dtype,
                    (x.data_ptr(), dy.data_ptr(), dx.data_ptr()), sms=132)
    assert args[8:15] == (b, h * w, c, nmod, 1, fa._DTYPE_CODE[vec_dtype], pytest.approx(0.2))
    assert args[15:19] == (fa._BWD_KERNEL_CODE[p.kernel], p.threads, p.chunks, p.run)
    assert dx.dtype == torch.bfloat16 and dx.is_contiguous(memory_format=torch.channels_last)
    assert len(grads) == 2 * nmod and {g.dtype for g in grads} == {vec_dtype}
    storage = grads[0].untyped_storage().data_ptr()
    assert all(g.untyped_storage().data_ptr() == storage for g in grads)
    assert (storage == args[7]) == (vec_dtype == torch.float32)
    assert all(bool((g == 0).all()) for g in grads)  # the fake adds nothing to the zeros
    nchw = dy.contiguous()
    fa._launch_bwd(x, mods, nchw, 0.2)
    assert calls[-1][1] != nchw.data_ptr() and fa.DY_COPIES.launches == copies + 1


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, mods = _epilogue_inputs(7)
    xt, mt = _nchw(x), list(map(torch.from_numpy, mods))
    # inputs that require grad are taken, in and out of grad mode
    assert fa.double_modulate_lrelu_kernel(xt.clone().requires_grad_(), *mt).requires_grad
    with torch.no_grad():
        fa.double_modulate_lrelu_kernel(xt.clone().requires_grad_(), *mt)
    with pytest.raises(ValueError, match="channels_last"):
        fa.double_modulate_lrelu_kernel(xt.contiguous(), *mt)
    with pytest.raises(ValueError, match=r"\[B, C\]"):
        fa.modulate_lrelu_kernel(xt, mt[0][:, :3], mt[1])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.modulate_lrelu_kernel(xt.half(), *mt[:2])
    with pytest.raises(ValueError, match="NCHW"):
        fa.modulate_lrelu_kernel(xt[0], *mt[:2])


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("fused_affine.cu")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.CudaLibrary("fused_affine.cu", fa.KERNEL.signatures).load()
