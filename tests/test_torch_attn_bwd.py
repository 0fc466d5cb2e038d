"""The masked cross-attention backward: its plain version
(``ops/cuda/cross_attention.masked_cross_attention_bwd_ref``) against
``jax.vjp`` of the JAX package's XLA branch and against autograd of the
port's plain forward, its plan (``plan_bwd``) and what the wrapper hands the
C entry (the library faked).  The kernel itself runs on the card only
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmc_gan_tpu.ops.pallas.cross_attention import masked_cross_attention as jax_mca
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca

# plain backward vs jax.vjp of the XLA branch: the same fp32 formulas in
# another summation order (einsums, softmax), each gradient to 1e-5
# relative and 1e-6 of its largest magnitude
VJP_RTOL, VJP_ATOL_FRAC = 1e-5, 1e-6


def _planes_view(x: np.ndarray) -> torch.Tensor:
    """``[B, G, N, D]`` values laid out as planes, ``[B, G, D, N]`` in
    memory (the In sampler's queries after a CUDA GroupNorm)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 3, 2))).transpose(2, 3)


def _rows_view(x: np.ndarray) -> torch.Tensor:
    """``[B, G, N, D]`` values laid out as rows, ``[B, N, G, D]`` in memory
    (the channels_last query map)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)


def _normalized(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _lens_mask(lens, t):
    return np.arange(t)[None, :] >= np.asarray(lens)[:, None]


# (B, G, N, T, D, q's layout, caption lengths): the In sampler's shapes (G =
# 16 concept groups, D = 4, T = 15) with q as rows and as planes, the Out
# block's (G = 1: [B, 16, 4] states), a ragged D = 12 one and T = 200; every
# caption has a real word (the JAX chain gives NaN for one that has none)
VJP_CASES = [(2, 16, 64, 15, 4, "rows", [15, 3]), (2, 16, 64, 15, 4, "planes", [1, 9]),
             (4, 1, 16, 15, 4, "dense", [15, 1, 7, 4]), (3, 2, 37, 33, 12, "dense", [33, 5, 20]),
             (2, 1, 16, 200, 4, "dense", [200, 31])]


@pytest.mark.parametrize("b,g,n,t,d,layout,lens", VJP_CASES, ids=str)
def test_plain_backward_matches_jax_vjp(b, g, n, t, d, layout, lens):
    """dq, dk and dv of the plain version against ``jax.vjp`` of
    ``masked_cross_attention(..., backend="xla")`` with the groups folded
    into the batch, k passed as v (both samplers do), on the same numpy
    inputs and cotangent."""
    rng = np.random.RandomState(b * 100 + t)
    q = _normalized(rng, b, g, n, d)
    k = _normalized(rng, b, g, t, d)
    dout = rng.randn(b, g, n, d).astype(np.float32)
    mask = _lens_mask(lens, t)
    fold = lambda x: x.reshape(b * g, *x.shape[2:])  # noqa: E731
    mask_f = np.repeat(mask, g, axis=0)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_mca(q_, k_, v_, mask_f, 0.7, backend="xla"),
                     jnp.asarray(fold(q)), jnp.asarray(fold(k)), jnp.asarray(fold(k)))
    want = [np.asarray(x).reshape(b, g, *x.shape[1:]) for x in vjp(jnp.asarray(fold(dout)))]
    if layout == "dense":
        qt = torch.from_numpy(q)
    else:
        qt = (_rows_view if layout == "rows" else _planes_view)(q)
    kt, gt, mt = torch.from_numpy(k), torch.from_numpy(dout), torch.from_numpy(mask)
    if g == 1:  # the Out block's operands are three-dimensional
        qt, kt, gt = qt[:, 0], kt[:, 0], gt[:, 0]
        want = [w[:, 0] for w in want]
    got = ca.masked_cross_attention_bwd_ref(qt, kt, kt, mt, gt, 0.7)
    for name, gr, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gr.numpy(), w, rtol=VJP_RTOL,
                                   atol=VJP_ATOL_FRAC * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_backward_is_autograd_of_the_plain_forward(dtype):
    """The formulas against autograd of ``masked_cross_attention_ref`` (fp32
    math inside, one rounding to the operands' type): rows 0 and 3 fully
    padded get zero gradients in both, not the NaN of a dense softmax; k
    passed as v gets dk + dv."""
    rng = np.random.RandomState(3)
    b, g, n, t, d = 5, 4, 21, 9, 6
    q = torch.from_numpy(rng.randn(b, g, n, d).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.randn(b, g, t, d).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.randn(b, g, n, d).astype(np.float32)).to(dtype)
    mask = torch.from_numpy(_lens_mask([0, 4, 9, 0, 1], t))
    qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
    ca.masked_cross_attention_ref(qg, kg, kg, mask, 0.5).backward(dout)
    dq, dk, dv = ca.masked_cross_attention_bwd_ref(q, k, k, mask, dout, 0.5)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    # fp32: the same formulas in another order; bf16: one rounding each way
    tol = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2.0 ** -7, 1e-3)}[dtype]
    torch.testing.assert_close(dq.float(), qg.grad.float(), rtol=tol[0], atol=tol[1])
    torch.testing.assert_close((dk.float() + dv.float()), kg.grad.float(), rtol=2 * tol[0],
                               atol=2 * tol[1])
    for x in (dq, dk, dv, qg.grad, kg.grad):
        assert bool(torch.isfinite(x.float()).all())
        assert bool((x[0] == 0).all()) and bool((x[3] == 0).all())


def test_padded_words_get_zero_key_and_value_gradients():
    rng = np.random.RandomState(4)
    q, k, v, dout = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                     for s in ((3, 10, 4), (3, 6, 4), (3, 6, 4), (3, 10, 4)))
    mask = torch.from_numpy(_lens_mask([2, 6, 5], 6))
    _, dk, dv = ca.masked_cross_attention_bwd_ref(q, k, v, mask, dout)
    assert bool((dk[mask] == 0).all()) and bool((dv[mask] == 0).all())
    assert bool((dk[~mask] != 0).any()) and bool((dv[~mask] != 0).all())


# ----------------------------------------------------------------- the plan


# attn_bwd_warp's shared memory (csrc warp_bwd_smem): the head (the real
# words' keys and values, TMAX float4 each), then per warp the q and dO x
# tiles (576 + 512 bytes), three 1 KB stages of a batch's q and dO and the
# [2 TMAX][36] dS and P rows
def _warp_smem(tmax, warps):
    return 32 * tmax + warps * (576 + 512 + 3 * 1024 + 2 * tmax * 36 * 4)


@pytest.mark.parametrize("t,d,tile,dmax", [(33, 4, 128, 4), (33, 5, 128, 8),
                                           (64, 16, 128, 16), (65, 32, 64, 32),
                                           (200, 4, 32, 4), (256, 32, 32, 32), (15, 12, 256, 16),
                                           (0, 5, 256, 8)])
def test_plan_bwd_geometry(t, d, tile, dmax):
    """``attn_bwd`` past T = 32 or D = 4: one block per (b, g); a tile of 256
    queries up to T = 32, halved as T doubles; shared memory as the kernel
    lays it out (keys, values, the two accumulators, the [T][tile + 1]
    weight and cotangent tiles, the [D][tile + 1] query and dO tiles, two int
    arrays), at most 227 KB."""
    p = ca.plan_bwd(88, 16, 4096, t, d, torch.float32)
    assert (p.kernel, p.dmax, p.tmax, p.threads, p.blocks) == (ca.BWD, dmax, 0, tile, 88 * 16)
    assert p.smem == 4 * (4 * t * dmax + 2 * (t + dmax) * (tile + 1)) + 8 * t
    assert p.smem <= 232448
    name = ca.bwd_kernel_name(p, torch.bfloat16)
    assert name == f"attn_bwd<__nv_bfloat16, {dmax}>"


@pytest.mark.parametrize("t,d,tmax", [(15, 4, 16), (16, 4, 16), (17, 4, 32), (20, 4, 32),
                                      (32, 4, 32), (1, 4, 16), (0, 4, 16), (15, 1, 16),
                                      (20, 3, 32)])
def test_plan_bwd_names_the_warp_kernel_up_to_32_words(t, d, tmax):
    """``attn_bwd_warp`` at D <= 4 and T <= 32: TMAX 16 up to T = 16, else 32;
    two warps a block, one (b, g) row a block; ~18 KB of shared memory a
    block (27 KB at TMAX 32), so that 11 (8) blocks fit an SM: at TMAX 16
    (the step's T = 15) the 1,408 rows of its In launches are one wave on the
    H100's 132."""
    p = ca.plan_bwd(88, 16, 4096, t, d, torch.float32)
    assert p == ca.BwdPlan(ca.BWD_WARP, 4, tmax, 64, 88 * 16, _warp_smem(tmax, 2))
    assert ca.bwd_kernel_name(p, torch.float32) == f"attn_bwd_warp<float, {tmax}>"
    blocks_an_sm = 11 if tmax == 16 else 8
    assert blocks_an_sm * (p.smem + 1024 + 260) <= 228 * 1024  # + reserved + static
    assert (132 * blocks_an_sm >= p.blocks) == (tmax == 16)


def test_plan_bwd_at_the_step_shapes():
    """The 64² step's launches, In (B = 88, G = 16, N = 256 ... 4096, T = 15)
    and Out (16 states a row), T = 20 (the flagship's captions): all on
    ``attn_bwd_warp``; In in two-warp blocks, Out in one warp (a row is one
    32-query batch)."""
    for n in (256, 1024, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            p = ca.plan_bwd(88, 16, n, 15, 4, dtype)
            assert (p.kernel, p.tmax, p.threads, p.blocks) == (ca.BWD_WARP, 16, 64, 1408)
    out = ca.plan_bwd(88, 1, 16, 15, 4, torch.bfloat16)
    assert (out.kernel, out.tmax, out.threads, out.blocks, out.smem) == (
        ca.BWD_WARP, 16, 32, 88, _warp_smem(16, 1))
    assert ca.bwd_kernel_name(out, torch.bfloat16) == "attn_bwd_warp<__nv_bfloat16, 16>"
    p20 = ca.plan_bwd(88, 16, 1024, 20, 4, torch.float32)
    assert (p20.kernel, p20.tmax, p20.threads) == (ca.BWD_WARP, 32, 64)


@pytest.mark.parametrize("b,g,n,t,d", [(88, 16, 4096, 32, 4), (88, 16, 4096, 33, 4),
                                       (2, 1, 8, 32, 4), (2, 1, 8, 33, 4), (2, 1, 8, 15, 5)])
def test_plan_bwd_boundary_32_words(b, g, n, t, d):
    """T = 32 is the last caption ``attn_bwd_warp`` takes (its ballot of the
    mask row, TMAX 32); T = 33 and D = 5 go to ``attn_bwd``."""
    p = ca.plan_bwd(b, g, n, t, d, torch.float32)
    warp = t <= 32 and d <= 4
    assert p.kernel == (ca.BWD_WARP if warp else ca.BWD)
    assert (p.tmax, p.dmax) == ((32, 4) if warp else (0, 4 if d <= 4 else 8))


@pytest.mark.parametrize("n,threads", [(1, 32), (31, 32), (32, 32), (33, 64), (77, 64),
                                       (4097, 64), (0, 32)])
def test_plan_bwd_warp_geometry_over_n(n, threads):
    """N = 1 and N that is no multiple of a block's 32-query batches: one
    warp up to N = 32, else two; every (b, g) row one block whatever N (the
    kernel masks the ragged batch)."""
    p = ca.plan_bwd(5, 16, n, 15, 4, torch.bfloat16)
    assert (p.kernel, p.threads, p.blocks) == (ca.BWD_WARP, threads, 80)
    assert p.smem == _warp_smem(16, threads // 32)


@pytest.mark.parametrize("shape", [(88, 16, 4096, 15, 4), (88, 1, 16, 15, 4), (3, 2, 77, 33, 12),
                                   (2, 1, 100, 256, 32), (7, 3, 1, 20, 2)])
def test_plan_bwd_is_a_pure_function_of_the_shapes(shape):
    """The same shapes give the same plan, in both dtypes, in any order of
    calls; nothing of an earlier call's shapes or of the operands' layout
    enters (``plan_bwd`` takes the shapes and the dtype only)."""
    first = ca.plan_bwd(*shape, torch.float32)
    ca.plan_bwd(1, 1, 1, 1, 1, torch.bfloat16)  # another shape in between
    assert ca.plan_bwd(*shape, torch.float32) == first
    assert ca.plan_bwd(*shape, torch.bfloat16) == first


@pytest.mark.parametrize("t,d,err,match", [(15, 33, ValueError, "D <= 32"),
                                           (15, 0, ValueError, "D <= 32"),
                                           (257, 4, ValueError, "T <= 256"),
                                           (15, 4, TypeError, "float32 or bfloat16")])
def test_plan_bwd_refuses_what_the_kernel_does_not_take(t, d, err, match):
    dtype = torch.float16 if err is TypeError else torch.float32
    with pytest.raises(err, match=match):
        ca.plan_bwd(2, 1, 8, t, d, dtype)


def test_backward_launch_hands_the_entry_the_plan(monkeypatch):
    """What ``_launch_bwd`` passes the C entry of the kernel the plan names,
    the library and stream faked: the operands as they are (q as planes, the
    keys' d-stride T, dO a strided slice), dq allocated with q's strides, dk
    and dv dense, and the plan's geometry; one count a launch, either
    kernel."""
    calls = []

    class Lib:
        @staticmethod
        def xmc_cross_attention_bwd(*args):
            calls.append(("xmc_cross_attention_bwd", args))
            return 0

        @staticmethod
        def xmc_cross_attention_bwd_warp(*args):
            calls.append(("xmc_cross_attention_bwd_warp", args))
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ca.KERNEL, "load", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    b, g, n, t, d = 2, 16, 200, 15, 4
    q = torch.randn(b, g, d, n).transpose(2, 3)  # planes
    k = torch.randn(b, g, d, t).transpose(2, 3)  # [B, G, D, T] in memory
    dout = torch.randn(b, g, n, 2 * d)[..., d:]  # a slice of a wider gradient
    mask = torch.zeros(b, t, dtype=torch.bool)
    before = ca.BACKWARD.launches
    dq, dk, dv = ca._launch_bwd(q, k, k, mask, dout, 0.5)
    assert ca.BACKWARD.launches == before + 1
    name, args = calls[-1]
    p = ca.plan_bwd(b, g, n, t, d, torch.float32)
    assert name == "xmc_cross_attention_bwd_warp" and p.kernel == ca.BWD_WARP
    assert args[0] == q.data_ptr() and args[1] == args[2] == k.data_ptr()
    assert args[4] == dout.data_ptr() and args[5:8] == (dq.data_ptr(), dk.data_ptr(),
                                                        dv.data_ptr())
    assert args[8:13] == (b, g, n, t, d)
    assert args[13:17] == q.stride() and args[17:21] == k.stride() == args[21:25]
    assert args[25:29] == dout.stride() and args[29:33] == dq.stride() == q.stride()
    assert args[33] == 0.5 and args[34:] == (0, p.tmax, p.threads, p.blocks, p.smem, 0)
    assert dk.shape == dv.shape == k.shape and dk.is_contiguous() and dv.is_contiguous()
    q3, k3 = torch.randn(b, 16, d), torch.randn(b, t, d)  # the Out block's
    dq3, dk3, _ = ca._launch_bwd(q3, k3, k3, mask, torch.randn(b, 16, d), 1.0)
    assert calls[-1][0] == "xmc_cross_attention_bwd_warp"
    assert calls[-1][1][8:13] == (b, 1, 16, t, d) and dq3.shape == q3.shape
    assert dk3.shape == k3.shape
    with pytest.raises(ValueError, match="dout must be"):
        ca._launch_bwd(q3, k3, k3, mask, torch.randn(b, 16, d).bfloat16(), 1.0)
    # past 32 words: attn_bwd's entry, with its DMAX
    t2 = 40
    k2 = torch.randn(b, g, t2, d)
    ca._launch_bwd(q, k2, k2, torch.zeros(b, t2, dtype=torch.bool), dout, 0.5)
    name, args = calls[-1]
    p2 = ca.plan_bwd(b, g, n, t2, d, torch.float32)
    assert name == "xmc_cross_attention_bwd" and p2.kernel == ca.BWD
    assert args[8:13] == (b, g, n, t2, d)
    assert args[34:] == (0, p2.dmax, p2.threads, p2.blocks, p2.smem, 0)
    assert ca.BACKWARD.launches == before + 3
