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
# block's (G = 1: [B, 16, 4] states), a ragged D = 12 one and T = 200; then
# captions past 256 words (``attn_bwd_long``'s on the card): the In shape as
# planes at T = 300, the Out shape with a one-word caption, and T = 600 at a
# ragged D = 12; every caption has a real word (the JAX chain gives NaN for
# one that has none)
VJP_CASES = [(2, 16, 64, 15, 4, "rows", [15, 3]), (2, 16, 64, 15, 4, "planes", [1, 9]),
             (4, 1, 16, 15, 4, "dense", [15, 1, 7, 4]), (3, 2, 37, 33, 12, "dense", [33, 5, 20]),
             (2, 1, 16, 200, 4, "dense", [200, 31]), (2, 16, 64, 300, 4, "planes", [300, 120]),
             (2, 1, 16, 300, 4, "dense", [300, 1]), (2, 2, 37, 600, 12, "dense", [600, 33])]


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
                                   (2, 1, 100, 256, 32), (7, 3, 1, 20, 2), (88, 16, 4096, 300, 4),
                                   (2, 3, 50, 4096, 32)])
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
                                           (300, 33, ValueError, "D <= 32"),
                                           (15, 4, TypeError, "float32 or bfloat16")])
def test_plan_bwd_refuses_what_the_kernel_does_not_take(t, d, err, match):
    dtype = torch.float16 if err is TypeError else torch.float32
    with pytest.raises(err, match=match):
        ca.plan_bwd(2, 1, 8, t, d, dtype)


@pytest.mark.parametrize("t,d", [(15, 4), (300, 4), (4096, 32)])
def test_plan_bwd_refuses_a_grid_past_its_limit(t, d):
    """One block per (b, g) row: B * G past 2^31 - 1 raises before any
    launch, at every caption length (also where the long kernel's scratch
    would be planned)."""
    with pytest.raises(ValueError, match="grid limit"):
        ca.plan_bwd(2**16, 2**15, 8, t, d, torch.float32)
    assert ca.plan_bwd(2**16, 2**15 - 1, 8, t, d, torch.float32).blocks == 2**31 - 2**16


# ------------------------------------------------------- past 256 words


def _long_tiles(dmax, threads):
    """``attn_bwd_long``'s shared memory but its sums (csrc
    ``long_smem_tiles``): the 64-word tile's keys and values, the
    [64][threads + 1] P and dS, the [DMAX][threads + 1] q and dO, 64 pad
    flags."""
    return 4 * (2 * 64 * dmax + 2 * (64 + dmax) * (threads + 1) + 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d,dmax", [(4, 4), (12, 16), (32, 32)])
@pytest.mark.parametrize("t", [257, 300, 512, 4096])
def test_plan_bwd_names_the_long_kernel_past_256_words(t, d, dmax, dtype):
    """``attn_bwd_long`` past 256 words at every D <= 32, in both types: one
    block per (b, g), 128-query tiles at N = 4,096, its template's DMAX;
    dk's and dv's fp32 sums (8 T DMAX bytes a block) in shared memory where
    they fit beside the tiles within 227 KB, else a scratch of B G times
    that, and then only the tiles in shared memory."""
    p = ca.plan_bwd(88, 16, 4096, t, d, dtype)
    assert (p.kernel, p.dmax, p.tmax, p.threads, p.blocks) == (ca.BWD_LONG, dmax, 0, 128,
                                                               88 * 16)
    sums = 8 * t * dmax
    if _long_tiles(dmax, 128) + sums <= 232448:
        assert (p.smem, p.scratch) == (_long_tiles(dmax, 128) + sums, 0)
    else:
        assert (p.smem, p.scratch) == (_long_tiles(dmax, 128), 88 * 16 * sums)
    assert p.smem <= 232448
    t_name = "float" if dtype == torch.float32 else "__nv_bfloat16"
    assert ca.bwd_kernel_name(p, dtype) == f"attn_bwd_long<{t_name}, {dmax}>"


@pytest.mark.parametrize("t,d,shared", [(300, 4, True), (4999, 4, True), (5000, 4, False),
                                        (300, 32, True), (456, 32, True), (457, 32, False),
                                        (512, 16, True), (4096, 12, False)])
def test_plan_bwd_long_keeps_its_sums_on_chip_where_they_fit(t, d, shared):
    """Where the sums go: shared memory up to 227 KB a block (with 128-query
    tiles: T <= 4,999 at D <= 4, 456 at D = 32), the scratch past it."""
    p = ca.plan_bwd(88, 16, 4096, t, d, torch.float32)
    assert (p.scratch == 0) == shared
    assert (p.smem == 232448) == (t in (4999, 456))


@pytest.mark.parametrize("n,threads", [(1, 32), (32, 32), (33, 64), (96, 96), (97, 128),
                                       (128, 128), (4097, 128), (0, 32)])
def test_plan_bwd_long_tile_over_n(n, threads):
    """The long kernel's query tile: N rounded up to a warp, at most 128;
    its shared memory follows the tile."""
    p = ca.plan_bwd(3, 16, n, 300, 4, torch.bfloat16)
    assert (p.kernel, p.threads, p.blocks) == (ca.BWD_LONG, threads, 48)
    assert p.smem == _long_tiles(4, threads) + 8 * 300 * 4 and p.scratch == 0


@pytest.mark.parametrize("t,d", [(256, 4), (256, 32), (200, 4), (32, 4), (33, 4)])
def test_plan_bwd_up_to_256_words_is_unchanged(t, d):
    """Up to 256 words the plans are those of ``attn_bwd_warp`` and
    ``attn_bwd`` as before the long kernel (the formulas written out)."""
    p = ca.plan_bwd(88, 16, 4096, t, d, torch.float32)
    if t <= 32 and d <= 4:
        assert p == ca.BwdPlan(ca.BWD_WARP, 4, 32, 64, 1408, _warp_smem(32, 2))
        return
    dmax = 4 if d <= 4 else 32
    tile = 256 if t <= 32 else 128 if t <= 64 else 64 if t <= 128 else 32
    assert p == ca.BwdPlan(ca.BWD, dmax, 0, tile, 1408,
                           4 * (4 * t * dmax + 2 * (t + dmax) * (tile + 1)) + 8 * t, 0)


def test_long_backward_launch_hands_the_entry_the_plan(monkeypatch):
    """Past 256 words ``_launch_bwd`` calls the long kernel's entry (the
    library faked): the operands as they are (q as planes, the keys'
    d-stride T), then a scratch pointer, NULL where the plan keeps the sums
    in shared memory, else a float32 buffer of the plan's bytes on q's
    device; the plan's geometry; one count a launch."""
    calls = []

    class Lib:
        @staticmethod
        def xmc_cross_attention_bwd_long(*args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    allocs = []
    empty = torch.empty

    def spy_empty(*shape, **kw):
        out = empty(*shape, **kw)
        allocs.append((out.data_ptr(), out.numel(), out.dtype))
        return out

    monkeypatch.setattr(ca.KERNEL, "load", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream)
    monkeypatch.setattr(torch, "empty", spy_empty)
    before = ca.BACKWARD.launches
    for b, g, n, t, d in ((2, 16, 200, 300, 4), (2, 2, 40, 1000, 32)):
        q = torch.randn(b, g, d, n).transpose(2, 3)  # planes
        k = torch.randn(b, g, d, t).transpose(2, 3)  # [B, G, D, T] in memory
        dout = torch.randn(b, g, n, d)
        mask = torch.zeros(b, t, dtype=torch.bool)
        dq, dk, dv = ca._launch_bwd(q, k, k, mask, dout, 0.5)
        p = ca.plan_bwd(b, g, n, t, d, torch.float32)
        args = calls[-1]
        assert p.kernel == ca.BWD_LONG
        assert args[0] == q.data_ptr() and args[1] == args[2] == k.data_ptr()
        assert args[5:8] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        if p.scratch:
            assert allocs[-1] == (args[8], p.scratch // 4, torch.float32)
        else:
            assert args[8] is None
        assert args[9:14] == (b, g, n, t, d)
        assert args[14:18] == q.stride() and args[18:22] == k.stride() == args[22:26]
        assert args[26:30] == dout.stride() and args[30:34] == dq.stride() == q.stride()
        assert args[34] == 0.5 and args[35:] == (0, p.dmax, p.threads, p.blocks, p.smem, 0)
        assert dk.shape == dv.shape == k.shape and dk.is_contiguous() and dv.is_contiguous()
    assert [bool(ca.plan_bwd(2, 16, 200, 300, 4, torch.float32).scratch),
            bool(ca.plan_bwd(2, 2, 40, 1000, 32, torch.float32).scratch)] == [False, True]
    assert ca.BACKWARD.launches == before + 2


@pytest.mark.parametrize("t", [257, 300, 600])
def test_wrapper_plans_the_long_backward_before_any_launch(monkeypatch, t):
    """Under grad on CUDA the wrapper asks ``plan_bwd`` before the forward
    launch: past 256 words it now plans the long kernel (no raise), and at
    D > 32 it still raises before any launch (the device and library faked:
    nothing launches)."""
    planned = []
    real = ca.plan_bwd
    monkeypatch.setattr(ca, "plan_bwd", lambda *a: planned.append(real(*a)) or planned[-1])
    monkeypatch.setattr(ca._MaskedCrossAttention, "apply", lambda *a: "launched")
    q = torch.randn(2, 16, 64, 4, requires_grad=True)
    k = torch.randn(2, 16, t, 4)
    mask = torch.zeros(2, t, dtype=torch.bool)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    assert ca.masked_cross_attention_kernel(q, k, k, mask) == "launched"
    assert planned[-1].kernel == ca.BWD_LONG
    wide = torch.randn(2, 16, 64, 40, requires_grad=True)
    with pytest.raises(ValueError, match="D <= 32"):
        ca.masked_cross_attention_kernel(wide, torch.randn(2, 16, t, 40),
                                         torch.randn(2, 16, t, 40), mask)


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
