"""Fused text-conditioned modulation epilogue: the CUDA kernels and their plain versions.

Replaces ``xmc_gan_tpu/ops/pallas/fused_affine.py`` (``modulate_lrelu_pallas``
and ``double_modulate_lrelu_pallas``), and adds the backward that the Pallas
kernels never had.  The kernels are ``csrc/fused_affine.cu``, one source
templated on the number of chained modulations (1 or 2) and on the
activation type (fp32 or bf16); see its header for the design and the bounds.

Contract of both wrappers:

* ``x`` is an NCHW tensor in ``channels_last`` memory (memory order
  ``[B, H*W, C]``), fp32 or bf16; every modulation vector is ``[B, C]`` on the
  same device.  Anything else raises.
* Math is fp32 and the result is rounded once, on store, to ``x.dtype``; the
  output keeps ``x``'s shape and memory format.  (The JAX package's plain
  epilogue, ``ops/fused.py``, rounds the chain's intermediate to bf16 in bf16
  runs; the Pallas kernel and this port do not.)
* The backward saves ``x`` and the vectors, recomputes the chain's
  intermediate and returns ``dx`` in ``x.dtype`` and each vector's gradient,
  summed over H*W in fp32, in that vector's dtype.  Its kernel reads the
  vectors in their own dtype (fp32 or bf16) and sums into one zeroed fp32
  ``[2 * nmod, B, C]`` buffer, cast once to the vectors' dtype; ``dy`` is
  copied only when it is not channels_last already (``DY_COPIES`` counts
  those copies).
* The single form is differentiable twice: ``CONCEPT_NETD`` runs it inside
  D, and MAGP differentiates D's gradient (``create_graph=True``).  Its
  backward is itself a ``torch.autograd.Function`` (``_FusedAffineBwd``)
  whose forward is the backward launch above and whose backward is the
  double-backward kernel ``fused_affine_bwd2_*`` (``once_differentiable``):
  from the gradients ``(gx, gg, gb)`` arriving at ``(dx, dgamma, dbeta)``
  it gives ``g_dy = s*(gamma*gx + gg*x + gb)``, ``g_x = s*dy*gg``,
  ``g_gamma = sum_hw s*dy*gx`` and no ``beta`` gradient (``s``, the slope
  at ``gamma*x + beta``, is piecewise constant).  Without ``create_graph``
  nothing is recorded and the backward launch is the same.  The double form
  (G only) is differentiable once: its second derivative raises.
* One rule, ``plan_bwd``, names the backward kernel (``fused_affine_bwd_vec``,
  16 bytes a thread, or ``fused_affine_bwd_scalar``, one element) and its
  grid from the shape, the dtypes and the pointers, before any launch; the
  C entry refuses a launch that the named kernel does not take.  The
  double backward has only the vector kernel (``fused_affine_bwd2_vec``):
  it takes the same plan and raises where the plan names the scalar one.
* A CPU tensor goes to the plain versions below (in fp64 too, for
  ``gradgradcheck``); a CUDA tensor launches the
  kernels or raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary, LaunchCount

__all__ = [
    "KERNEL",
    "FORWARD",
    "BACKWARD",
    "DOUBLE_BACKWARD",
    "DY_COPIES",
    "BWD_VEC",
    "BWD_SCALAR",
    "BwdPlan",
    "plan_bwd",
    "bwd_kernel_name",
    "bwd2_kernel_name",
    "modulate_lrelu_kernel",
    "double_modulate_lrelu_kernel",
    "modulate_lrelu_ref",
    "double_modulate_lrelu_ref",
    "fused_affine_bwd_ref",
    "fused_affine_bwd2_ref",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# int xmc_fused_affine(x, out, g0, b0, g1, b1, B, HW, C, nmod, dtype, slope, stream)
# int xmc_fused_affine_bwd(x, dy, dx, g0, b0, g1, b1, sums, B, HW, C, nmod, dtype,
#                          vdtype, slope, kernel, threads, chunks, run, stream)
# int xmc_fused_affine_bwd2(x, dy, gx, g0, b0, gg, gb, g_dy, g_x, sums, B, HW, C, dtype,
#                           vdtype, slope, kernel, threads, chunks, run, stream)
KERNEL = CudaLibrary("fused_affine.cu", {
    "xmc_fused_affine": (_I, [_P] * 6 + [_L] * 3 + [_I, _I, ctypes.c_float, _P]),
    "xmc_fused_affine_bwd": (_I, [_P] * 8 + [_L] * 3 + [_I] * 3 + [ctypes.c_float, _I, _I]
                             + [_L] * 2 + [_P]),
    "xmc_fused_affine_bwd2": (_I, [_P] * 10 + [_L] * 3 + [_I] * 2 + [ctypes.c_float, _I, _I]
                              + [_L] * 2 + [_P]),
})
FORWARD = LaunchCount()
BACKWARD = LaunchCount()
DOUBLE_BACKWARD = LaunchCount()
# copies of dy (and of the double backward's incoming dx gradient) that the
# wrappers make, one kernel each, where a tensor is not x's dtype in
# channels_last memory
DY_COPIES = LaunchCount()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

BWD_VEC, BWD_SCALAR = "fused_affine_bwd_vec", "fused_affine_bwd_scalar"
_BWD_KERNEL_CODE = {BWD_VEC: 0, BWD_SCALAR: 1}
# csrc/fused_affine.cu: the vector kernel's widest block (kBwdThreads) and
# its steps a loop turn (kBwdUnroll); the scalar kernel's 32 x 8 block
_BWD_THREADS, _BWD_UNROLL = 256, 4
_SCALAR_COLS, _SCALAR_ROWS = 32, 8
# a launch aims at this many blocks a multiprocessor; the vector kernel's
# blocks keep at least this many loop turns a thread where H*W allows, so
# that a block's flush (one atomicAdd a value and channel) stays small
# beside its loads
_BWD_BLOCKS_PER_SM, _BWD_MIN_TURNS = 32, 4
_MAX_GRID_YZ = 65535


def _lrelu(y: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(y >= 0, y, slope * y)


def _math(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' compute type: fp32, or fp64 for fp64."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _ref(x: torch.Tensor, mods: tuple[torch.Tensor, ...], slope: float) -> torch.Tensor:
    y = _math(x)
    for g, b in zip(mods[::2], mods[1::2]):
        y = _lrelu(_math(g)[:, :, None, None] * y + _math(b)[:, :, None, None], slope)
    return y.to(x.dtype)


def modulate_lrelu_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch ``lrelu(gamma * x + beta)``, fp32 math, cast on store."""
    return _ref(x, (gamma, beta), slope)


def double_modulate_lrelu_ref(x: torch.Tensor, g0: torch.Tensor, b0: torch.Tensor,
                              g1: torch.Tensor, b1: torch.Tensor,
                              slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch ``lrelu(g1 * lrelu(g0 * x + b0) + b1)``, fp32 math, cast on store."""
    return _ref(x, (g0, b0, g1, b1), slope)


def fused_affine_bwd_ref(x: torch.Tensor, mods: tuple[torch.Tensor, ...], dy: torch.Tensor,
                         slope: float = 0.2) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch backward of the 1- or 2-modulation epilogue: ``(dx,
    dg0, db0[, dg1, db1])``, fp32 math, the vector gradients summed over H*W,
    each result in its input's dtype."""
    xf, dyf = _math(x), _math(dy)
    g = [_math(m)[:, :, None, None] for m in mods]
    y0 = g[0] * xf + g[1]
    da0 = dyf
    tail: tuple[torch.Tensor, ...] = ()
    if len(mods) == 4:
        a0 = _lrelu(y0, slope)
        d1 = torch.where(g[2] * a0 + g[3] >= 0, dyf, slope * dyf)
        tail = ((d1 * a0).sum((2, 3)), d1.sum((2, 3)))
        da0 = d1 * g[2]
    d0 = torch.where(y0 >= 0, da0, slope * da0)
    dx = (d0 * g[0]).to(x.dtype).contiguous(memory_format=torch.channels_last)
    sums = ((d0 * xf).sum((2, 3)), d0.sum((2, 3))) + tail
    return (dx, *(s.to(m.dtype) for s, m in zip(sums, mods)))


def fused_affine_bwd2_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          dy: torch.Tensor, gx: torch.Tensor, gg: torch.Tensor,
                          gb: torch.Tensor, slope: float = 0.2
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch double backward of the single form: given the gradients
    ``gx`` ``[B, C, H, W]``, ``gg``, ``gb`` ``[B, C]`` arriving at the
    backward's ``(dx, dgamma, dbeta)``, returns ``(g_x, g_dy, g_gamma)``:
    ``g_x = s*dy*gg``, ``g_dy = s*(gamma*gx + gg*x + gb)``, ``g_gamma =
    sum_hw s*dy*gx`` with ``s`` the slope at ``gamma*x + beta`` (1 where it
    is >= 0).  fp32 math (fp64 for fp64), ``g_x`` and ``g_dy`` in x's dtype
    and channels_last memory, ``g_gamma`` summed in the math type and cast
    to gamma's dtype."""
    xf, dyf, gxf = _math(x), _math(dy), _math(gx)
    g, b, ggf, gbf = (_math(m)[:, :, None, None] for m in (gamma, beta, gg, gb))
    pos = g * xf + b >= 0
    d = torch.where(pos, dyf, slope * dyf)  # s * dy
    a = g * gxf + ggf * xf + gbf
    g_dy = torch.where(pos, a, slope * a)
    cl = torch.channels_last
    return ((d * ggf).to(x.dtype).contiguous(memory_format=cl),
            g_dy.to(x.dtype).contiguous(memory_format=cl),
            (d * gxf).sum((2, 3)).to(gamma.dtype))


class BwdPlan(NamedTuple):
    """What one backward launch runs: the kernel, its threads a block, its
    grid (``fused_affine_bwd_vec``: ``(chunks, B, 1)``; ``_scalar``:
    ``(ceil(C / 32), chunks, B)``) and the pixels of one image a block
    walks (``run``)."""
    kernel: str
    threads: int
    grid: tuple[int, int, int]
    run: int

    @property
    def chunks(self) -> int:
        return self.grid[0] if self.kernel == BWD_VEC else self.grid[1]


def plan_bwd(B: int, HW: int, C: int, dtype: torch.dtype, vec_dtype: torch.dtype,
             ptrs: tuple[int, ...], sms: int) -> BwdPlan:
    """The one rule: which backward kernel a CUDA call at ``x [B, C, H, W]``
    (``HW = H * W``) of ``dtype`` with ``[B, C]`` vectors of ``vec_dtype``
    launches, and its grid, on a card of ``sms`` multiprocessors (the
    wrapper passes the card's count).  ``ptrs``
    are the addresses of x, dy and dx.  ``fused_affine_bwd_vec`` where C is
    a multiple of the 16-byte width (4 fp32 or 8 bf16 channels), a pixel is
    at most 256 such chunks and every pointer is 16-byte aligned; else
    ``fused_affine_bwd_scalar``.  Raises for a shape that no kernel takes."""
    if dtype not in _DTYPE_CODE or vec_dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_affine backward takes float32 or bfloat16 x and vectors, got "
                        f"{dtype}, {vec_dtype}")
    if min(B, HW, C) < 1 or B > _MAX_GRID_YZ or HW >= 2**29:
        raise ValueError(f"fused_affine backward takes 1 <= B <= {_MAX_GRID_YZ}, 1 <= H*W < "
                         f"2^29 and C >= 1, got B={B}, H*W={HW}, C={C}")
    width = 16 // torch.empty((), dtype=dtype).element_size()
    target = sms * _BWD_BLOCKS_PER_SM
    if C % width == 0 and C // width <= _BWD_THREADS and all(p % 16 == 0 for p in ptrs):
        chunk_threads = C // width  # L: threads a pixel
        rows = _BWD_THREADS // chunk_threads  # P: pixels a block steps at once
        chunks = max(1, min(math.ceil(target / B), HW // (rows * _BWD_UNROLL * _BWD_MIN_TURNS)))
        run = math.ceil(math.ceil(HW / chunks) / rows) * rows
        return BwdPlan(BWD_VEC, rows * chunk_threads, (math.ceil(HW / run), B, 1), run)
    ctiles = math.ceil(C / _SCALAR_COLS)
    chunks = math.ceil(target / (B * ctiles))
    run = math.ceil(math.ceil(HW / chunks) / _SCALAR_ROWS) * _SCALAR_ROWS
    return BwdPlan(BWD_SCALAR, _SCALAR_COLS * _SCALAR_ROWS, (ctiles, math.ceil(HW / run), B),
                   run)


_CTYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}


def bwd_kernel_name(p: BwdPlan, dtype: torch.dtype, vec_dtype: torch.dtype, nmod: int) -> str:
    """The planned backward kernel as the profiler names its template instance."""
    return f"{p.kernel}<{_CTYPE[dtype]}, {_CTYPE[vec_dtype]}, {nmod}>"


def bwd2_kernel_name(p: BwdPlan, dtype: torch.dtype, vec_dtype: torch.dtype) -> str:
    """The double-backward kernel that plan ``p`` launches, as the profiler
    names it.  Raises where ``p`` names the scalar backward kernel: the
    double backward has only ``fused_affine_bwd2_vec``."""
    if p.kernel != BWD_VEC:
        width = 16 // torch.empty((), dtype=dtype).element_size()
        raise ValueError(
            f"fused_affine double backward takes only C a multiple of {width} ({dtype}), at "
            f"most {_BWD_THREADS * width} channels, and x, dy, gx, g_dy and g_x 16-byte "
            f"aligned; this call's plan is {p}")
    return f"fused_affine_bwd2_vec<{_CTYPE[dtype]}, {_CTYPE[vec_dtype]}>"


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, mods: tuple[torch.Tensor, ...]) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE and not (x.dtype == torch.float64 and x.device.type == "cpu"):
        raise TypeError(f"x must be float32 or bfloat16 (float64 on the CPU), got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in channels_last memory format")
    b, c = x.shape[:2]
    for t in mods:
        if t.shape != (b, c):
            raise ValueError(f"modulation vectors must be [B, C] = {[b, c]}, got {list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"modulation vector on {t.device}, x on {x.device}")
        if not t.is_floating_point():
            raise TypeError(f"modulation vectors must be floating point, got {t.dtype}")


def _launch(x: torch.Tensor, mods: tuple[torch.Tensor, ...], slope: float) -> torch.Tensor:
    fn = KERNEL.load().xmc_fused_affine
    nmod = len(mods) // 2
    vecs = [m.float().contiguous() for m in mods]
    if nmod == 1:
        vecs += vecs  # g1/b1 are not read when nmod == 1
    out = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), *[v.data_ptr() for v in vecs],
                b, h * w, c, nmod, _DTYPE_CODE[x.dtype], slope, stream)
    if rc != 0:
        raise RuntimeError(f"fused_affine launch failed: CUDA error {rc}")
    FORWARD.launches += 1
    return out


def _like_x(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in x's dtype and channels_last memory, copied (and counted in
    ``DY_COPIES``) only where it is not so already."""
    if t.dtype != x.dtype or not t.is_contiguous(memory_format=torch.channels_last):
        t = t.to(x.dtype).contiguous(memory_format=torch.channels_last)
        DY_COPIES.launches += 1
    return t


def _same_dtype(vecs: tuple[torch.Tensor, ...]) -> tuple[tuple[torch.Tensor, ...], torch.dtype]:
    """The [B, C] vectors as the kernels read them: all in one of their
    types (fp32 or bf16), else all cast to fp32."""
    vdt = vecs[0].dtype
    if vdt not in _DTYPE_CODE or any(v.dtype != vdt for v in vecs):
        vecs, vdt = tuple(v.float() for v in vecs), torch.float32
    return tuple(v.contiguous() for v in vecs), vdt


def _launch_bwd_sums(x: torch.Tensor, mods: tuple[torch.Tensor, ...], dy: torch.Tensor,
                     slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The planned backward kernel: ``(dx, sums)``, ``sums`` the fp32
    ``[2 * nmod, B, C]`` buffer (dg0, db0[, dg1, db1]) it adds into."""
    fn = KERNEL.load().xmc_fused_affine_bwd
    nmod = len(mods) // 2
    mods, vdt = _same_dtype(mods)
    vecs = list(mods)
    if nmod == 1:
        vecs += vecs  # g1/b1 are not read when nmod == 1
    dy = _like_x(dy, x)
    dx = torch.empty_like(x)
    b, c, h, w = x.shape
    p = plan_bwd(b, h * w, c, x.dtype, vdt, (x.data_ptr(), dy.data_ptr(), dx.data_ptr()),
                 _multiprocessors(x.device.index))
    sums = torch.zeros((2 * nmod, b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *[v.data_ptr() for v in vecs],
                sums.data_ptr(), b, h * w, c, nmod, _DTYPE_CODE[x.dtype], _DTYPE_CODE[vdt],
                slope, _BWD_KERNEL_CODE[p.kernel], p.threads, p.chunks, p.run, stream)
    if rc != 0:
        raise RuntimeError(f"fused_affine backward launch failed ({p}): CUDA error {rc}")
    BACKWARD.launches += 1
    return dx, sums


def _launch_bwd(x: torch.Tensor, mods: tuple[torch.Tensor, ...], dy: torch.Tensor,
                slope: float) -> tuple[torch.Tensor, ...]:
    """``(dx, dg0, db0[, dg1, db1])``: the planned kernel, then one cast of
    its sums to the vectors' dtype (none for fp32 vectors)."""
    dx, sums = _launch_bwd_sums(x, mods, dy, slope)
    if len({m.dtype for m in mods}) == 1:
        sums = sums.to(mods[0].dtype)
    return (dx, *(s.to(m.dtype) for s, m in zip(sums.unbind(0), mods)))


def _launch_bwd2(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, dy: torch.Tensor,
                 gx: torch.Tensor, gg: torch.Tensor, gb: torch.Tensor, slope: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The double-backward kernel of the single form: ``(g_x, g_dy,
    g_gamma)`` as ``fused_affine_bwd2_ref`` gives them, on the grid
    ``plan_bwd`` names for x's shape and pointers.  Raises, before any
    launch, where that plan is not the vector kernel's (``bwd2_kernel_name``)."""
    fn = KERNEL.load().xmc_fused_affine_bwd2
    (gamma, beta, gg, gb), vdt = _same_dtype((gamma, beta, gg, gb))
    dy, gx = _like_x(dy, x), _like_x(gx, x)
    g_dy, g_x = torch.empty_like(x), torch.empty_like(x)
    b, c, h, w = x.shape
    ptrs = tuple(t.data_ptr() for t in (x, dy, gx, g_dy, g_x))
    p = plan_bwd(b, h * w, c, x.dtype, vdt, ptrs, _multiprocessors(x.device.index))
    bwd2_kernel_name(p, x.dtype, vdt)
    sums = torch.zeros((b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*ptrs[:3], gamma.data_ptr(), beta.data_ptr(), gg.data_ptr(), gb.data_ptr(),
                *ptrs[3:], sums.data_ptr(), b, h * w, c, _DTYPE_CODE[x.dtype], _DTYPE_CODE[vdt],
                slope, _BWD_KERNEL_CODE[p.kernel], p.threads, p.chunks, p.run, stream)
    if rc != 0:
        raise RuntimeError(f"fused_affine double backward launch failed ({p}): CUDA error {rc}")
    DOUBLE_BACKWARD.launches += 1
    return g_x, g_dy, sums.to(vdt)


class _FusedAffineBwd(torch.autograd.Function):
    """The epilogue's backward as a function of ``(x, dy, *mods)``: its
    forward is the backward launch (or the plain version on the CPU), its
    backward the double-backward kernel of the single form."""

    @staticmethod
    def forward(ctx, slope, x, dy, *mods):
        ctx.save_for_backward(x, dy, *mods)
        ctx.slope = slope
        if x.device.type == "cpu":
            return fused_affine_bwd_ref(x, mods, dy, slope)
        return _launch_bwd(x, mods, dy, slope)

    @staticmethod
    @once_differentiable
    def backward(ctx, gx, *gmods):
        x, dy, *mods = ctx.saved_tensors
        if len(mods) != 2:
            raise NotImplementedError(
                "fused_affine: cannot differentiate twice the double form (two chained "
                "modulations); only the single form has a double backward (MAGP through "
                "CONCEPT_NETD)")
        gamma, beta = mods
        if x.device.type == "cpu":
            g_x, g_dy, g_gamma = fused_affine_bwd2_ref(x, gamma, beta, dy, gx, *gmods,
                                                       ctx.slope)
        else:
            g_x, g_dy, g_gamma = _launch_bwd2(x, gamma, beta, dy, gx, *gmods, ctx.slope)
        return None, g_x, g_dy, g_gamma.to(gamma.dtype), None


class _FusedAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope, *mods):
        ctx.save_for_backward(x, *mods)
        ctx.slope = slope
        if x.device.type == "cpu":
            return _ref(x, mods, slope)
        return _launch(x, mods, slope)

    @staticmethod
    def backward(ctx, dy):
        x, *mods = ctx.saved_tensors
        grads = _FusedAffineBwd.apply(ctx.slope, x, dy, *mods)
        return (grads[0], None, *grads[1:])


def _dispatch(x: torch.Tensor, mods: tuple[torch.Tensor, ...], slope: float) -> torch.Tensor:
    _check(x, mods)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_affine runs on CUDA or CPU tensors, got {x.device}")
    return _FusedAffine.apply(x, float(slope), *mods)


def modulate_lrelu_kernel(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          slope: float = 0.2) -> torch.Tensor:
    """``lrelu(gamma * x + beta)``: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    return _dispatch(x, (gamma, beta), slope)


def double_modulate_lrelu_kernel(x: torch.Tensor, g0: torch.Tensor, b0: torch.Tensor,
                                 g1: torch.Tensor, b1: torch.Tensor,
                                 slope: float = 0.2) -> torch.Tensor:
    """``lrelu(g1 * lrelu(g0 * x + b0) + b1)``: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return _dispatch(x, (g0, b0, g1, b1), slope)
