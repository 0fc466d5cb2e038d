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
* Differentiable once (a ``torch.autograd.Function``, ``once_differentiable``:
  only G runs the epilogue, and the gradient penalty differentiates D
  alone).  The backward saves ``x`` and the vectors, recomputes the chain's
  intermediate and returns ``dx`` in ``x.dtype`` and each vector's gradient,
  summed over H*W in fp32, in that vector's dtype.
* A CPU tensor goes to the plain versions below; a CUDA tensor launches the
  kernels or raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary, LaunchCount

__all__ = [
    "KERNEL",
    "FORWARD",
    "BACKWARD",
    "modulate_lrelu_kernel",
    "double_modulate_lrelu_kernel",
    "modulate_lrelu_ref",
    "double_modulate_lrelu_ref",
    "fused_affine_bwd_ref",
]

_TAIL = [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# int xmc_fused_affine(x, out, g0, b0, g1, b1, B, HW, C, nmod, dtype, slope, stream)
# int xmc_fused_affine_bwd(x, dy, dx, g0, b0, g1, b1, dg0, db0, dg1, db1,
#                          B, HW, C, nmod, dtype, slope, stream)
KERNEL = CudaLibrary("fused_affine.cu", {
    "xmc_fused_affine": (ctypes.c_int, [ctypes.c_void_p] * 6 + _TAIL),
    "xmc_fused_affine_bwd": (ctypes.c_int, [ctypes.c_void_p] * 11 + _TAIL),
})
FORWARD = LaunchCount()
BACKWARD = LaunchCount()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lrelu(y: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(y >= 0, y, slope * y)


def _ref(x: torch.Tensor, mods: tuple[torch.Tensor, ...], slope: float) -> torch.Tensor:
    y = x.float()
    for g, b in zip(mods[::2], mods[1::2]):
        y = _lrelu(g.float()[:, :, None, None] * y + b.float()[:, :, None, None], slope)
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
    xf, dyf = x.float(), dy.float()
    g = [m.float()[:, :, None, None] for m in mods]
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


def _check(x: torch.Tensor, mods: tuple[torch.Tensor, ...]) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
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


def _launch_bwd(x: torch.Tensor, mods: tuple[torch.Tensor, ...], dy: torch.Tensor,
                slope: float) -> tuple[torch.Tensor, ...]:
    fn = KERNEL.load().xmc_fused_affine_bwd
    nmod = len(mods) // 2
    vecs = [m.float().contiguous() for m in mods]
    sums = [torch.zeros(m.shape, device=x.device, dtype=torch.float32) for m in mods]
    if nmod == 1:  # g1/b1 and their sums are not touched when nmod == 1
        vecs, sums = vecs + vecs, sums + sums
    dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *[v.data_ptr() for v in vecs],
                *[t.data_ptr() for t in sums], b, h * w, c, nmod, _DTYPE_CODE[x.dtype], slope,
                stream)
    if rc != 0:
        raise RuntimeError(f"fused_affine backward launch failed: CUDA error {rc}")
    BACKWARD.launches += 1
    return (dx, *(t.to(m.dtype) for t, m in zip(sums, mods)))


class _FusedAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope, *mods):
        ctx.save_for_backward(x, *mods)
        ctx.slope = slope
        if x.device.type == "cpu":
            return _ref(x, mods, slope)
        return _launch(x, mods, slope)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, *mods = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = fused_affine_bwd_ref(x, tuple(mods), dy, ctx.slope)
        else:
            grads = _launch_bwd(x, tuple(mods), dy, ctx.slope)
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
