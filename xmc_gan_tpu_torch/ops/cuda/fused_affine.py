"""Fused text-conditioned modulation epilogue: the CUDA kernel and its plain version.

Replaces ``xmc_gan_tpu/ops/pallas/fused_affine.py`` (``modulate_lrelu_pallas``
and ``double_modulate_lrelu_pallas``).  The kernel is ``csrc/fused_affine.cu``,
one source templated on the number of chained modulations (1 or 2) and on the
activation type (fp32 or bf16); see its header for the design and the bound.

Contract of both wrappers:

* ``x`` is an NCHW tensor in ``channels_last`` memory (memory order
  ``[B, H*W, C]``), fp32 or bf16; every modulation vector is ``[B, C]`` on the
  same device.  Anything else raises.
* Math is fp32 and the result is rounded once, on store, to ``x.dtype``; the
  output keeps ``x``'s shape and memory format.  (The JAX package's plain
  epilogue, ``ops/fused.py``, rounds the chain's intermediate to bf16 in bf16
  runs; the Pallas kernel and this port do not.)
* A CPU tensor goes to the plain version below; a CUDA tensor launches the
  kernel or raises.  There is no fallback from one to the other.
* No gradient yet: an input that requires grad while grad mode is on raises
  ``NotImplementedError`` (the backward kernel comes with the training slice).
"""

from __future__ import annotations

import ctypes

import torch

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary

__all__ = [
    "KERNEL",
    "modulate_lrelu_kernel",
    "double_modulate_lrelu_kernel",
    "modulate_lrelu_ref",
    "double_modulate_lrelu_ref",
]

# int xmc_fused_affine(x, out, g0, b0, g1, b1, B, HW, C, nmod, dtype, slope, stream)
KERNEL = CudaLibrary("fused_affine.cu", {"xmc_fused_affine": (
    ctypes.c_int,
    [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
)})

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


def _check(x: torch.Tensor, mods: tuple[torch.Tensor, ...]) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *mods)):
        raise NotImplementedError(
            "fused_affine has no backward yet (it comes with the training slice); "
            "call it under torch.no_grad() or torch.inference_mode()"
        )
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
    if x.device.type != "cuda":
        raise ValueError(f"fused_affine runs on CUDA or CPU tensors, got {x.device}")
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
    KERNEL.launches += 1
    return out


def _dispatch(x: torch.Tensor, mods: tuple[torch.Tensor, ...], slope: float) -> torch.Tensor:
    _check(x, mods)
    if x.device.type == "cpu":
        return _ref(x, mods, slope)
    return _launch(x, mods, slope)


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
