"""Masked cross-attention: the CUDA kernel and its plain version.

Replaces ``xmc_gan_tpu/ops/pallas/cross_attention.py`` (``masked_cross_attention``,
``pallas_call`` at ``:131``, kernel ``_attn_kernel`` ``:43-83``).  The kernel
is ``csrc/cross_attention.cu``; its header gives the design and the bound::

    ctx[..., n, :] = sum_t softmax_t(scale * q[..., n, :] . k[..., t, :], padded t -> -inf) v[..., t, :]

Contract of ``masked_cross_attention_kernel``:

* ``q`` is ``[B, N, D]`` or ``[B, G, N, D]``; ``k`` and ``v`` are ``[B, T, D]``
  or ``[B, G, T, D]`` with the same leading dims; ``mask`` is ``[B, T]``
  (True = padded word), shared by the ``G`` groups of a row.  ``q``, ``k`` and
  ``v`` share one ``D`` (at most 256) and one type, fp32 or bf16.  Anything
  else raises.
* Math is fp32 inside whatever the type, with one rounding on store; the
  result has ``q``'s shape and type and is contiguous.
* A fully padded row gives 0, as the Pallas kernel gives it
  (``acc / max(l, 1e-30)``, ``:83``), not the NaN of the JAX XLA branch's
  dense softmax (``:110-116``).
* Strided operands, no copy: ``q``, ``k`` and ``v`` may be any strided views
  whose last dimension is dense (stride 1).  The concept generators hand over
  their grouped queries, which lie as ``[B, HW, G, D]`` in memory, as the
  ``[B, G, HW, D]`` view (an n-stride of ``G * D``); the kernel reads them in
  place.  An operand whose last stride is not 1 is copied first.
* Forward only (the Pallas kernel has no backward either).  On CUDA, an
  operand that requires grad while autograd is on raises
  ``NotImplementedError``: nothing returns an output silently detached.
* A CPU tensor goes to the plain version below; a CUDA tensor launches the
  kernel or raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary, LaunchCount

__all__ = ["KERNEL", "FORWARD", "MAX_D", "masked_cross_attention_kernel",
           "masked_cross_attention_ref"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# int xmc_cross_attention(q, k, v, mask, out, B, G, N, T, D, qsb, qsg, qsn,
#                         ksb, ksg, kst, vsb, vsg, vst, osb, osg, osn, scale, dtype, stream)
KERNEL = CudaLibrary("cross_attention.cu", {
    "xmc_cross_attention": (_I, [_P] * 5 + [_I] * 5 + [_L] * 12
                            + [ctypes.c_float, _I, _P]),
})
FORWARD = LaunchCount()
MAX_D = 256  # csrc/cross_attention.cu kMaxD

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mask_view(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """``[B, T]`` -> ``[B, 1, (1,) T]``, broadcast over the groups and queries."""
    return mask.bool().reshape(mask.shape[0], *([1] * (ndim - 2)), mask.shape[1])


def masked_cross_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: the JAX XLA branch (``cross_attention.py:110-116``:
    einsum, masked fill, softmax, einsum) in fp32, cast to ``q``'s type on
    store, except that a fully padded row gives 0 (the Pallas kernel's
    result) where the dense softmax gives NaN."""
    pad = _mask_view(mask, q.dim())
    s = torch.einsum("...nd,...td->...nt", q.float(), k.float()) * scale
    s = s.masked_fill(pad, float("-inf"))
    p = torch.softmax(s, dim=-1).masked_fill(pad.all(dim=-1, keepdim=True), 0.0)
    return torch.einsum("...nt,...td->...nd", p, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> None:
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"want q [B, (G,) N, D] and k, v [B, (G,) T, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != k.shape[-1] or q.shape[-1] != v.shape[-1]:
        raise ValueError(f"q, k and v must share one D, got {q.shape[-1]}, {k.shape[-1]}, "
                         f"{v.shape[-1]}")
    if not 1 <= q.shape[-1] <= MAX_D:
        raise ValueError(f"masked_cross_attention takes 1 <= D <= {MAX_D}, got {q.shape[-1]}")
    if k.shape != v.shape or q.shape[:-2] != k.shape[:-2]:
        raise ValueError(f"k and v must be [{', '.join(map(str, q.shape[:-2]))}, T, D], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(mask.shape) != (q.shape[0], k.shape[-2]):
        raise ValueError(f"mask must be [B, T] = {[q.shape[0], k.shape[-2]]}, "
                         f"got {list(mask.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be one of float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}, {mask.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_cross_attention runs on CUDA or CPU tensors, got {q.device}")


def _as4(t: torch.Tensor) -> torch.Tensor:
    t = t if t.dim() == 4 else t.unsqueeze(1)
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
            scale: float) -> torch.Tensor:
    q4, k4, v4 = _as4(q), _as4(k), _as4(v)
    b, g, n, d = q4.shape
    t = k4.shape[2]
    out = torch.empty((b, g, n, d), device=q.device, dtype=q.dtype)
    # a bool tensor's bytes are the kernel's uint8 mask (1 = padded): no conversion launch
    m = (mask if mask.dtype in (torch.bool, torch.uint8) else mask.to(torch.uint8)).contiguous()
    fn = KERNEL.load().xmc_cross_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), m.data_ptr(), out.data_ptr(),
                b, g, n, t, d, *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
                *out.stride()[:3], scale, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cross_attention launch failed: CUDA error {rc}")
    FORWARD.launches += 1
    return out.view(q.shape)


def masked_cross_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Masked cross-attention (see the module docstring): the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return masked_cross_attention_ref(q, k, v, mask, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "masked_cross_attention has no backward (the Pallas kernel has none); the "
            "attention kernel's backward comes with the concept training slice")
    return _launch(q, k, v, mask, float(scale))
