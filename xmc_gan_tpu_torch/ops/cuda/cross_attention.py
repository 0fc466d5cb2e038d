"""Masked cross-attention: the CUDA kernels, their plan and their plain version.

Replaces ``xmc_gan_tpu/ops/pallas/cross_attention.py`` (``masked_cross_attention``,
``pallas_call`` at ``:131``, kernel ``_attn_kernel`` ``:43-83``).  The kernels
are in ``csrc/cross_attention.cu``; its header gives their design and bound::

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
* Strided operands, no copy where the planned kernel reads them in place.
  The In sampler hands over its queries as a ``[B, G, HW, D]`` view: of the
  channels_last query map's ``[B, HW, G, D]`` rows (an n-stride of
  ``G * D``), or, after the GroupNorm of GEN.NORMALIZE on CUDA (which
  returns NCHW), of its ``[B, G, D, HW]`` planes (an n-stride of 1); its
  keys as a ``[B, G, D, T]`` view.  ``attn_grouped`` reads all of them
  where they are.  For ``attn_small`` and ``attn_wide`` an operand whose
  last stride is not 1 is copied first.
* One rule, ``plan``, names the kernel a CUDA call launches and its launch
  geometry from the shapes, q's strides and address, and the type, before
  any launch; the C entry refuses a launch that its kernel does not take.
* Forward only (the Pallas kernel has no backward either).  On CUDA, an
  operand that requires grad while autograd is on raises
  ``NotImplementedError``: nothing returns an output silently detached.
* A CPU tensor goes to the plain version below; a CUDA tensor launches the
  planned kernel or raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary, LaunchCount

__all__ = ["KERNEL", "FORWARD", "MAX_D", "GROUPED", "SMALL", "WIDE", "Plan", "plan",
           "plan_for", "kernel_name", "masked_cross_attention_kernel",
           "masked_cross_attention_ref"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# int xmc_cross_attention(q, k, v, mask, out, B, G, N, T, D, qsb, qsg, qsn, qsd,
#                         ksb, ksg, kst, ksd, vsb, vsg, vst, vsd, osb, osg, osn, scale,
#                         dtype, kernel, layout, threads, blocks, tile, tiles_per_block, stream)
KERNEL = CudaLibrary("cross_attention.cu", {
    "xmc_cross_attention": (_I, [_P] * 5 + [_I] * 5 + [_L] * 15
                            + [ctypes.c_float] + [_I] * 7 + [_P]),
})
FORWARD = LaunchCount()
MAX_D = 256  # csrc/cross_attention.cu kMaxD

SMALL, WIDE, GROUPED = "attn_small", "attn_wide", "attn_grouped"
_KERNEL_CODE = {SMALL: 0, WIDE: 1, GROUPED: 2}
# csrc/cross_attention.cu: attn_small's and attn_wide's block shapes
_SMALL_THREADS, _WIDE_WARPS = 128, 8
# attn_grouped (kGrouped*, Chunk<T>::kQueries): its block, the bytes of q a
# tile, the queries a thread takes at once by element size, the longest
# caption and the widest grouping it holds
_GROUPED_THREADS, _GROUPED_TILE_BYTES, _GROUPED_QUERIES = 256, 16384, {4: 2, 2: 4}
_GROUPED_MAX_T, _GROUPED_MAX_G = 32, 32
# attn_grouped's launch: at most this many tiles a block, and fewer where the
# launch would otherwise have under this many blocks (~8 a multiprocessor)
_GROUPED_MAX_TILES, _GROUPED_MIN_BLOCKS = 16, 1024
_MAX_GRID = 2**31 - 1


class Plan(NamedTuple):
    """What one CUDA call launches: the kernel, q's layout for
    ``attn_grouped`` (``planes``: n contiguous for each (g, d); else each
    query's G rows contiguous; False for the others) and the geometry
    (``tile``: the queries of a block, or of a tile that a block of
    ``attn_grouped`` walks ``tiles_per_block`` of)."""
    kernel: str
    planes: bool
    threads: int
    blocks: int
    tile: int
    tiles_per_block: int


def _grouped_layout(B: int, G: int, N: int, T: int, D: int, q_strides, es: int,
                    q_ptr: int) -> str | None:
    """``attn_grouped``'s precondition (``csrc/cross_attention.cu`` header):
    D = 4, 1 <= T <= 32, G a power of two in 2..32, q's address 16-byte
    aligned, and q laid out as rows (strides ``(., D, G*D, 1)``) or as planes
    (``(., qsg, 1, qsd)``), its b, g and d strides multiples of 16 bytes.
    Returns "rows", "planes" or None."""
    sb, sg, sn, sd = q_strides
    if not (D == 4 and 1 <= T <= _GROUPED_MAX_T and 2 <= G <= _GROUPED_MAX_G
            and G & (G - 1) == 0 and q_ptr % 16 == 0 and (sb * es) % 16 == 0
            and B >= 1 and N >= 1):
        return None
    if (sg, sn, sd) == (D, G * D, 1):
        return "rows"
    if sn == 1 and (sg * es) % 16 == 0 and (sd * es) % 16 == 0:
        return "planes"
    return None


def plan(B: int, G: int, N: int, T: int, D: int, q_strides, dtype: torch.dtype,
         q_ptr: int = 0) -> Plan:
    """The one rule: which kernel a CUDA call at ``q [B, G, N, D]`` (strides
    ``q_strides``, address ``q_ptr``) over ``T`` words of type ``dtype``
    launches, and with which geometry.  ``attn_grouped`` where its
    precondition holds; else ``attn_small`` for D <= 32 and ``attn_wide``
    up to 256.  Raises for a shape that no kernel takes."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"masked_cross_attention takes 1 <= D <= {MAX_D}, got {D}")
    es = torch.empty((), dtype=dtype).element_size()
    layout = _grouped_layout(B, G, N, T, D, q_strides, es, q_ptr)
    if layout:
        cpr = G * D * es // 16  # 16-byte chunks a query
        tile = max(_GROUPED_TILE_BYTES // (16 * cpr), 32 * _GROUPED_QUERIES[es])
        ntiles = math.ceil(N / tile)
        per = min(_GROUPED_MAX_TILES, max(1, B * ntiles // _GROUPED_MIN_BLOCKS))
        p = Plan(GROUPED, layout == "planes", _GROUPED_THREADS, B * math.ceil(ntiles / per),
                 tile, per)
    elif D <= 32:
        per_thread = 4 if D <= 4 else 2 if D <= 8 else 1  # queries a thread
        need = math.ceil(N / per_thread)
        threads = _SMALL_THREADS if need >= _SMALL_THREADS else math.ceil(need / 32) * 32
        tile = threads * per_thread
        p = Plan(SMALL, False, threads, B * G * math.ceil(N / tile) if tile else 0, tile, 1)
    else:
        p = Plan(WIDE, False, _WIDE_WARPS * 32, B * G * math.ceil(N / _WIDE_WARPS),
                 _WIDE_WARPS, 1)
    if p.blocks > _MAX_GRID:
        raise ValueError(f"masked_cross_attention: {p.blocks} blocks exceed the grid limit")
    return p


def _view4(t: torch.Tensor) -> torch.Tensor:
    return t if t.dim() == 4 else t.unsqueeze(1)


def plan_for(q: torch.Tensor, k: torch.Tensor) -> Plan:
    """``plan`` for the operands of one call (q ``[B, (G,) N, D]``, k
    ``[B, (G,) T, D]``), as the wrapper applies it."""
    q4 = _view4(q)
    b, g, n, d = q4.shape
    return plan(b, g, n, k.shape[-2], d, q4.stride(), q.dtype, q4.data_ptr())


def kernel_name(p: Plan, dtype: torch.dtype, D: int) -> str:
    """The planned kernel as the profiler names its template instance."""
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    if p.kernel == GROUPED:
        return f"{GROUPED}<{t}, {int(p.planes)}>"
    if p.kernel == SMALL:
        dmax = next(m for m in (4, 8, 16, 32) if D <= m)
        return f"{SMALL}<{t}, {dmax}, {4 if D <= 4 else 2 if D <= 8 else 1}>"
    return f"{WIDE}<{t}>"


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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
            scale: float) -> torch.Tensor:
    p = plan_for(q, k)
    q4, k4, v4 = _view4(q), _view4(k), _view4(v)
    if p.kernel != GROUPED:  # attn_small and attn_wide read a dense last dimension
        q4, k4, v4 = (t if t.stride(-1) == 1 else t.contiguous() for t in (q4, k4, v4))
    b, g, n, d = q4.shape
    t = k4.shape[2]
    out = torch.empty((b, g, n, d), device=q.device, dtype=q.dtype)
    # a bool tensor's bytes are the kernel's uint8 mask (1 = padded): no conversion launch
    m = (mask if mask.dtype in (torch.bool, torch.uint8) else mask.to(torch.uint8)).contiguous()
    fn = KERNEL.load().xmc_cross_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), m.data_ptr(), out.data_ptr(),
                b, g, n, t, d, *q4.stride(), *k4.stride(), *v4.stride(), *out.stride()[:3],
                scale, _DTYPE_CODE[q.dtype], _KERNEL_CODE[p.kernel], int(p.planes), p.threads,
                p.blocks, p.tile, p.tiles_per_block, stream)
    if rc != 0:
        raise RuntimeError(f"cross_attention launch failed ({p}): CUDA error {rc}")
    FORWARD.launches += 1
    return out.view(q.shape)


def masked_cross_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Masked cross-attention (see the module docstring): the planned CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return masked_cross_attention_ref(q, k, v, mask, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "masked_cross_attention has no backward (the Pallas kernel has none); the "
            "attention kernel's backward comes with the word-attention training slice")
    return _launch(q, k, v, mask, float(scale))
