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
  where they are.  For ``attn_short``, ``attn_small`` and ``attn_wide`` an
  operand whose last stride is not 1 is copied first (the keys once where
  they are also the values; ``OPERAND_COPIES`` counts the copies): so the
  In sampler's planes and keys past T = 32, where ``attn_small`` takes them.
* One rule, ``plan``, names the kernel a CUDA call launches and its launch
  geometry from the shapes, q's strides and 16-byte alignment, and the
  type, before any launch (memoized: a pure function of them); the C entry
  refuses a launch that its kernel does not take.  The Out sampler's
  shapes (D = 4, N = 16, T = 15: a warp a row, ``attn_short``) and the In
  sampler's (``attn_grouped``) each have a kernel of their own.
* A backward of the port's own (the Pallas kernel has none; the JAX
  package differentiates its einsum chain): on CUDA, with autograd on and
  an operand that requires grad, the call goes through an autograd
  Function whose forward is the planned forward launch (it saves q, k, v
  and the mask only) and whose backward launches the kernel that
  ``plan_bwd`` names: ``attn_bwd_warp`` at the word-attention training
  path's shapes (D <= 4, T <= 32: one pass over the real words a query,
  the dk and dv sums on every lane of a warp, one wave of small blocks,
  each warp's next batches of q and dO in flight while it computes one;
  its bound at the 64² step's In launches is its bytes, 0.296 / 0.148 ms
  fp32 / bf16 on an H100, and shared memory's delivery to registers holds
  it to ~37% / ~19% of that, PERF.md),
  ``attn_bwd`` at every other one up to D = 32, T = 256, and
  ``attn_bwd_long`` past 256 words at D <= 32 (the words streamed through
  shared memory a tile at a time, dk's and dv's fp32 sums in shared memory
  where they fit, else in a scratch of the block's own); D > 32 raises
  ``ValueError`` before any launch.  dq has q's strides, dk and dv
  are dense; each is rounded once to its operand's type; a fully padded row
  gets zero gradients.  ``masked_cross_attention_bwd_ref`` is their plain
  version.
* A CPU tensor goes to the plain version below; a CUDA tensor launches the
  planned kernel or raises.  There is no fallback from one to the other.
* The forward is also a registered operator,
  ``torch.ops.xmc_gan_tpu_torch.masked_cross_attention``: ``_check``, ``plan``
  and the launch for CUDA tensors, the plain version for CPU tensors, a fake
  that gives the launch's contiguous output.  A traced program
  (``torch.export``, ``utils/export.py``) holds each call as one such node,
  so the plan is made at run time from the real strides and address; eager
  calls are unchanged.  It has no autograd formula (inference only).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary, LaunchCount
from xmc_gan_tpu_torch.ops.cuda.fused_affine import OP_NAMESPACE

__all__ = ["KERNEL", "FORWARD", "BACKWARD", "OPERAND_COPIES", "MAX_D", "MAX_BWD_D", "MAX_BWD_T",
           "GROUPED", "SHORT", "SMALL", "WIDE", "BWD", "BWD_WARP", "BWD_LONG", "Plan", "BwdPlan",
           "plan", "plan_for",
           "plan_bwd", "kernel_name", "bwd_kernel_name", "masked_cross_attention_kernel",
           "masked_cross_attention_ref", "masked_cross_attention_bwd_ref",
           "masked_cross_attention_op"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# int xmc_cross_attention(q, k, v, mask, out, B, G, N, T, D, qsb, qsg, qsn, qsd,
#                         ksb, ksg, kst, ksd, vsb, vsg, vst, vsd, osb, osg, osn, scale,
#                         dtype, kernel, layout, threads, blocks, tile, tiles_per_block, stream)
# int xmc_cross_attention_bwd(q, k, v, mask, dout, dq, dk, dv, B, G, N, T, D, qs*, ks*, vs*,
#                             gs*, dqs* (4 each), scale, dtype, dmax, threads, blocks, smem,
#                             stream)
# int xmc_cross_attention_bwd_warp(the same up to dtype, then tmax, threads, blocks, smem, stream)
# int xmc_cross_attention_bwd_long(q, k, v, mask, dout, dq, dk, dv, scratch, then as
#                                  xmc_cross_attention_bwd)
KERNEL = CudaLibrary("cross_attention.cu", {
    "xmc_cross_attention": (_I, [_P] * 5 + [_I] * 5 + [_L] * 15
                            + [ctypes.c_float] + [_I] * 7 + [_P]),
    "xmc_cross_attention_bwd": (_I, [_P] * 8 + [_I] * 5 + [_L] * 20
                                + [ctypes.c_float] + [_I] * 5 + [_P]),
    "xmc_cross_attention_bwd_warp": (_I, [_P] * 8 + [_I] * 5 + [_L] * 20
                                     + [ctypes.c_float] + [_I] * 5 + [_P]),
    "xmc_cross_attention_bwd_long": (_I, [_P] * 9 + [_I] * 5 + [_L] * 20
                                     + [ctypes.c_float] + [_I] * 5 + [_P]),
})
FORWARD = LaunchCount()
BACKWARD = LaunchCount()  # any backward kernel
# operands the forward's wrapper copied for a kernel that reads a dense last
# dimension (not a launch: a layout that the planned kernel does not read)
OPERAND_COPIES = LaunchCount()
MAX_D = 256  # csrc/cross_attention.cu kMaxD
# kBwdMaxD; kBwdMaxT: the longest caption attn_bwd takes (attn_bwd_long past it)
MAX_BWD_D, MAX_BWD_T = 32, 256
BWD, BWD_WARP, BWD_LONG = "attn_bwd", "attn_bwd_warp", "attn_bwd_long"
# attn_bwd_warp (kWarpBwd*): the widest D and the longest caption it takes;
# its shared memory is warp_bwd_smem's
_WARP_BWD_MAX_D, _WARP_BWD_MAX_T = 4, 32
# attn_bwd_long (kLong*): the words a staged tile, the most queries a tile,
# and the shared memory a block may take (an H100's 227 KB)
_LONG_TILE_T, _LONG_MAX_THREADS, _MAX_BLOCK_SMEM = 64, 128, 232448

SMALL, WIDE, GROUPED, SHORT = "attn_small", "attn_wide", "attn_grouped", "attn_short"
_KERNEL_CODE = {SMALL: 0, WIDE: 1, GROUPED: 2, SHORT: 3}
# attn_short (kShort*): the widest D, the longest caption and the most
# queries of a row it takes; one warp a block up to this many rows, else
# _SHORT_WIDE_WARPS
_SHORT_MAX_D, _SHORT_MAX_T, _SHORT_MAX_N = 4, 32, 32
_SHORT_ONE_WARP_ROWS, _SHORT_WIDE_WARPS = 4096, 4
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
    ``attn_grouped`` walks ``tiles_per_block`` of; for ``attn_short`` the
    (b, g) rows of a block, a warp each), and ``attn_short``'s templates
    (``tmax``: the word slots of a query, ``split``: the lanes a query; 0
    for the others)."""
    kernel: str
    planes: bool
    threads: int
    blocks: int
    tile: int
    tiles_per_block: int
    tmax: int = 0
    split: int = 0


def _grouped_layout(B: int, G: int, N: int, T: int, D: int, q_strides, es: int,
                    q_aligned: bool) -> str | None:
    """``attn_grouped``'s precondition (``csrc/cross_attention.cu`` header):
    D = 4, 1 <= T <= 32, G a power of two in 2..32, q's address 16-byte
    aligned, and q laid out as rows (strides ``(., D, G*D, 1)``) or as planes
    (``(., qsg, 1, qsd)``), its b, g and d strides multiples of 16 bytes.
    Returns "rows", "planes" or None."""
    sb, sg, sn, sd = q_strides
    if not (D == 4 and 1 <= T <= _GROUPED_MAX_T and 2 <= G <= _GROUPED_MAX_G
            and G & (G - 1) == 0 and q_aligned and (sb * es) % 16 == 0
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
    ``q_strides``, address ``q_ptr``: only its 16-byte alignment counts)
    over ``T`` words of type ``dtype`` launches, and with which geometry.
    ``attn_grouped`` where its precondition holds; else ``attn_short``
    where D <= 4, 1 <= T <= 32 and 1 <= N <= 32 (a warp a (b, g) row:
    TMAX 16 up to T = 16, else 32; two lanes a query up to N = 16, else
    one; one warp a block up to 4,096 rows, else four); else ``attn_small``
    for D <= 32 and ``attn_wide`` up to 256.  Raises for a shape that no
    kernel takes.  Memoized on its arguments."""
    return _plan(B, G, N, T, D, tuple(q_strides), dtype, q_ptr % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _plan(B: int, G: int, N: int, T: int, D: int, q_strides: tuple, dtype: torch.dtype,
          q_aligned: bool) -> Plan:
    if not 1 <= D <= MAX_D:
        raise ValueError(f"masked_cross_attention takes 1 <= D <= {MAX_D}, got {D}")
    es = dtype.itemsize
    layout = _grouped_layout(B, G, N, T, D, q_strides, es, q_aligned)
    if layout:
        cpr = G * D * es // 16  # 16-byte chunks a query
        tile = max(_GROUPED_TILE_BYTES // (16 * cpr), 32 * _GROUPED_QUERIES[es])
        ntiles = math.ceil(N / tile)
        per = min(_GROUPED_MAX_TILES, max(1, B * ntiles // _GROUPED_MIN_BLOCKS))
        p = Plan(GROUPED, layout == "planes", _GROUPED_THREADS, B * math.ceil(ntiles / per),
                 tile, per)
    elif D <= _SHORT_MAX_D and 1 <= T <= _SHORT_MAX_T and 1 <= N <= _SHORT_MAX_N:
        warps = 1 if B * G <= _SHORT_ONE_WARP_ROWS else _SHORT_WIDE_WARPS
        p = Plan(SHORT, False, 32 * warps, math.ceil(B * G / warps), warps, 1,
                 16 if T <= 16 else 32, 2 if N <= 16 else 1)
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


class BwdPlan(NamedTuple):
    """What one backward launch takes: the kernel, ``dmax`` (its D bound:
    ``attn_bwd``'s and ``attn_bwd_long``'s template, 4 for
    ``attn_bwd_warp``), ``tmax`` (``attn_bwd_warp``'s template: the real
    words a lane holds; 0 for the others), ``threads`` (``attn_bwd`` and
    ``attn_bwd_long``: the queries of a tile; ``attn_bwd_warp``: 32 a
    warp), ``blocks`` (one per (b, g)), ``smem`` (bytes of dynamic shared
    memory) and ``scratch`` (``attn_bwd_long``: bytes of the fp32 dk and dv
    sums in device memory where they do not fit in shared memory, else 0)."""
    kernel: str
    dmax: int
    tmax: int
    threads: int
    blocks: int
    smem: int
    scratch: int = 0


def plan_bwd(B: int, G: int, N: int, T: int, D: int, dtype: torch.dtype) -> BwdPlan:
    """The one rule for the backward (``csrc/cross_attention.cu``), a pure
    function of the shapes: one block per (b, g) in every kernel.
    ``attn_bwd_warp`` where D <= 4 and T <= 32 (every word-attention training
    shape of the shipped configs): TMAX 16 up to T = 16, else 32; two warps
    a block (one where N <= 32).  Else ``attn_bwd`` up to D = 32 and
    T = 256: a tile of 256 queries up to T = 32 (halved as T doubles, 32 at
    T = 256) and no wider than N rounded up to a warp.  Past 256 words
    ``attn_bwd_long``: a tile of N rounded up to a warp, at most 128
    queries; the words in tiles of 64; dk's and dv's fp32 sums (8 T DMAX
    bytes a block) in shared memory where they fit beside the tiles within
    227 KB, else in a scratch of ``scratch`` bytes.  Raises ``ValueError``
    for D outside 1..32 or a grid past its limit, ``TypeError`` for a type
    other than fp32 or bf16."""
    if not 1 <= D <= MAX_BWD_D:
        raise ValueError(f"masked_cross_attention's backward takes 1 <= D <= {MAX_BWD_D}, "
                         f"got {D}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"masked_cross_attention's backward takes float32 or bfloat16, got {dtype}")
    if B * G > _MAX_GRID:
        raise ValueError(f"masked_cross_attention's backward: {B * G} blocks exceed the grid "
                         "limit")
    if D <= _WARP_BWD_MAX_D and T <= _WARP_BWD_MAX_T:
        tmax = 16 if T <= 16 else 32
        warps = 1 if N <= 32 else 2
        smem = 32 * tmax + warps * (4160 + 288 * tmax)
        return BwdPlan(BWD_WARP, _WARP_BWD_MAX_D, tmax, 32 * warps, B * G, smem)
    dmax = next(m for m in (4, 8, 16, 32) if D <= m)
    if T > MAX_BWD_T:  # csrc long_threads, long_smem_tiles, long_acc_bytes
        threads = min(_LONG_MAX_THREADS, max(32, math.ceil(N / 32) * 32))
        tiles = 4 * (2 * _LONG_TILE_T * dmax + 2 * (_LONG_TILE_T + dmax) * (threads + 1)
                     + _LONG_TILE_T)
        acc = 8 * T * dmax
        if tiles + acc <= _MAX_BLOCK_SMEM:
            return BwdPlan(BWD_LONG, dmax, 0, threads, B * G, tiles + acc)
        return BwdPlan(BWD_LONG, dmax, 0, threads, B * G, tiles, B * G * acc)
    tile = 256 if T <= 32 else 128 if T <= 64 else 64 if T <= 128 else 32
    threads = min(tile, max(32, math.ceil(N / 32) * 32))
    smem = 4 * (4 * T * dmax + 2 * (T + dmax) * (threads + 1)) + 8 * T
    return BwdPlan(BWD, dmax, 0, threads, B * G, smem)


def bwd_kernel_name(p: BwdPlan, dtype: torch.dtype) -> str:
    """The planned backward kernel as the profiler names its template instance."""
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    if p.kernel == BWD_WARP:
        return f"{BWD_WARP}<{t}, {p.tmax}>"
    return f"{p.kernel}<{t}, {p.dmax}>"


def _view4(t: torch.Tensor) -> torch.Tensor:
    return t if t.dim() == 4 else t.unsqueeze(1)


def _dims4(t: torch.Tensor) -> tuple[tuple, tuple]:
    """``t``'s shape and strides as ``[B, G, L, D]``: a 3-D tensor's as
    ``_view4`` gives them (``unsqueeze(1)``), without making the view."""
    if t.dim() == 4:
        return tuple(t.shape), t.stride()
    b, l, d = t.shape
    sb, sl, sd = t.stride()
    return (b, 1, l, d), (sb, sl * l, sl, sd)


def plan_for(q: torch.Tensor, k: torch.Tensor) -> Plan:
    """``plan`` for the operands of one call (q ``[B, (G,) N, D]``, k
    ``[B, (G,) T, D]``), as the wrapper applies it."""
    (b, g, n, d), strides = _dims4(q)
    return plan(b, g, n, k.shape[-2], d, strides, q.dtype, q.data_ptr())


def kernel_name(p: Plan, dtype: torch.dtype, D: int) -> str:
    """The planned kernel as the profiler names its template instance."""
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    if p.kernel == GROUPED:
        return f"{GROUPED}<{t}, {int(p.planes)}>"
    if p.kernel == SHORT:
        return f"{SHORT}<{t}, {p.tmax}, {p.split}>"
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


def masked_cross_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   mask: torch.Tensor, dout: torch.Tensor, scale: float = 1.0
                                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, in fp32, each gradient rounded
    once to its operand's type: ``P = softmax_t(scale q k^T, padded -> -inf)``
    (0 on a fully padded row), ``dP = dO v^T``, ``Delta = sum_t P dP``,
    ``dS = P (dP - Delta)``, ``dq = scale dS k``, ``dk = scale dS^T q``,
    ``dv = P^T dO``."""
    pad = _mask_view(mask, q.dim())
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("...nd,...td->...nt", qf, kf) * scale
    p = torch.softmax(s.masked_fill(pad, float("-inf")), dim=-1)
    p = p.masked_fill(pad.all(dim=-1, keepdim=True), 0.0)
    dp = torch.einsum("...nd,...td->...nt", gf, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("...nt,...td->...nd", ds, kf) * scale
    dk = torch.einsum("...nt,...nd->...td", ds, qf) * scale
    dv = torch.einsum("...nt,...nd->...td", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _on(dev: torch.device):
    """``torch.cuda.device(dev)`` where ``dev`` is not the current device (a
    launch goes to the current one); else nothing to enter."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
            scale: float) -> torch.Tensor:
    p = plan_for(q, k)
    if p.kernel != GROUPED:  # the other kernels read a dense last dimension
        same = v is k
        OPERAND_COPIES.launches += sum(t.stride(-1) != 1 for t in ((q, k) if same else (q, k, v)))
        q, k = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k))
        v = k if same else v if v.stride(-1) == 1 else v.contiguous()
    (b, g, n, d), qs = _dims4(q)
    ks, vs = _dims4(k)[1], _dims4(v)[1]
    t = k.shape[-2]
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)  # dense [B, G, N, D]
    # a bool tensor's bytes are the kernel's uint8 mask (1 = padded): no conversion launch
    m = (mask if mask.dtype in (torch.bool, torch.uint8) else mask.to(torch.uint8)).contiguous()
    fn = KERNEL.load().xmc_cross_attention
    with _on(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), out.data_ptr(),
                b, g, n, t, d, *qs, *ks, *vs, g * n * d, n * d, d,
                scale, _DTYPE_CODE[q.dtype], _KERNEL_CODE[p.kernel], int(p.planes), p.threads,
                p.blocks, p.tile, p.tiles_per_block, stream)
    if rc != 0:
        raise RuntimeError(f"cross_attention launch failed ({p}): CUDA error {rc}")
    FORWARD.launches += 1
    return out


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                dout: torch.Tensor, scale: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q4, k4, v4, g4 = (_view4(t) for t in (q, k, v, dout))
    b, g, n, d = q4.shape
    t = k4.shape[2]
    p = plan_bwd(b, g, n, t, d, q.dtype)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    dq = torch.empty_like(q)  # q's strides where q is dense (a view of it otherwise)
    dq4 = _view4(dq)
    dk = torch.empty((b, g, t, d), device=q.device, dtype=k.dtype)
    dv = torch.empty((b, g, t, d), device=q.device, dtype=v.dtype)
    m = (mask if mask.dtype in (torch.bool, torch.uint8) else mask.to(torch.uint8)).contiguous()
    ptrs = [q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), m.data_ptr(), g4.data_ptr(),
            dq4.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    lib = KERNEL.load()
    if p.kernel == BWD_WARP:
        fn, geometry = lib.xmc_cross_attention_bwd_warp, (p.tmax,)
    elif p.kernel == BWD:
        fn, geometry = lib.xmc_cross_attention_bwd, (p.dmax,)
    else:  # dk's and dv's fp32 sums in shared memory (NULL) or in this scratch
        fn, geometry = lib.xmc_cross_attention_bwd_long, (p.dmax,)
        scratch = (torch.empty(p.scratch // 4, device=q.device, dtype=torch.float32)
                   if p.scratch else None)
        ptrs.append(None if scratch is None else scratch.data_ptr())
    with _on(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, b, g, n, t, d, *q4.stride(), *k4.stride(), *v4.stride(), *g4.stride(),
                *dq4.stride(), scale, _DTYPE_CODE[q.dtype], *geometry, p.threads, p.blocks,
                p.smem, stream)
    if rc != 0:
        raise RuntimeError(f"cross_attention backward launch failed ({p}): CUDA error {rc}")
    BACKWARD.launches += 1
    return dq, dk.view(k.shape), dv.view(v.shape)


class _MaskedCrossAttention(torch.autograd.Function):
    """The forward launch, differentiable once through the planned backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        return _launch(q, k, v, mask, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, mask = ctx.saved_tensors
        return (*_launch_bwd(q, k, v, mask, dout, ctx.scale), None, None)


def _masked_cross_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: torch.Tensor, scale: float) -> torch.Tensor:
    _check(q, k, v, mask)
    return _launch(q, k, v, mask, scale)


def _masked_cross_attention_cpu(q, k, v, mask, scale):
    _check(q, k, v, mask)
    return masked_cross_attention_ref(q, k, v, mask, scale).contiguous()


# the forward as a registered operator: the planned kernel for CUDA tensors,
# the plain version for CPU tensors, the launch's dense output for fake ones
masked_cross_attention_op = torch.library.custom_op(
    f"{OP_NAMESPACE}::masked_cross_attention", _masked_cross_attention_cuda, mutates_args=(),
    device_types="cuda")
masked_cross_attention_op.register_kernel("cpu", _masked_cross_attention_cpu)
masked_cross_attention_op.register_fake(lambda q, k, v, mask, scale: q.new_empty(q.shape))


def masked_cross_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Masked cross-attention (see the module docstring): the planned CUDA
    kernel on CUDA tensors (differentiable through the planned backward
    kernel when autograd is on), the plain version on CPU tensors.  In a
    traced program, the registered operator."""
    if torch.compiler.is_compiling():
        return masked_cross_attention_op(q, k, v, mask, float(scale))
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return masked_cross_attention_ref(q, k, v, mask, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        q4 = _view4(q)
        plan_bwd(*q4.shape[:3], k.shape[-2], q.shape[-1], q.dtype)  # refuses before any launch
        return _MaskedCrossAttention.apply(q, k, v, mask, float(scale))
    return _launch(q, k, v, mask, float(scale))
