"""Pairwise word-region (DAMSM) matching scores: the CUDA kernels and their plain version.

Replaces ``xmc_gan_tpu/ops/pallas/damsm_score.py`` (``damsm_scores``: the
forward ``_fwd_kernel`` and the backward kernels ``_bwd_dr_kernel`` and
``_bwd_dw_kernel`` behind a ``jax.custom_vjp``).  The kernels are
``csrc/damsm_score.cu``; its header gives the design and the bounds.

On l2-normalized operands ``r`` ``[B, R, D]`` (regions) and ``w``
``[Bc, T, D]`` (words), for every image i and caption j::

    sim  = w_j r_i^T                  a = softmax_R(gamma1 * sim)
    c    = a r_i                      c_hat = c / max(||c||, 1e-12)
    rel  = sum_D c_hat * w_j          score = logsumexp_T(gamma2 * rel) / gamma2

with padded words (``mask`` True) at -1e30 before the logsumexp, so an
all-padded caption scores a finite ~-2e29.  ``compute_dtype`` bf16 rounds
the operands of the three products to bf16 (``r``, ``w``, ``a`` and
``c_hat``), and in the backward the two cotangents that autograd of the
plain version rounds (``d c_hat`` and ``d a``); everything else is fp32.

Routes, one rule per kernel (``route(which, R, D, compute_dtype)``): every
launch at D > 1024 runs on the feature-streamed CUDA-core kernels
(``STREAMED_FEATURES``, plan ``plan_fs``, either dtype: a caption
sub-block a block, the features streamed a chunk at a time through every
product, so no width limits them; their backward takes rel from the fp32
``c_hat``, as the Pallas kernel does, within the bf16 gradients'
tolerance).  Below that the
bf16 forward, d_regions and d_words run on the tensor cores
(``TENSOR_CORES``; launch plans ``plan_fwd``, ``plan_dr`` and ``plan_dw``)
if and only if R <= 256, the forward and d_regions with the
image's regions resident in shared memory at D <= 256 and streamed through
it in column chunks above, the d_words streaming them at every D (blocks of
one pass of packed real words and a split of the images, d_w kept on chip
across the images).  The tensor-core backward kernels also round ``d_c``
and ``d_sim`` to bf16 before their products, as the Pallas kernel does
(within one bf16 ulp of the largest gradient of the plain version).
The fp32 forward, d_regions and d_words at R <= 256, D <= 1024 run on the
CUDA cores in passes of packed real words with the regions streamed
(``PACKED_FP32``, plans ``plan_fwd_f32``, ``plan_dr_f32`` and
``plan_dw_f32``): the forward and d_regions at D <= 256 with the context's
[rows, D] sums in registers, above it (the wide kernels) a group of 256
features at a time, never stored; the d_words as the bf16 one's blocks
(pass, split of the images) with d_w on chip across the images.  Every
kernel at R > 256, D <= 1024 runs on the CUDA-core kernels that take a
caption sub-block per block (``plan``).

Any T: a block holds at most 64 word rows, so where T does not fit
``damsm_scores`` moves each caption's real words to the front, drops the
slots past the batch's longest caption and cuts the rest into k
sub-captions of ``sub_caption_width`` slots (``split_captions``:
the last zero-padded, its padding masked), runs the kernels on the
``[Bc * k]`` sub-captions and combines their scores by
``combine_sub_scores``: ``score = logsumexp_k(gamma2 * s_sub) / gamma2``,
exact up to summation order (words are independent until the logsumexp
over T).  The split is a function of the shape and the mask, never of the
device, so the CPU runs the split the card runs; where T fits there is no
split.  ``sub_caption_width`` also states the one limit left (a word row
of the route's backward in shared memory at R, which no D reaches);
``losses.word_region_scores`` asks it before routing a call here.

Contract of ``damsm_scores`` (a ``torch.autograd.Function``):

* A CPU tensor goes to the plain version (``damsm_scores_ref``, forward and
  VJP) of each sub-caption; a CUDA tensor launches the kernels or raises.
  No fallback: the route is decided from the shape before any launch.
* The backward computes only what ``ctx.needs_input_grad`` asks for: in the
  train step the words carry no gradient, so the d_words kernel never runs
  (its plan still bounds ``sub_caption_width`` on its route).
* It is not twice differentiable (``once_differentiable``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary, LaunchCount

__all__ = [
    "NEG",
    "CUDA_CORES",
    "TENSOR_CORES",
    "PACKED_FP32",
    "STREAMED_FEATURES",
    "KERNEL",
    "DR_KERNEL",
    "DW_KERNEL",
    "LIBRARIES",
    "FORWARD",
    "D_REGIONS",
    "D_WORDS",
    "damsm_scores",
    "damsm_scores_ref",
    "combine_sub_scores",
    "cuda_core_rows",
    "fs_rows",
    "kernel_name",
    "packed_rows",
    "plan",
    "plan_dr",
    "plan_dr_f32",
    "plan_dw",
    "plan_dw_f32",
    "plan_fwd",
    "plan_fs",
    "plan_fwd_f32",
    "route",
    "split_captions",
    "sub_caption_width",
]

NEG = -1e30  # padded-word logit, the JAX package's constant

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# int xmc_damsm_fwd(r, w, mask, out, B, Bc, R, T, D, vb, rows, nsplit, gamma1, gamma2, dtype,
#                   route, stream)
# int xmc_damsm_bwd_dr(r, w, mask, g, partial, dr, B, Bc, R, T, D, vb, rows, nsplit,
#                      gamma1, gamma2, dtype, route, stream)
# int xmc_damsm_bwd_dw(r, w, mask, g, plan, partial, dw, B, Bc, R, T, D, vb, rows,
#                      nsplit, gamma1, gamma2, dtype, route, stream)
# The source builds as three libraries, one nvcc each, side by side: the
# forward's entry point (``KERNEL``), the d_regions' (``DR_KERNEL``) and the
# d_words' (``DW_KERNEL``), each with the kernels it launches
# (``XMC_DAMSM_PART`` in the source).
KERNEL = CudaLibrary("damsm_score.cu", {
    "xmc_damsm_fwd": (_I, [_P] * 4 + [_I] * 8 + [_F, _F, _I, _I, _P]),
}, flags=("-DXMC_DAMSM_PART=1",))
DR_KERNEL = CudaLibrary("damsm_score.cu", {
    "xmc_damsm_bwd_dr": (_I, [_P] * 6 + [_I] * 8 + [_F, _F, _I, _I, _P]),
}, flags=("-DXMC_DAMSM_PART=2",))
DW_KERNEL = CudaLibrary("damsm_score.cu", {
    "xmc_damsm_bwd_dw": (_I, [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _P]),
}, flags=("-DXMC_DAMSM_PART=3",))
LIBRARIES = (KERNEL, DR_KERNEL, DW_KERNEL)
FORWARD = LaunchCount()
D_REGIONS = LaunchCount()
D_WORDS = LaunchCount()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the routes (``route``) and their codes in the C entry points
CUDA_CORES, TENSOR_CORES, PACKED_FP32 = "cuda_cores", "tensor_cores", "packed_fp32"
STREAMED_FEATURES = "streamed_features"
_ROUTE_CODE = {CUDA_CORES: 0, TENSOR_CORES: 1, PACKED_FP32: 2, STREAMED_FEATURES: 3}

# Kernel limits, mirrored from csrc/damsm_score.cu: word rows per block (a
# sub-block of vb captions has vb*T rows), padded feature width, region rows
# per staged tile, shared memory a block may use.
MAX_ROWS = 64
MAX_DP = 1024
RT = 32
SMEM_LIMIT = 232448
# the tensor-core (bf16) forward and d_regions kernels with resident regions: R and D
TC_MAX_RD = 256
TC_ROWS = (64, 48, 32, 16)  # word rows per pass they can take, largest first
TC_STAGE = 36  # row stride of a warp's d_r staging tile
# the tensor-core (bf16) forward and d_regions with streamed regions (256 < D <= 1024):
# word rows per pass the d_regions and the forward can take, largest first; region
# columns per streamed chunk
TCS_MAX_D = 1024
TCS_ROWS = (32, 16)
TCS_FWD_ROWS = (32,)
TCS_KC = 64
# the tensor-core (bf16) d_words (regions streamed at every D): word rows per
# pass by the D they reach (64 to 256, 32 to 768, 16 to 1024), and the region
# chunks of d_w it holds in registers from D = 256 to 768 (the rest in shared
# memory)
TCD_ROWS = {256: 64, 768: 32, 1024: 16}
TCD_QREG = 2
# the fp32 forward and d_regions with packed words and streamed regions: R
# and D limit (their tiles are 256 wide), row strides of their [rows, 256]
# tiles and of a column chunk, regions per chunk; word rows per pass of the
# d_regions and of the forward
F32_MAX_RD = 256
F32_S = 260
F32_SC = 36
F32_KC = 32
F32_ROWS = (48,)
F32_FWD_ROWS = (64,)
# the wide fp32 forward and d_regions (256 < D <= 1024): D limit, word rows
# per pass they can take (largest first), features of a context group
F32W_MAX_D = 1024
F32W_ROWS = (32, 24)
F32W_DG = 256
# the fp32 d_words (packed words, regions streamed at every D): word rows per
# pass by the D they reach (32 to 256, 16 to 1024)
F32D_ROWS = {256: 32, 1024: 16}
# the feature-streamed kernels (``STREAMED_FEATURES``, every launch at
# D > MAX_DP): features of a streamed chunk, the row stride of a chunk tile;
# the bytes of d_regions' or d_words' scratch above which they take no more
# splits
FS_KF = 128
FS_SW = FS_KF + 4
FS_SCRATCH_BYTES = 2**28


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def route(which: str, R: int, D: int, compute_dtype: torch.dtype | None) -> str:
    """The route rule, per kernel (``which``: "fwd", "dr" or "dw"):
    ``STREAMED_FEATURES`` for every launch at D > 1024, at any R and in
    both compute dtypes (the features streamed a chunk at a time, so no
    width limits it); below that ``TENSOR_CORES`` for the bf16 forward,
    d_regions and d_words if and only if R <= 256 (the forward's and
    d_regions' regions resident at D <= 256, streamed above; the d_words'
    streamed at every D); ``PACKED_FP32`` for every other compute dtype
    under the same rule (passes of packed real words, the regions
    streamed; the wide forward and d_regions above D = 256); ``CUDA_CORES``
    for every launch at R > 256.  So the three kernels of a call share one
    route.  T plays no part: the kernels see sub-captions of at most 64
    slots.  The launches, the plans, ``kernel_name`` and
    ``sub_caption_width`` all read it."""
    if which not in ("fwd", "dr", "dw"):
        raise ValueError(f"which must be 'fwd', 'dr' or 'dw', got {which!r}")
    if D > MAX_DP:
        return STREAMED_FEATURES
    if R <= TC_MAX_RD:
        return TENSOR_CORES if compute_dtype == torch.bfloat16 else PACKED_FP32
    return CUDA_CORES


def _cuda_core_smem(R: int, D: int, backward: bool) -> tuple[int, int]:
    """(bytes per word row, fixed bytes) of a CUDA-core block's shared
    memory: words and context ``[rows, Dp]``, the ``[rows, SR]`` attention
    (and its cotangent in the backward) and 4 row scalars, beside the staged
    ``[32, Dp + 4]`` region tile (fp32)."""
    dp, sr = _round_up(D, 8), _round_up(R, RT)
    return 4 * (2 * dp + (2 if backward else 1) * sr + 4), 4 * RT * (dp + 4)


def cuda_core_rows(R: int, D: int, backward: bool) -> int:
    """Word rows a CUDA-core block holds: at most 64, as many as shared
    memory takes (0 where not one fits)."""
    per_row, fixed = _cuda_core_smem(R, D, backward)
    return max(0, min(MAX_ROWS, (SMEM_LIMIT - fixed) // per_row))


def _fs_smem(R: int, backward: bool) -> tuple[int, int]:
    """(bytes per word row, fixed bytes) of a feature-streamed block's shared
    memory, as ``csrc/damsm_score.cu`` computes it (``fs_smem_bytes``): the
    ``[rows, SR]`` sim / attention (and its cotangent in the backward), a
    chunk of the words ``[rows, FS_SW]`` (and of d_c in the backward) and 4
    row scalars, beside a tile of region rows ``[32, FS_SW]`` (fp32).  No
    term depends on D."""
    k, sr = (2 if backward else 1), _round_up(R, RT)
    return 4 * (k * sr + k * FS_SW + 4), 4 * RT * FS_SW


def fs_rows(R: int, backward: bool) -> int:
    """Word rows a feature-streamed block holds at R: at most 64, as many as
    shared memory takes (0 where not one fits)."""
    per_row, fixed = _fs_smem(R, backward)
    return max(0, min(MAX_ROWS, (SMEM_LIMIT - fixed) // per_row))


def plan_fs(R: int, T: int, D: int, backward: bool, bc: int) -> tuple[int, int]:
    """(captions per block ``vb``, dynamic shared memory bytes) for one
    feature-streamed kernel (``STREAMED_FEATURES``): as many captions as
    shared memory holds (``fs_rows``), at most ``bc``, at any D.  Raises
    where even one caption does not fit (T > 64 or more rows than
    ``fs_rows``), naming the bytes a word row needs."""
    if T > MAX_ROWS:
        raise ValueError(f"damsm_score kernels take T <= {MAX_ROWS}; got T={T}, D={D}")
    per_row, fixed = _fs_smem(R, backward)
    vb = min(MAX_ROWS // T, fs_rows(R, backward) // T, bc)
    if vb < 1:
        raise ValueError(f"damsm_score: R={R}, T={T}, D={D} does not fit in shared memory (a "
                         f"word row needs {per_row} bytes beside {fixed}, of {SMEM_LIMIT})")
    return vb, fixed + per_row * vb * T


def plan(R: int, T: int, D: int, backward: bool, bc: int) -> tuple[int, int]:
    """(captions per block ``vb``, dynamic shared memory bytes) for one
    CUDA-core kernel: as many captions as shared memory holds, at most
    ``bc``.  Raises where even one caption does not fit (T > 64, D > 1024,
    or more rows than ``cuda_core_rows``)."""
    dp = _round_up(D, 8)
    if T > MAX_ROWS or dp > MAX_DP:
        raise ValueError(f"the CUDA-core damsm_score kernels take T <= {MAX_ROWS} and "
                         f"D <= {MAX_DP}; got T={T}, D={D}")
    per_row, fixed = _cuda_core_smem(R, D, backward)
    vb = min(MAX_ROWS // T, (SMEM_LIMIT - fixed) // (per_row * T), bc)
    if vb < 1:
        raise ValueError(f"damsm_score: R={R}, T={T}, D={D} does not fit in shared memory")
    return vb, fixed + per_row * vb * T


class TcPlan(NamedTuple):
    """Launch plan of a kernel whose blocks are (image, split): the bf16
    tensor-core forward or d_regions, or the packed fp32 forward or
    d_regions; or of the bf16 tensor-core d_words, whose blocks are (pass,
    split) and whose splits are of the images (``plan_dw``)."""

    rows: int      # word rows per pass, at least T (bf16: a multiple of 16)
    nsplit: int    # caption splits: blocks are (image, split); d_words: image splits
    captions: int  # captions per block (one split); d_words: images per split
    smem: int      # dynamic shared memory bytes


def _tc_fwd_smem(R: int, D: int, rows: int) -> int:
    """The bf16 forward kernel's shared memory, as ``csrc/damsm_score.cu``
    computes it: the image's regions stay resident (``[Rp, Dp + 8]`` bf16)
    beside two bf16 tiles of the pass's rows (words ``[rows, Dp + 8]``, a
    ``[rows, Rp + 8]``) and 14 fp32/int words per row (rel, the 8 warps' row
    partials, the row map)."""
    rp, dp = _round_up(R, 16), _round_up(D, 16)
    return 2 * (rp * (dp + 8) + rows * ((dp + 8) + (rp + 8))) + 4 * (14 * rows + 4)


def _tcs_fwd_smem(R: int, D: int, rows: int) -> int:
    """The streamed bf16 forward kernel's shared memory (256 < D <= 1024),
    as ``csrc/damsm_score.cu`` computes it: two bf16 tiles of the pass's
    rows as ``_tc_fwd_smem`` (words ``[rows, Dp + 8]``, a ``[rows, Rp +
    8]``), the two region chunk buffers ``[2, Rp, TCS_KC + 8]`` bf16 and 14
    fp32/int words per row."""
    rp, dp = _round_up(R, 16), _round_up(D, 16)
    return 2 * rows * ((dp + 8) + (rp + 8)) + 2 * 2 * rp * (TCS_KC + 8) + 4 * (14 * rows + 4)


def _tc_dr_smem(R: int, D: int, rows: int) -> int:
    """The bf16 d_regions kernel's shared memory, as ``csrc/damsm_score.cu``
    computes it: the image's regions stay resident (``[Rp, Dp + 8]`` bf16)
    beside four bf16 tiles of the pass's rows (words and d_c
    ``[rows, Dp + 8]``, a and d_sim ``[rows, Rp + 8]``), each of the 8 warps'
    fp32 d_r staging tile ``[16, TC_STAGE]`` and 15 fp32/int words per row."""
    rp, dp = _round_up(R, 16), _round_up(D, 16)
    return 2 * (rp * (dp + 8) + rows * (2 * (dp + 8) + 2 * (rp + 8))) + 4 * (
        8 * 16 * TC_STAGE + 15 * rows + 4)


def _tcs_dr_smem(R: int, D: int, rows: int) -> int:
    """The streamed bf16 d_regions kernel's shared memory (256 < D <= 1024),
    as ``csrc/damsm_score.cu`` computes it: four bf16 tiles of the pass's
    rows as ``_tc_dr_smem``, then one union of the two region chunk buffers
    ``[2, Rp, TCS_KC + 8]`` bf16 (the products) and the 8 warps' fp32 d_r
    staging tiles ``[16, TC_STAGE]`` (the d_r accumulation), and 15 fp32/int
    words per row."""
    rp, dp = _round_up(R, 16), _round_up(D, 16)
    union = max(2 * 2 * rp * (TCS_KC + 8), 4 * 8 * 16 * TC_STAGE)
    return 2 * rows * (2 * (dp + 8) + 2 * (rp + 8)) + union + 4 * (15 * rows + 4)


def _f32_smem(rows: int, bwd: bool) -> int:
    """The fp32 forward's or d_regions' (``bwd``) shared memory (R, D <=
    256), as ``csrc/damsm_score.cu`` computes it (``f32_smem_bytes``): fp32
    tiles of the pass's rows (words and a, and for the d_regions d_c:
    ``[rows, F32_S]``), two region chunk buffers of a column chunk each
    (``[256, F32_SC]``; the d_regions' d_sim takes their place for the d_r
    accumulation) and 11 fp32/int words per row (rel, drel, the 4 column
    warps' row partials, the row map).  The same at every R and D."""
    return 4 * ((3 if bwd else 2) * rows * F32_S + 2 * F32_MAX_RD * F32_SC + 11 * rows + 4)


def _f32w_smem(D: int, rows: int) -> int:
    """The wide fp32 forward's or d_regions' shared memory (256 < D <=
    1024), the same for both, as ``csrc/damsm_score.cu`` computes it
    (``f32w_smem_bytes``): the pass's words ``[rows, SW]`` with SW = D
    rounded up to whole 256-feature groups + 4, a ``[rows, F32_S]``, the two
    chunk buffers ``[256, F32_SC]`` (the d_regions' d_sim and one group of
    the words take their place for the d_r accumulation) and 11 fp32/int
    words per row."""
    sw = _round_up(D, F32W_DG) + 4
    return 4 * (rows * (sw + F32_S) + 2 * F32_MAX_RD * F32_SC + 11 * rows + 4)


def _f32d_smem(D: int, rows: int) -> int:
    """The fp32 d_words kernel's shared memory, as ``csrc/damsm_score.cu``
    computes it (``f32d_smem_bytes``): the pass's words ``[rows, SW]`` as
    the wide kernels' (``_f32w_smem``), a (d_sim in its place) and one
    group of d_c ``[rows, F32_S]`` each, d_w's feature groups before the
    last (that one in registers) ``[rows, (ng - 1) * 256 + 4]`` (none at
    D <= 256), the two chunk buffers ``[256, F32_SC]`` and 11 fp32/int
    words a row."""
    ng = -(-D // F32W_DG)
    swd = (ng - 1) * F32W_DG + 4 if ng > 1 else 0
    sw = _round_up(D, F32W_DG) + 4
    return 4 * (rows * (sw + 2 * F32_S + swd) + 2 * F32_MAX_RD * F32_SC + 11 * rows + 4)


def _tcd_class(D: int) -> int:
    """The D limit of the tensor-core d_words' row choice that takes D
    (``TCD_ROWS``: by the region chunks its context takes, 4, 12 or 16);
    above D = 1024 the last, whose plan then refuses D."""
    return next((limit for limit in TCD_ROWS if _round_up(D, 16) <= limit), TCS_MAX_D)


def _tcd_smem(R: int, D: int, rows: int) -> int:
    """The bf16 d_words kernel's shared memory, as ``csrc/damsm_score.cu``
    computes it (``tcd_smem_bytes``): the pass's words ``[rows, Dp + 8]``
    bf16, one bf16 tile ``[rows, max(Rp + 8, TCS_KC + 8)]`` (a, a chunk of
    d_c, d_sim in turn), the two region chunk buffers ``[2, Rp, TCS_KC + 8]``
    bf16, d_w's columns past its ``TCD_QREG`` register chunks (from D =
    256 to 768) ``[rows, SWD]`` fp32, SWD = those chunks' columns + 8, and
    15 fp32/int words per row."""
    rp, dp = _round_up(R, 16), _round_up(D, 16)
    nq = -(-dp // TCS_KC)
    qreg = TCD_QREG if _tcd_class(D) == 768 else 0
    swd = (nq - qreg) * TCS_KC + 8
    return (2 * rows * (dp + 8 + max(rp + 8, TCS_KC + 8)) + 2 * 2 * rp * (TCS_KC + 8)
            + 4 * rows * swd + 4 * (15 * rows + 4))


class PackedKernel(NamedTuple):
    """One kernel of the packed routes (``TENSOR_CORES``, ``PACKED_FP32``):
    its shared memory for a number of rows per pass, the rows per pass it
    can take (largest first), its D limit and the profiler's name."""

    smem: Callable[[int], int]
    rows: tuple[int, ...]
    max_d: int
    name: str


def _tc_rows(smem: Callable[[int], int], rows: tuple[int, ...] = TC_ROWS) -> int:
    """The largest of ``rows`` whose ``smem(rows)`` fits (0 if none)."""
    return next((m for m in rows if smem(m) <= SMEM_LIMIT), 0)


def _plan_tc(what: str, R: int, T: int, D: int, b: int, bc: int, sms: int,
             kernel: PackedKernel) -> TcPlan:
    """Rows per pass: the largest of the kernel's rows that holds one
    caption and whose shared memory fits.  A block takes a multiprocessor's
    shared memory, so the splits fill the card's ``sms`` once: ``sms // b``
    (at least 1).  Raises for T > max(rows), R > 256 or D above the
    kernel's limit."""
    smem, rows, max_d = kernel.smem, kernel.rows, kernel.max_d
    if T > rows[0] or R > TC_MAX_RD or D > max_d:
        raise ValueError(f"damsm_score {what} takes T <= {rows[0]}, R <= "
                         f"{TC_MAX_RD} and D <= {max_d}; got R={R}, T={T}, D={D}")
    fits = [m for m in rows if m >= T and smem(m) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"damsm_score {what}: R={R}, T={T}, D={D} does not fit in "
                         "shared memory")
    nsplit = max(1, min(bc, sms // b))
    return TcPlan(fits[0], nsplit, -(-bc // nsplit), smem(fits[0]))


# the bf16 tensor-core kernels by (which, regions streamed): shared memory for
# (R, D, rows), the rows per pass each can take, its D limit and name; the
# kernels keep their regions resident at D <= 256 and stream them above
_TC_KERNELS = {
    ("fwd", False): (_tc_fwd_smem, TC_ROWS, TC_MAX_RD, "damsm_fwd_tc_kernel<"),
    ("fwd", True): (_tcs_fwd_smem, TCS_FWD_ROWS, TCS_MAX_D, "damsm_fwd_tcs_kernel<"),
    ("dr", False): (_tc_dr_smem, TC_ROWS, TC_MAX_RD, "damsm_bwd_dr_tc_kernel<"),
    ("dr", True): (_tcs_dr_smem, TCS_ROWS, TCS_MAX_D, "damsm_bwd_dr_tcs_kernel<"),
}


def _tc_kernel(which: str, R: int, D: int) -> PackedKernel:
    """The bf16 tensor-core kernel (``which``: "fwd", "dr" or "dw") that
    takes R, D (``_TC_KERNELS``; the d_words: one kernel, its rows by D,
    ``TCD_ROWS``)."""
    if which == "dw":
        return PackedKernel(lambda m: _tcd_smem(R, D, m), (TCD_ROWS[_tcd_class(D)],),
                            TCS_MAX_D, "damsm_bwd_dw_tcs_kernel<")
    smem, rows, max_d, name = _TC_KERNELS[(which, D > TC_MAX_RD)]
    return PackedKernel(lambda m: smem(R, D, m), rows, max_d, name)


def plan_fwd(R: int, T: int, D: int, b: int, bc: int, sms: int) -> TcPlan:
    """The bf16 tensor-core forward kernel's plan (``_tc_kernel``)."""
    return _plan_tc("bf16 forward", R, T, D, b, bc, sms, _tc_kernel("fwd", R, D))


def plan_dr(R: int, T: int, D: int, b: int, bc: int, sms: int) -> TcPlan:
    """The bf16 tensor-core d_regions kernel's plan (``_tc_kernel``)."""
    return _plan_tc("bf16 d_regions", R, T, D, b, bc, sms, _tc_kernel("dr", R, D))


def _plan_dw(what: str, R: int, T: int, D: int, b: int, bc: int, sms: int,
             kernel: PackedKernel) -> TcPlan:
    """A packed d_words kernel's plan: its rows per pass (``_plan_tc``).
    Its blocks are (pass, split of the b images); the passes depend on the
    mask, so the splits fill the card's ``sms`` once from the passes as if
    every one of the bc * T slots held a word: ``ceil(sms / ceil(bc * T /
    rows))``, at most b.  ``captions`` is the images per split."""
    rows, _, _, smem = _plan_tc(what, R, T, D, b, bc, sms, kernel)
    passes = -(-bc * T // rows)
    nsplit = max(1, min(b, -(-sms // passes)))
    return TcPlan(rows, nsplit, -(-b // nsplit), smem)


def plan_dw(R: int, T: int, D: int, b: int, bc: int, sms: int) -> TcPlan:
    """The bf16 tensor-core d_words kernel's plan (``_tc_kernel``,
    ``_plan_dw``): rows per pass by D (64 to D = 256, 32 to 768, 16 to
    1024).  Raises for T above the rows, R > 256 or D > 1024."""
    return _plan_dw("bf16 d_words", R, T, D, b, bc, sms, _tc_kernel("dw", R, D))


def _f32_kernel(which: str, D: int) -> PackedKernel:
    """The packed fp32 kernel (``which``: "fwd", "dr" or "dw") that takes
    D: the forward and d_regions at D <= 256 ``F32_FWD_ROWS`` or
    ``F32_ROWS`` rows (``_f32_smem``), above it the wide kernels'
    ``F32W_ROWS`` (``_f32w_smem``); the d_words one kernel, its rows by D
    (``F32D_ROWS``, ``_f32d_smem``)."""
    if which == "dw":
        rows = F32D_ROWS[F32_MAX_RD if D <= F32_MAX_RD else F32W_MAX_D]
        return PackedKernel(lambda m: _f32d_smem(D, m), (rows,), F32W_MAX_D,
                            "damsm_bwd_dw_f32_kernel<")
    prefix = {"fwd": "damsm_fwd", "dr": "damsm_bwd_dr"}[which]
    if D > F32_MAX_RD:
        return PackedKernel(lambda m: _f32w_smem(D, m), F32W_ROWS, F32W_MAX_D,
                            f"{prefix}_f32w_kernel<")
    bwd = which == "dr"
    return PackedKernel(lambda m: _f32_smem(m, bwd), F32_ROWS if bwd else F32_FWD_ROWS,
                        F32_MAX_RD, f"{prefix}_f32_kernel<")


def plan_dr_f32(R: int, T: int, D: int, b: int, bc: int, sms: int) -> TcPlan:
    """The fp32 d_regions kernel's plan (``PACKED_FP32``, ``_f32_kernel``):
    blocks (image, split) as the tensor-core kernels'.  Raises for R > 256,
    D > 1024, or T above the kernel's rows a pass (48 at D <= 256, else
    32)."""
    return _plan_tc("fp32 d_regions", R, T, D, b, bc, sms, _f32_kernel("dr", D))


def plan_fwd_f32(R: int, T: int, D: int, b: int, bc: int, sms: int) -> TcPlan:
    """The fp32 forward kernel's plan (``PACKED_FP32``, ``_f32_kernel``):
    blocks (image, split) as the fp32 d_regions'.  Raises for R > 256,
    D > 1024, or T above the kernel's rows a pass (64 at D <= 256, else
    32)."""
    return _plan_tc("fp32 forward", R, T, D, b, bc, sms, _f32_kernel("fwd", D))


def plan_dw_f32(R: int, T: int, D: int, b: int, bc: int, sms: int) -> TcPlan:
    """The fp32 d_words kernel's plan (``PACKED_FP32``, ``_f32_kernel``,
    ``_plan_dw``): blocks (pass, split of the images) as the bf16 d_words',
    32 rows a pass at D <= 256, 16 above.  Raises for R > 256, D > 1024, or
    T above the rows."""
    return _plan_dw("fp32 d_words", R, T, D, b, bc, sms, _f32_kernel("dw", D))


def kernel_name(which: str, R: int, D: int, compute_dtype: torch.dtype | None) -> str:
    """The start of the name under which a profiler trace shows the kernel
    that ``which`` ("fwd", "dr" or "dw") launches at R, D and compute dtype
    (``route``): on the tensor cores with the regions resident
    (``_tc_kernel<``) or streamed (``_tcs_kernel<``; the d_words at every
    D), the fp32 kernels with packed words (``_f32_kernel<``; the forward's
    and d_regions' ``_f32w_kernel<`` at D > 256), the feature-streamed ones
    at D > 1024 (``_fs_kernel<``, either dtype), else on the CUDA cores
    (templated on the operand type, except the forward's kernels)."""
    rt = route(which, R, D, compute_dtype)
    if rt == TENSOR_CORES:
        return _tc_kernel(which, R, D).name
    if rt == PACKED_FP32:
        return _f32_kernel(which, D).name
    if rt == STREAMED_FEATURES:
        return {"fwd": "damsm_fwd_fs_kernel<", "dr": "damsm_bwd_dr_fs_kernel<",
                "dw": "damsm_bwd_dw_fs_kernel<"}[which]
    bf16 = compute_dtype == torch.bfloat16
    return {"fwd": "damsm_fwd_bf16_kernel<" if bf16 else "damsm_fwd_kernel<",
            "dr": "damsm_bwd_dr_kernel<" + ("__nv_bfloat16" if bf16 else "float"),
            "dw": "damsm_bwd_dw_kernel<"}[which]


def packed_rows(R: int, D: int, compute_dtype: torch.dtype | None) -> int:
    """The least word rows a pass of the three packed kernels of the route
    (``TENSOR_CORES`` or ``PACKED_FP32``) take at R, D: each the largest of
    its rows whose shared memory fits."""
    if route("fwd", R, D, compute_dtype) == TENSOR_CORES:
        kernels = [_tc_kernel(which, R, D) for which in ("fwd", "dr", "dw")]
    else:
        kernels = [_f32_kernel(which, D) for which in ("fwd", "dr", "dw")]
    return min(_tc_rows(k.smem, k.rows) for k in kernels)


def sub_caption_width(R: int, T: int, D: int, compute_dtype: torch.dtype | None) -> int:
    """Word slots per sub-caption.  On the packed routes (R <= 256,
    D <= 1024): T where T fits the least rows a pass of the route's three
    kernels (``packed_rows``: no split, as the flagship's T = 20), else half
    of those rows (rows are multiples of 8: 32, 24, 16, 12 or 8 slots), so
    that a caption's last, partial sub-caption shares a pass with the next
    caption's.  On the CUDA cores (R > 256, D <= 1024) and the
    feature-streamed route (D > 1024): the least of T and the route's
    backward rows at R (``cuda_core_rows``, ``fs_rows``), fewer than the
    forward's.  A pure function of the shape: the CPU splits as the card
    does.  Raises only where not one word row fits in shared memory, naming
    the bytes it needs."""
    rt = route("fwd", R, D, compute_dtype)
    if rt in (TENSOR_CORES, PACKED_FP32):
        rows = packed_rows(R, D, compute_dtype)
        return T if T <= rows else rows // 2
    if rt == STREAMED_FEATURES:
        width, (per_row, fixed) = fs_rows(R, backward=True), _fs_smem(R, backward=True)
    else:
        width, (per_row, fixed) = (cuda_core_rows(R, D, backward=True),
                                   _cuda_core_smem(R, D, backward=True))
    if width < 1:
        raise ValueError(f"damsm_score: R={R}, D={D} does not fit in shared memory (a word "
                         f"row of the backward needs {per_row} bytes beside {fixed}, of "
                         f"{SMEM_LIMIT})")
    return min(T, width)


def split_captions(w: torch.Tensor, mask: torch.Tensor,
                   width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Words ``[Bc, T, D]`` and mask ``[Bc, T]`` as sub-captions ``[Bc * k,
    t, D]`` and ``[Bc * k, t]``.  Each caption's real words move to the
    front in their order (a gather, through which autograd scatters d_words
    back) and the slots past the batch's longest caption, n real words
    (at least 1), go; the n slots left become k = ceil(n / t) sub-captions
    of t = min(width, n) slots, the last one zero-padded, its padded slots
    masked (True).  Reading n takes one device-to-host copy."""
    bc, _, d = w.shape
    mask = mask.bool()
    n = max(1, int((~mask).sum(1).max()))
    order = torch.argsort(mask.to(torch.uint8), dim=1, stable=True)[:, :n]
    w = torch.gather(w, 1, order[..., None].expand(bc, n, d))
    mask = torch.gather(mask, 1, order)
    width = min(width, n)
    k = -(-n // width)
    pad = k * width - n
    w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    mask = torch.cat([mask, mask.new_ones(bc, pad)], dim=1)
    return w.reshape(bc * k, width, d), mask.reshape(bc * k, width)


def combine_sub_scores(s: torch.Tensor, gamma2: float) -> torch.Tensor:
    """Sub-caption scores ``[B, Bc, k]`` into caption scores ``[B, Bc]``:
    ``logsumexp_k(gamma2 * s) / gamma2``, taken as ``m + logsumexp_k(gamma2
    * (s - m)) / gamma2`` around the detached ``m = max_k s``.  Its gradient
    is ``g * softmax_k(gamma2 * s)``.  An all-padded sub-caption, at
    ``(-1e30 + log width) / gamma2``, adds exactly 0 beside a real one; a
    fully padded caption keeps its sub-captions' value ``m`` bit for bit
    (``log k / gamma2`` is far below an ulp of 2e29), the plain version's
    ``(-1e30 + log T) / gamma2``, and hands each sub-caption ``g / k``, to
    which the kernels add exactly 0."""
    m = s.detach().amax(-1, keepdim=True)
    return (m + torch.logsumexp(gamma2 * (s - m), -1, keepdim=True) / gamma2).squeeze(-1)


def damsm_scores_ref(r: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                     gamma1: float = 4.0, gamma2: float = 5.0,
                     compute_dtype: torch.dtype | None = None,
                     block_elems: int | None = None) -> torch.Tensor:
    """Plain PyTorch scores ``[B, Bc]`` on normalized ``r``/``w`` (the port's
    one plain implementation: ``losses.word_region_scores`` uses it too).

    Products take operands rounded to ``compute_dtype`` and accumulate in
    fp32 (``x.to(cd).float()``, the JAX ``preferred_element_type`` pattern),
    or in fp64 around the same rounding points where ``r`` and ``w`` are
    fp64 (fp64 scores).  The kernels' checks hold them against the fp64
    sums: where fp32 sums in another order than the kernel's round a bf16
    operand the other way, that operand's ulp would add to the error.
    Above ``block_elems`` elements of the ``[B, Bc, T, R]``
    similarity, the captions stream in blocks under
    ``torch.utils.checkpoint``; the math is the same (no softmax crosses the
    caption axis).
    """
    cd = compute_dtype or torch.float32
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    b, r_regions, _ = r.shape
    bc, t, _ = w.shape
    rc = r.to(cd).to(acc)

    def block(wb: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
        wc = wb.to(cd).to(acc)
        sim = torch.einsum("ctd,ird->ictr", wc, rc)
        attn = torch.softmax(gamma1 * sim, dim=-1)
        ctx = torch.einsum("ictr,ird->ictd", attn.to(cd).to(acc), rc)
        ctx = ctx / ctx.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-12)
        rel = torch.einsum("ictd,ctd->ict", ctx.to(cd).to(acc), wc)
        rel = torch.where(mb[None], NEG, gamma2 * rel)
        return torch.logsumexp(rel, dim=-1) / gamma2

    mask = mask.bool()
    if block_elems is None or b * bc * t * r_regions <= block_elems:
        return block(w, mask)
    c = max(1, min(bc, block_elems // (b * t * r_regions)))
    return torch.cat([checkpoint(block, w[s:s + c], mask[s:s + c], use_reentrant=False)
                      for s in range(0, bc, c)], dim=1)


def _check(r: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, cd) -> None:
    if r.dim() != 3 or w.dim() != 3 or r.shape[2] != w.shape[2]:
        raise ValueError(f"want regions [B, R, D] and words [Bc, T, D], got "
                         f"{tuple(r.shape)} and {tuple(w.shape)}")
    if tuple(mask.shape) != tuple(w.shape[:2]):
        raise ValueError(f"mask must be [Bc, T] = {list(w.shape[:2])}, got {list(mask.shape)}")
    if r.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"normalized operands must be float32, got {r.dtype}, {w.dtype}")
    if cd not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None, float32 or bfloat16, got {cd!r}")
    if not (r.device == w.device == mask.device):
        raise ValueError(f"operands on {r.device}, {w.device}, {mask.device}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"damsm_score runs on CUDA or CPU tensors, got {r.device}")


def _operands(r, w, mask, cd):
    cd = cd or torch.float32
    return (r.to(cd).contiguous(), w.to(cd).contiguous(),
            mask.to(torch.uint8).contiguous(), _DTYPE_CODE[cd])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"damsm_score {what} launch failed: CUDA error {rc}")


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nsplit(device: torch.device, blocks: int, work_units: int) -> int:
    """Splits of the accumulation axis so that ``blocks * nsplit`` fills the
    card about four times over, at most one split per work unit."""
    return max(1, min(work_units, math.ceil(4 * _sms(device) / blocks)))


def fs_nsplit(which: str, b: int, bc: int, T: int, D: int, nsub: int, sms: int) -> int:
    """Splits of the feature-streamed backward's accumulation axis.  The
    d_regions takes none: one block an image sums its captions in order, so
    a data-parallel row block is bit-equal to those rows of the whole launch
    and no ``[B, nsplit, R, D]`` scratch is needed.  The d_words' image
    splits fill the card's ``sms`` with its ``nsub`` caption sub-blocks
    without a second wave (a block takes a multiprocessor's shared memory),
    at most one an image, and at most as many as keep its ``[nsplit, Bc, T,
    D]`` fp32 scratch within ``FS_SCRATCH_BYTES``."""
    if which == "dr":
        return 1
    cap = FS_SCRATCH_BYTES // (4 * bc * T * D)
    return max(1, min(b, sms // nsub, cap))


def _launch_fwd(r, w, mask, gamma1, gamma2, cd,
                library: CudaLibrary | None = None) -> torch.Tensor:
    """One forward launch; ``library`` is the compiled source to launch
    (``KERNEL`` unless given, as ``damsm_phases`` gives its own build)."""
    rr, ww, mm, code = _operands(r, w, mask, cd)
    b, R, D = r.shape
    bc, T, _ = w.shape
    rt = route("fwd", R, D, cd)
    if rt == TENSOR_CORES:  # passes of `rows` word rows, blocks (image, split)
        vb, (rows, nsplit) = 0, plan_fwd(R, T, D, b, bc, _sms(r.device))[:2]
    elif rt == PACKED_FP32:
        vb, (rows, nsplit) = 0, plan_fwd_f32(R, T, D, b, bc, _sms(r.device))[:2]
    else:  # a caption sub-block a block
        vb, rows, nsplit = (plan_fs if rt == STREAMED_FEATURES else plan)(
            R, T, D, False, bc)[0], 0, 1
    out = torch.empty(b, bc, device=r.device, dtype=torch.float32)
    fn = (library or KERNEL).load().xmc_damsm_fwd
    with torch.cuda.device(r.device):
        rc = fn(rr.data_ptr(), ww.data_ptr(), mm.data_ptr(), out.data_ptr(), b, bc, R, T, D,
                vb, rows, nsplit, gamma1, gamma2, code, _ROUTE_CODE[rt], _stream(r))
    _raise_on(rc, "forward")
    FORWARD.launches += 1
    return out


def _launch_bwd(which: str, r, w, mask, g, gamma1, gamma2, cd,
                library: CudaLibrary | None = None) -> torch.Tensor:
    """One backward launch; ``library`` is the compiled source to launch
    (``DR_KERNEL`` for the d_regions, ``DW_KERNEL`` for the d_words, unless
    given, as ``damsm_phases`` gives its own build)."""
    rr, ww, mm, code = _operands(r, w, mask, cd)
    b, R, D = r.shape
    bc, T, _ = w.shape
    g = g.float().contiguous()
    rt = route(which, R, D, cd)
    if rt in (TENSOR_CORES, PACKED_FP32):  # passes of `rows` word rows
        planner = {(TENSOR_CORES, "dr"): plan_dr, (TENSOR_CORES, "dw"): plan_dw,
                   (PACKED_FP32, "dr"): plan_dr_f32, (PACKED_FP32, "dw"): plan_dw_f32}[rt, which]
        vb, (rows, nsplit) = 0, planner(R, T, D, b, bc, _sms(r.device))[:2]
    elif rt == STREAMED_FEATURES:  # a caption sub-block a block
        vb, rows = plan_fs(R, T, D, True, bc)[0], 0
        nsplit = fs_nsplit(which, b, bc, T, D, -(-bc // vb), _sms(r.device))
    else:
        vb, rows = plan(R, T, D, True, bc)[0], 0
        nsub = -(-bc // vb)
        nsplit = _nsplit(r.device, b, nsub) if which == "dr" else _nsplit(r.device, nsub, b)
    lib = (library or (DR_KERNEL if which == "dr" else DW_KERNEL)).load()
    if which == "dr":  # blocks: (image, split); a split owns a run of captions
        out = torch.empty(b, R, D, device=r.device, dtype=torch.float32)
        partial = out if nsplit == 1 else torch.empty(
            b, nsplit, R, D, device=r.device, dtype=torch.float32)
        fn, counter, scratch = lib.xmc_damsm_bwd_dr, D_REGIONS, ()
    else:  # blocks: (caption block or pass, split); a split owns a run of images
        out = torch.empty(bc, T, D, device=r.device, dtype=torch.float32)
        partial = out if nsplit == 1 else torch.empty(
            nsplit, bc, T, D, device=r.device, dtype=torch.float32)
        plan_buf = torch.empty(bc + 2, device=r.device, dtype=torch.int32) \
            if rt in (TENSOR_CORES, PACKED_FP32) else None  # the passes, cut on the card
        fn, counter = lib.xmc_damsm_bwd_dw, D_WORDS
        scratch = (plan_buf.data_ptr() if plan_buf is not None else None,)
    with torch.cuda.device(r.device):
        rc = fn(rr.data_ptr(), ww.data_ptr(), mm.data_ptr(), g.data_ptr(), *scratch,
                partial.data_ptr(), out.data_ptr(), b, bc, R, T, D, vb, rows, nsplit, gamma1,
                gamma2, code, _ROUTE_CODE[rt], _stream(r))
    _raise_on(rc, "d_regions" if which == "dr" else "d_words")
    counter.launches += 1
    return out


def _plain_vjp(which: str, r, w, mask, g, gamma1, gamma2, cd,
               block_elems: int | None = None) -> torch.Tensor:
    """One input's cotangent from autograd of the plain version (streaming
    caption blocks above ``block_elems``, as ``damsm_scores_ref``)."""
    with torch.enable_grad():
        ri = r.detach().requires_grad_(which == "dr")
        wi = w.detach().requires_grad_(which == "dw")
        out = damsm_scores_ref(ri, wi, mask, gamma1, gamma2, cd, block_elems)
        (grad,) = torch.autograd.grad(out, ri if which == "dr" else wi, g)
    return grad


def _d_regions(r, w, mask, g, gamma1, gamma2, cd) -> torch.Tensor:
    if r.device.type == "cpu":
        return _plain_vjp("dr", r, w, mask, g, gamma1, gamma2, cd)
    return _launch_bwd("dr", r, w, mask, g, gamma1, gamma2, cd)


def _d_words(r, w, mask, g, gamma1, gamma2, cd) -> torch.Tensor:
    if r.device.type == "cpu":
        return _plain_vjp("dw", r, w, mask, g, gamma1, gamma2, cd)
    return _launch_bwd("dw", r, w, mask, g, gamma1, gamma2, cd)


class _DamsmScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, w, mask, gamma1, gamma2, cd):
        ctx.save_for_backward(r, w, mask)
        ctx.args = (gamma1, gamma2, cd)
        if r.device.type == "cpu":
            return damsm_scores_ref(r, w, mask, gamma1, gamma2, cd)
        return _launch_fwd(r, w, mask, gamma1, gamma2, cd)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        r, w, mask = ctx.saved_tensors
        need_r, need_w = ctx.needs_input_grad[:2]
        dr = _d_regions(r, w, mask, g, *ctx.args) if need_r else None
        dw = _d_words(r, w, mask, g, *ctx.args) if need_w else None
        return dr, dw, None, None, None, None


def damsm_scores(r: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                 gamma1: float = 4.0, gamma2: float = 5.0,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Scores ``[B, Bc]`` fp32 of normalized fp32 ``r`` ``[B, R, D]`` and
    ``w`` ``[Bc, T, D]``, ``mask`` ``[Bc, T]`` (True = padded word),
    differentiable in ``r`` and ``w``: the CUDA kernels on CUDA tensors, the
    plain version on CPU tensors.  Captions longer than
    ``sub_caption_width`` go through as sub-captions of their real words
    (``split_captions``), combined by ``combine_sub_scores``."""
    _check(r, w, mask, compute_dtype)
    b, R, D = r.shape
    bc, T, _ = w.shape
    width = sub_caption_width(R, T, D, compute_dtype)
    args = (float(gamma1), float(gamma2), compute_dtype)
    if width == T:
        return _DamsmScores.apply(r, w, mask, *args)
    w_sub, m_sub = split_captions(w, mask, width)
    s = _DamsmScores.apply(r, w_sub, m_sub, *args)
    return combine_sub_scores(s.view(b, bc, -1), float(gamma2))
