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

Contract of ``damsm_scores`` (a ``torch.autograd.Function``):

* A CPU tensor goes to the plain version (``damsm_scores_ref``, forward and
  VJP); a CUDA tensor launches the kernels or raises.  No fallback.
* The backward computes only what ``ctx.needs_input_grad`` asks for: in the
  train step the words carry no gradient, so the d_words kernel never runs.
* It is not twice differentiable (``once_differentiable``).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary, LaunchCount

__all__ = [
    "NEG",
    "KERNEL",
    "FORWARD",
    "D_REGIONS",
    "D_WORDS",
    "damsm_scores",
    "damsm_scores_ref",
    "plan",
]

NEG = -1e30  # padded-word logit, the JAX package's constant

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# int xmc_damsm_fwd(r, w, mask, out, B, Bc, R, T, D, vb, gamma1, gamma2, dtype, stream)
# int xmc_damsm_bwd_dr(r, w, mask, g, partial, dr, B, Bc, R, T, D, vb, nsplit,
#                      gamma1, gamma2, dtype, stream)   (and xmc_damsm_bwd_dw, the same)
_BWD = (_I, [_P] * 6 + [_I] * 7 + [_F, _F, _I, _P])
KERNEL = CudaLibrary("damsm_score.cu", {
    "xmc_damsm_fwd": (_I, [_P] * 4 + [_I] * 6 + [_F, _F, _I, _P]),
    "xmc_damsm_bwd_dr": _BWD,
    "xmc_damsm_bwd_dw": _BWD,
})
FORWARD = LaunchCount()
D_REGIONS = LaunchCount()
D_WORDS = LaunchCount()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Kernel limits, mirrored from csrc/damsm_score.cu: word rows per block (a
# sub-block of vb captions has vb*T rows), padded feature width, region rows
# per staged tile, shared memory a block may use.
MAX_ROWS = 64
MAX_DP = 256
RT = 32
SMEM_LIMIT = 232448


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(R: int, T: int, D: int, backward: bool, bc: int) -> tuple[int, int]:
    """(captions per block ``vb``, dynamic shared memory bytes) for one
    kernel: as many captions as shared memory holds, at most ``bc``.  Raises
    where even one caption does not fit (T > 64 or D > 256)."""
    dp = _round_up(D, 8)
    if T > MAX_ROWS or dp > MAX_DP:
        raise ValueError(f"damsm_score kernels take T <= {MAX_ROWS} and D <= {MAX_DP}; "
                         f"got T={T}, D={D}")
    sr = _round_up(R, RT)
    per_row = 4 * (2 * dp + (2 if backward else 1) * sr + 4)
    fixed = 4 * RT * (dp + 4)
    vb = min(MAX_ROWS // T, (SMEM_LIMIT - fixed) // (per_row * T), bc)
    if vb < 1:
        raise ValueError(f"damsm_score: R={R}, T={T}, D={D} does not fit in shared memory")
    return vb, fixed + per_row * vb * T


def damsm_scores_ref(r: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                     gamma1: float = 4.0, gamma2: float = 5.0,
                     compute_dtype: torch.dtype | None = None,
                     block_elems: int | None = None) -> torch.Tensor:
    """Plain PyTorch scores ``[B, Bc]`` on normalized ``r``/``w`` (the port's
    one plain implementation: ``losses.word_region_scores`` uses it too).

    Products take operands rounded to ``compute_dtype`` and accumulate in
    fp32 (``x.to(cd).float()``, the JAX ``preferred_element_type`` pattern).
    Above ``block_elems`` fp32 elements of the ``[B, Bc, T, R]``
    similarity, the captions stream in blocks under
    ``torch.utils.checkpoint``; the math is the same (no softmax crosses the
    caption axis).
    """
    cd = compute_dtype or torch.float32
    b, r_regions, _ = r.shape
    bc, t, _ = w.shape
    rc = r.to(cd).float()

    def block(wb: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
        wc = wb.to(cd).float()
        sim = torch.einsum("ctd,ird->ictr", wc, rc)
        attn = torch.softmax(gamma1 * sim, dim=-1)
        ctx = torch.einsum("ictr,ird->ictd", attn.to(cd).float(), rc)
        ctx = ctx / ctx.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-12)
        rel = torch.einsum("ictd,ctd->ict", ctx.to(cd).float(), wc)
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


def _nsplit(device: torch.device, blocks: int, work_units: int) -> int:
    """Splits of the accumulation axis so that ``blocks * nsplit`` fills the
    card about four times over, at most one split per work unit."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(work_units, math.ceil(4 * sms / blocks)))


def _launch_fwd(r, w, mask, gamma1, gamma2, cd) -> torch.Tensor:
    rr, ww, mm, code = _operands(r, w, mask, cd)
    b, R, D = r.shape
    bc, T, _ = w.shape
    vb, _ = plan(R, T, D, False, bc)
    out = torch.empty(b, bc, device=r.device, dtype=torch.float32)
    fn = KERNEL.load().xmc_damsm_fwd
    with torch.cuda.device(r.device):
        rc = fn(rr.data_ptr(), ww.data_ptr(), mm.data_ptr(), out.data_ptr(), b, bc, R, T, D,
                vb, gamma1, gamma2, code, _stream(r))
    _raise_on(rc, "forward")
    FORWARD.launches += 1
    return out


def _launch_bwd(which: str, r, w, mask, g, gamma1, gamma2, cd) -> torch.Tensor:
    rr, ww, mm, code = _operands(r, w, mask, cd)
    b, R, D = r.shape
    bc, T, _ = w.shape
    vb, _ = plan(R, T, D, True, bc)
    nsub = -(-bc // vb)
    g = g.float().contiguous()
    if which == "dr":  # blocks: (image, split); a split owns a run of caption blocks
        nsplit = _nsplit(r.device, b, nsub)
        out = torch.empty(b, R, D, device=r.device, dtype=torch.float32)
        partial = out if nsplit == 1 else torch.empty(
            b, nsplit, R, D, device=r.device, dtype=torch.float32)
        fn, counter = KERNEL.load().xmc_damsm_bwd_dr, D_REGIONS
    else:  # blocks: (caption block, split); a split owns a run of images
        nsplit = _nsplit(r.device, nsub, b)
        out = torch.empty(bc, T, D, device=r.device, dtype=torch.float32)
        partial = out if nsplit == 1 else torch.empty(
            nsplit, bc, T, D, device=r.device, dtype=torch.float32)
        fn, counter = KERNEL.load().xmc_damsm_bwd_dw, D_WORDS
    with torch.cuda.device(r.device):
        rc = fn(rr.data_ptr(), ww.data_ptr(), mm.data_ptr(), g.data_ptr(), partial.data_ptr(),
                out.data_ptr(), b, bc, R, T, D, vb, nsplit, gamma1, gamma2, code, _stream(r))
    _raise_on(rc, "d_regions" if which == "dr" else "d_words")
    counter.launches += 1
    return out


def _plain_vjp(which: str, r, w, mask, g, gamma1, gamma2, cd) -> torch.Tensor:
    """One input's cotangent from autograd of the plain version."""
    with torch.enable_grad():
        ri = r.detach().requires_grad_(which == "dr")
        wi = w.detach().requires_grad_(which == "dw")
        out = damsm_scores_ref(ri, wi, mask, gamma1, gamma2, cd)
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
    plain version on CPU tensors."""
    _check(r, w, mask, compute_dtype)
    return _DamsmScores.apply(r, w, mask, float(gamma1), float(gamma2), compute_dtype)
