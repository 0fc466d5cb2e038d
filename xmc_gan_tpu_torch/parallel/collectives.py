"""The step's collectives across the batch's ranks (port of
``xmc_gan_tpu/parallel/collectives.py``).

The JAX step is written over the global batch and GSPMD inserts the
collectives; on ``torch.distributed`` each one is stated here, in the JAX
package's layout: the rank of data index d holds the contiguous rows
``[d*B_local, (d+1)*B_local)`` of the global batch of ``B = B_local * dp``.
Every collective here runs over the mesh's *data group* (the ``dp`` ranks of
this rank's model index); under tensor parallelism the ``tp`` ranks of a
model group hold the same rows and compute the same values, so each data
group sees the whole batch once.

Gradients.  Each rank's loss is chosen so that the mean over the data group
of the per-rank losses is the global loss, and the train step averages the
parameter gradients over the data group (``all_reduce_mean_``, 1/dp).  Then
the average is the global loss's gradient, provided every collective's
backward is its transpose:

* ``all_gather_with_grad``: the transpose of a tiled ``all_gather`` is
  ``psum_scatter`` (the cotangent summed over the data group, each rank
  keeping its rows).  A contrastive loss on gathered features is the same
  value on every rank, so each rank's rows receive dp identical cotangents,
  and the dp cancels the 1/dp of the average (the JAX docstring's argument).
  Keeping only the local cotangent would give these terms a gradient dp
  times too small.
* ``all_reduce_with_grad`` (a sum over the data group): its transpose is the
  sum again; the global-batch BatchNorm statistics of
  ``models/concept_gan.py`` use it.

The model group's collectives (``parallel/tensor.py``) follow the other
convention: a replicated value's cotangent is whole on every rank, so
``gather_from_model``'s backward *slices* and ``copy_to_model``'s *sums*,
and nothing is averaged over the model group.  The word scores' column
blocks (``sharded_word_scores``) use both: ``copy_to_model`` on the regions
(a column block uses them partially: the sum over the model group of the
blocks' d_regions is the whole row block's), ``gather_from_model`` on the
blocks, then ``all_gather_with_grad`` over the data group.

Only ``all_gather``, ``all_reduce`` and ``broadcast`` are called: gloo takes
these for CUDA tensors too (staged through the host), so ranks can share
one card over gloo where NCCL refuses.  Every data-group collective runs on
fp32 (or integer) tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from xmc_gan_tpu_torch import losses
from xmc_gan_tpu_torch.parallel.mesh import Mesh
from xmc_gan_tpu_torch.parallel.tensor import copy_to_model, gather_from_model

__all__ = [
    "all_gather",
    "all_gather_with_grad",
    "all_reduce_with_grad",
    "all_reduce_mean_",
    "global_sent_loss",
    "sharded_word_scores",
    "mismatch_pairs",
]


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, 0)


class _AllGather(torch.autograd.Function):
    """Tiled ``all_gather`` along dim 0; backward ``psum_scatter``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=mesh.data_group)
        return grad[mesh.rows(ctx.n)], None


class _AllReduce(torch.autograd.Function):
    """``all_reduce`` (sum); backward the sum of the cotangents."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.data_group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.mesh.data_group)
        return out, None


def all_gather_with_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along dim 0, in data order, with
    the gradient of ``jax.lax.all_gather(tiled=True)``."""
    return _AllGather.apply(x, mesh)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_gather_with_grad`` without a gradient; a bool tensor crosses as
    bytes."""
    with torch.no_grad():
        if x.dtype == torch.bool:
            return _gather(x.to(torch.uint8), mesh).bool()
        return _gather(x, mesh)


def all_reduce_with_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every data rank's ``x`` (``jax.lax.psum``), differentiable."""
    return _AllReduce.apply(x, mesh)


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor], mesh: Mesh, world: bool = False) -> None:
    """Replace each tensor by its mean over the data group (``world``: over
    every rank), in place: one ``all_reduce`` of their concatenation.  Every
    rank ends with the same bits (the reduction's result is broadcast, not
    recomputed per rank)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=None if world else mesh.data_group)
    flat.mul_(1.0 / (mesh.world if world else mesh.dp))
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def global_sent_loss(img_feats: torch.Tensor, txt_feats: torch.Tensor,
                     sent_embs: torch.Tensor, b_global: bool, smooth_global: float,
                     mesh: Mesh) -> torch.Tensor:
    """Per-rank body (JAX ``global_sent_loss``): gather the local features
    and sentences over the ranks, then the sentence-image InfoNCE and its
    labels over the global batch.  The same value on every rank."""
    img_g = all_gather_with_grad(img_feats.float(), mesh)
    txt_g = all_gather_with_grad(txt_feats.float(), mesh)
    labels = losses.make_labels(all_gather(sent_embs.float(), mesh), b_global, smooth_global)
    return losses.sent_loss(img_g, txt_g, labels, b_global, smooth_global)


def sharded_word_scores(regions: torch.Tensor, words: torch.Tensor, mask: torch.Tensor,
                        mesh: Mesh, gamma1: float = 4.0, gamma2: float = 5.0,
                        block_elems: int | None = losses.WORD_LOSS_BLOCK_ELEMS,
                        compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The global ``[B, B]`` word-region score matrix, row block by row block
    and, under tensor parallelism, column block by column block (JAX
    ``make_sharded_word_scores``).

    Regions stay local ``[B_local, R, D]``; words and mask are gathered over
    the data group to ``[B, T, D]`` / ``[B, T]``.  With ``tp`` dividing
    ``B``, model rank m scores its images against the captions ``[m*B/tp,
    (m+1)*B/tp)``, the ``[B_local, B/tp]`` column block, and the blocks are
    gathered over the model group into the ``[B_local, B]`` row block;
    otherwise (and at tp = 1) every rank scores all ``B`` captions, as JAX
    does (``collectives.py:112``).  Each block goes through
    ``losses.word_region_scores``, so through the damsm kernels on the card
    wherever ``word_scores_backend`` picks them (at B != Bc), and the row
    blocks are gathered, with gradient, into the whole matrix that
    ``word_loss_from_scores`` takes.  ``d_regions`` stays local (summed over
    the model group's column blocks by ``copy_to_model``); the words'
    cotangent returns through the gathers' transposes."""
    words_g = all_gather_with_grad(words.float(), mesh)
    mask_g = all_gather(mask, mesh)
    b = words_g.shape[0]
    if mesh.tp > 1 and b % mesh.tp == 0:
        cols = slice(mesh.model_rank * (b // mesh.tp), (mesh.model_rank + 1) * (b // mesh.tp))
        block = losses.word_region_scores(
            copy_to_model(regions, mesh), copy_to_model(words_g, mesh)[cols], mask_g[cols],
            gamma1, gamma2, block_elems, compute_dtype)
        block = gather_from_model(block, mesh, 1)
    else:
        block = losses.word_region_scores(regions, words_g, mask_g, gamma1, gamma2, block_elems,
                                          compute_dtype)
    return all_gather_with_grad(block, mesh)


def mismatch_pairs(feats: torch.Tensor, psent: torch.Tensor, mesh: Mesh
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The RMIS pairs of this rank: the single step pairs image ``i`` with
    sentence ``i + 1`` over the *global* batch (``B - 1`` pairs).  Returns
    this rank's images (all of them, or all but the last on the last data
    rank), the sentences they pair with (the next data rank's first one
    across the boundary; ``psent`` is detached, so the gather carries no
    gradient) and the global pair count ``B - 1``."""
    n = feats.shape[0]
    psent_g = all_gather(psent.float(), mesh).to(psent.dtype)
    start = mesh.data_rank * n + 1
    stop = min(start + n, psent_g.shape[0])
    return feats[: stop - start], psent_g[start:stop], psent_g.shape[0] - 1
