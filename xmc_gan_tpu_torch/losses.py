"""Loss functions of the XMC-GAN train step (port of ``xmc_gan_tpu/losses.py``).

* soft pseudo-positive label matrix   — reference ``train_gan.py:72-83``
* cosine similarity scores            — reference ``train_gan.py:85-91``
* symmetric sentence-image InfoNCE    — reference ``train_gan.py:93-115``
* symmetric real-fake image InfoNCE   — reference ``train_gan.py:117-139``
* word-region (DAMSM) InfoNCE         — the JAX package's ``word_loss``
* hinge D losses / non-saturating G   — reference ``train_gan.py:195,204,209,261``
* MAGP gradient penalty               — reference ``train_gan.py:231-252``

All functions work over the whole batch.  Log-softmax, the contrastive
scores and the gradient-penalty norm are computed in float32 even when
activations are bf16.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from xmc_gan_tpu_torch.ops.cuda.damsm_score import (damsm_scores, damsm_scores_ref,
                                                 sub_caption_width)

__all__ = [
    "WORD_LOSS_BLOCK_ELEMS",
    "l2_normalize",
    "cosine_scores",
    "make_labels",
    "contrastive_num_pos",
    "sent_loss",
    "img_loss",
    "word_loss",
    "word_loss_from_scores",
    "word_region_scores",
    "word_scores_backend",
    "hinge_real",
    "hinge_fake",
    "generator_loss",
    "magp_penalty",
]

# Largest [B_img, B_cap, T, R] similarity intermediate the plain word-score
# path materializes at once, in fp32 elements (2**26 = 256 MB); above it the
# captions stream in checkpointed blocks, and on the card the fused kernel
# takes over (``word_scores_backend``).
WORD_LOSS_BLOCK_ELEMS = 2**26

_WORD_COMPUTE_DTYPES = (None, torch.float32, torch.bfloat16)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||_2, eps)`` along ``dim`` (``F.normalize(p=2)`` semantics)."""
    return x / x.square().sum(dim, keepdim=True).sqrt().clamp_min(eps)


def cosine_scores(emb0: torch.Tensor, emb1: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity matrix ``[B0, D] x [B1, D] -> [B0, B1]`` in fp32."""
    if emb0.shape[-1] != emb1.shape[-1]:
        raise ValueError(
            f"contrastive embeddings have mismatched feature dims {emb0.shape[-1]} vs "
            f"{emb1.shape[-1]}; with ENCODER_LOSS.SENT set DISC.IMG_MATCH or "
            "DISC.SENT_MATCH so image and sentence features share a projection space"
        )
    return l2_normalize(emb0.float(), 1) @ l2_normalize(emb1.float(), 1).T


@torch.no_grad()
def make_labels(sent_embs: torch.Tensor, b_global: bool, smooth_global: float,
                p: float = 0.6) -> torch.Tensor:
    """Soft pseudo-positive label matrix (reference ``make_labels``).

    Identity labels, plus off-diagonal soft positives for caption pairs whose
    sentence cosine exceeds ``p`` when ``b_global``.  With ``smooth_global``
    zero the weight is ``1 / num_pos`` per *column* (the reference broadcasts
    the ``[bs]`` reciprocal across rows: ``labels[i, j] = 1 / num_pos[j]``),
    with ``num_pos = clamp(#positives, min=1) + 1``.  No gradient.
    """
    b = sent_embs.shape[0]
    labels = torch.eye(b, dtype=torch.float32, device=sent_embs.device)
    if b_global:
        eye = labels.bool()
        sim = cosine_scores(sent_embs, sent_embs).masked_fill(eye, 3.0)
        global_pos = (sim > p) & (sim < 3.0)
        num_pos = global_pos.sum(1).clamp_min(1) + 1
        if smooth_global != 0.0:
            weight = torch.full((), smooth_global, dtype=torch.float32, device=labels.device)
        else:
            weight = (1.0 / num_pos.float())[None, :]
        labels = (labels + weight * global_pos.float()).clamp_max(1.0)
    return labels


def contrastive_num_pos(labels: torch.Tensor, b_global: bool,
                        smooth_global: float) -> torch.Tensor:
    """Per-row positive count used as the InfoNCE normalizer."""
    if not b_global:
        return torch.full((), 1.0, device=labels.device)
    if smooth_global == 0.0:
        return torch.full((), 2.0, device=labels.device)
    return (labels > 0).sum(1).float()


def _symmetric_info_nce(scores: torch.Tensor, labels: torch.Tensor,
                        num_pos: torch.Tensor) -> torch.Tensor:
    """Label-weighted negative log-softmax along each axis, normalized by
    ``num_pos``, averaged (shared body of ``sent_loss``/``img_loss``)."""
    s0 = -(F.log_softmax(scores, dim=0) * labels).sum(0) / num_pos
    s1 = -(F.log_softmax(scores, dim=1) * labels).sum(1) / num_pos
    return s0.mean() + s1.mean()


def sent_loss(img_feats: torch.Tensor, txt_feats: torch.Tensor, labels: torch.Tensor,
              b_global: bool, smooth_global: float) -> torch.Tensor:
    """Sentence-image contrastive loss (reference ``sent_loss``)."""
    num_pos = contrastive_num_pos(labels, b_global, smooth_global)
    return _symmetric_info_nce(cosine_scores(img_feats, txt_feats), labels, num_pos)


def img_loss(real_feats: torch.Tensor, fake_feats: torch.Tensor, labels: torch.Tensor,
             b_global: bool, smooth_global: float) -> torch.Tensor:
    """Real-fake image contrastive loss (reference ``img_loss``)."""
    num_pos = contrastive_num_pos(labels, b_global, smooth_global)
    return _symmetric_info_nce(cosine_scores(real_feats, fake_feats), labels, num_pos)


def word_scores_backend(b: int, bc: int, t: int, r_regions: int, block_elems: int | None,
                        device: torch.device) -> str:
    """``"kernel"`` (the fused CUDA kernels of ``ops/cuda/damsm_score.py``)
    exactly where the plain path would stream caption blocks and the operands
    lie on the card; ``"plain"`` otherwise.  The same rule as the JAX
    package's, with "CUDA tensor" in place of "TPU backend"."""
    big = block_elems is not None and b * bc * t * r_regions > block_elems
    return "kernel" if big and torch.device(device).type == "cuda" else "plain"


def word_region_scores(region_feats: torch.Tensor, words_embs: torch.Tensor,
                       mask: torch.Tensor, gamma1: float = 4.0, gamma2: float = 5.0,
                       block_elems: int | None = WORD_LOSS_BLOCK_ELEMS,
                       compute_dtype: torch.dtype | None = None,
                       backend: str | None = None) -> torch.Tensor:
    """Pairwise attentional word-region matching scores ``[B_img, B_cap]``.

    Per (image i, caption j): each word of j soft-attends over the regions of
    i (temperature ``gamma1``), the cosines between attention context and
    word aggregate by log-sum-exp with ``gamma2``, padded words (``mask``
    True) excluded (DAMSM paper eqs. 7-10, as the JAX package).

    ``region_feats`` ``[B, R, D]``, ``words_embs`` ``[Bc, T, D]``, ``mask``
    ``[Bc, T]``.  Both are l2-normalized here, in autograd; then ``backend``
    (default: ``word_scores_backend``) picks the plain path
    (``damsm_score.damsm_scores_ref``: one einsum chain, or checkpointed
    caption blocks above ``block_elems``) or the fused kernels
    (``damsm_score.damsm_scores``: any T, as sub-captions; D <= 1024), whose
    limits on the shape (``damsm_score.sub_caption_width``) raise here,
    before any work.  An explicit ``backend`` is obeyed; there is no
    fallback between the two.
    ``compute_dtype`` (None, fp32 or bf16) is the operand type of the three
    pairwise products; accumulation and the reductions stay fp32.
    """
    if compute_dtype not in _WORD_COMPUTE_DTYPES:
        raise ValueError(f"word_region_scores: compute_dtype must be one of "
                         f"{_WORD_COMPUTE_DTYPES}, got {compute_dtype!r}")
    b, r_regions, _ = region_feats.shape
    bc, t, _ = words_embs.shape
    if backend is None:
        backend = word_scores_backend(b, bc, t, r_regions, block_elems, region_feats.device)
    if backend == "kernel":
        sub_caption_width(r_regions, t, region_feats.shape[2], compute_dtype)
    r = l2_normalize(region_feats.float())
    w = l2_normalize(words_embs.float())
    if backend == "kernel":
        return damsm_scores(r, w, mask, gamma1, gamma2, compute_dtype)
    if backend == "plain":
        return damsm_scores_ref(r, w, mask, gamma1, gamma2, compute_dtype, block_elems)
    raise ValueError(f"unknown word-score backend {backend!r}; use 'plain' or 'kernel'")


def word_loss(region_feats: torch.Tensor, words_embs: torch.Tensor, mask: torch.Tensor,
              labels: torch.Tensor, b_global: bool, smooth_global: float,
              gamma1: float = 4.0, gamma2: float = 5.0, gamma3: float = 10.0,
              block_elems: int | None = WORD_LOSS_BLOCK_ELEMS,
              compute_dtype: torch.dtype | None = None,
              backend: str | None = None) -> torch.Tensor:
    """Word-region attentional contrastive loss: ``word_region_scores``
    scaled by ``gamma3`` into the symmetric InfoNCE of ``sent_loss``."""
    scores = word_region_scores(region_feats, words_embs, mask, gamma1, gamma2,
                                block_elems, compute_dtype, backend)
    return word_loss_from_scores(scores, labels, b_global, smooth_global, gamma3)


def word_loss_from_scores(scores: torch.Tensor, labels: torch.Tensor, b_global: bool,
                          smooth_global: float, gamma3: float = 10.0) -> torch.Tensor:
    """InfoNCE half of ``word_loss`` over precomputed matching scores."""
    num_pos = contrastive_num_pos(labels, b_global, smooth_global)
    return _symmetric_info_nce(gamma3 * scores, labels, num_pos)


def hinge_real(logits: torch.Tensor) -> torch.Tensor:
    """``mean(relu(1 - out))`` on real/matching pairs."""
    return F.relu(1.0 - logits.float()).mean()


def hinge_fake(logits: torch.Tensor) -> torch.Tensor:
    """``mean(relu(1 + out))`` on fake or mismatched pairs."""
    return F.relu(1.0 + logits.float()).mean()


def generator_loss(logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating G loss ``-mean(out)``."""
    return -logits.float().mean()


def magp_penalty(d_scalar_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 imgs: torch.Tensor, sent_embs: torch.Tensor) -> torch.Tensor:
    """Matching-Aware Gradient Penalty ``2 * mean(||grad_{img,sent} D||_2^6)``.

    ``d_scalar_fn(imgs, sent)`` returns the sum of D's match logits over the
    batch.  The inputs are detached leaves (the reference re-wraps ``.data``);
    the gradient is built with ``create_graph=True``, so the penalty is
    differentiable in D's parameters.  The norm is accumulated in fp32.
    """
    imgs = imgs.detach().requires_grad_(True)
    sent_embs = sent_embs.detach().requires_grad_(True)
    g_img, g_sent = torch.autograd.grad(d_scalar_fn(imgs, sent_embs), (imgs, sent_embs),
                                        create_graph=True)
    bs = imgs.shape[0]
    sq = (g_img.float().reshape(bs, -1).square().sum(1)
          + g_sent.float().reshape(bs, -1).square().sum(1))
    return 2.0 * (sq.sqrt() ** 6).mean()
