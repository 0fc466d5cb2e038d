"""The train step, the train state and the sampler (port of ``xmc_gan_tpu/train.py``).

One call of the step reproduces the JAX package's ``train_step``
(``xmc_gan_tpu/train.py:154-495``, reference ``train_gan.py:174-289``):

1. **Spectral refresh** — ``spectral_iters`` power-iteration steps on D's
   ``weight_u``/``weight_v`` buffers from the pre-update D weights; the
   refreshed vectors serve every D apply of the step.
2. **D update** — hinge real/fake (+ the RMIS mismatch on
   ``feats_real[:B-1]`` vs ``psent[1:]``) + the weighted sentence and
   word-region InfoNCE on the real images, one Adam step.
3. **MAGP update** — the gradient penalty at the post-update D, a second
   Adam step on the same optimizer state.
4. **G update** — every ``N_CRITIC`` steps: non-saturating loss + sentence,
   word-region and real-fake image InfoNCE against the twice-updated D, and
   with ``ENCODER_LOSS.VGG`` the image-image InfoNCE over frozen VGG-19
   features (``models/vgg.py``; the step's 4th argument).  Gradients reach
   ``G.proj_sent`` through D's conditioning.

``psent`` (G's sentence projection; the raw sentence with ``DISC.SEPERATE``,
``xmc_gan_tpu/train.py:253-256``) conditions D detached; the fake image is
generated once without gradient for D and again under autograd for G, from
the same noise.  The noise is an input of the step, so the tests can feed
the JAX package's draw.  Unlike the JAX step the state is updated in place.

Data parallelism (``mesh``, a ``parallel.Mesh``; JAX ``train.py``'s GSPMD
step): each rank holds its contiguous rows of the global batch and of G's
noise, and every term that crosses rows crosses ranks
(``parallel/collectives.py``): the labels come from the gathered sentences,
the sentence, real-fake image and VGG InfoNCE run on gathered features, the
word loss on the row-block scores (``sharded_word_scores``), and RMIS pairs
image ``i`` with sentence ``i + 1`` over the global batch.  Each rank's loss
is chosen so that the mean over ranks is the global loss (RMIS: this rank's
hinge sum times ``dp / (B - 1)``; the hinge terms, G's loss and MAGP:
local means), and each Adam step takes the ranks' mean gradient, so every
rank's state stays that of one process's step on the whole batch.  The
metrics are the global ones, averaged on the device: the step makes no host
read.

Tensor parallelism (a mesh with ``tp`` > 1, the state split by
``parallel.shard_state``): the ``tp`` ranks of a model group hold the same
rows and each computes the rows of the split layers' outputs that its
weight shard gives (``parallel/tensor.py``), so the gathers and RMIS's
pairs run over the *data group*, and a split weight's gradient (its own
rows') is averaged over the data group.  A replicated leaf's gradient is
whole and alike on the ranks of a model group; it is averaged over every
rank, which is the data group's mean and keeps the replicas bit-equal where
the card's kernels are not deterministic; the metrics likewise.  The word
scores split the captions over the model group as well
(``sharded_word_scores``' column blocks), and the spectral refresh of a
split layer sums and gathers over the model group
(``refresh_sharded_spectral``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from xmc_gan_tpu_torch import losses
from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.device import resolve_device
from xmc_gan_tpu_torch.models.concept_gan import set_mesh
from xmc_gan_tpu_torch.ops.images import to_unit_range
from xmc_gan_tpu_torch.ops.modules import avg_pool
from xmc_gan_tpu_torch.parallel.collectives import (
    all_gather,
    all_gather_with_grad,
    all_reduce_mean_,
    mismatch_pairs,
    sharded_word_scores,
)
from xmc_gan_tpu_torch.parallel.mesh import Mesh
from xmc_gan_tpu_torch.parallel.tensor import refresh_sharded_spectral, sharded_tensors
from xmc_gan_tpu_torch.registry import get_discriminator, get_generator
from xmc_gan_tpu_torch.utils.convert import load_state_dict

__all__ = [
    "TrainState",
    "make_models",
    "make_optimizers",
    "create_train_state",
    "matricize_spectral_kernel",
    "refresh_spectral",
    "make_train_step",
    "make_generator",
    "make_sample_fn",
]


@dataclass
class TrainState:
    """The optimization state of the alternating GAN step (updated in place).

    D's power-iteration vectors live in D as the ``weight_u``/``weight_v``
    buffers of its spectral-normalized layers."""

    step: int
    g: nn.Module
    d: nn.Module
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam


def make_models(cfg: Config, dtype: torch.dtype = torch.float32, *, seed: int = 0
                ) -> tuple[nn.Module, nn.Module]:
    """(G, D) on the CPU with fp32 parameters and ``dtype`` activations,
    drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    g = get_generator(cfg.GEN.ENCODER_NAME or "DF_GEN")(cfg, dtype=dtype, gen=gen)
    d = get_discriminator(cfg.DISC.ENCODER_NAME or "DF_DISC")(cfg, dtype=dtype, gen=gen)
    return g, d


def make_optimizers(cfg: Config, g: nn.Module, d: nn.Module
                    ) -> tuple[torch.optim.Adam, torch.optim.Adam]:
    """The Adam pair of reference ``train_gan.py:483-484``: eps=1e-8, no
    weight decay, learning rates and betas from ``TRAIN.OPT``."""
    opt = cfg.TRAIN.OPT
    g_opt = torch.optim.Adam(g.parameters(), lr=opt.G_LR, betas=(opt.G_BETA1, opt.G_BETA2),
                             eps=1e-8)
    d_opt = torch.optim.Adam(d.parameters(), lr=opt.D_LR, betas=(opt.D_BETA1, opt.D_BETA2),
                             eps=1e-8)
    return g_opt, d_opt


def create_train_state(cfg: Config, dtype: torch.dtype = torch.float32,
                       device: str | torch.device | None = None, *, seed: int = 0,
                       g_state_dict: Mapping[str, torch.Tensor] | None = None,
                       d_state_dict: Mapping[str, torch.Tensor] | None = None,
                       step: int = 0) -> TrainState:
    """Models and fresh Adam optimizers on ``device`` (default ``cuda``).
    The parameters are drawn from ``seed`` unless ``g_state_dict`` /
    ``d_state_dict`` give them (loaded strictly)."""
    dev = resolve_device(device)
    g, d = make_models(cfg, dtype, seed=seed)
    if g_state_dict is not None:
        g.load_state_dict(g_state_dict, strict=True)
    if d_state_dict is not None:
        d.load_state_dict(d_state_dict, strict=True)
    g, d = g.to(dev).train(), d.to(dev).train()
    return TrainState(step, g, d, *make_optimizers(cfg, g, d))


def matricize_spectral_kernel(weight: torch.Tensor) -> torch.Tensor:
    """The power-iteration operand of a spectral-normalized weight: the
    ``(out, -1)`` view, torch ``spectral_norm``'s (conv weights flatten as
    ``(O, I*kH*kW)``; the JAX package's HWIO kernels as ``(O, kH*kW*I)``,
    a permutation of the columns that the power iteration carries over to
    ``v`` alone)."""
    return weight.reshape(weight.shape[0], -1)


@torch.no_grad()
def refresh_spectral(model: nn.Module, iters: int = 1) -> None:
    """``iters`` power-iteration steps for every spectral-normalized layer of
    ``model``, from its current weights, into its ``weight_u``/``weight_v``
    buffers (the JAX package's ``refresh_spectral``; 1 per step is the
    default there, 5 the reference's per-forward count).  A layer split by
    tensor parallelism refreshes over its model group."""
    for m in model.modules():
        if not getattr(m, "spec_norm", False):
            continue
        if getattr(m, "shard", None) is not None:
            refresh_sharded_spectral(m, iters)
            continue
        w = matricize_spectral_kernel(m.weight.float())
        u, v = m.weight_u, m.weight_v
        for _ in range(iters):
            v = w.T @ u
            v = v / v.norm().clamp_min(1e-12)
            u = w @ v
            u = u / u.norm().clamp_min(1e-12)
        m.weight_u.copy_(u)
        m.weight_v.copy_(v)


def _tensor(x: Any, dev: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))).to(dev)


def _adam_step(opt: torch.optim.Adam, loss: torch.Tensor, params: list,
               mesh: Mesh | None = None, split: frozenset = frozenset()) -> None:
    """One Adam step on ``loss``'s gradient in ``params`` (under ``mesh``,
    the mean of the data group's gradients for the split weights, whose
    ``id`` is in ``split``, and of every rank's for the rest).  A parameter
    the loss does not reach gets a zero gradient, not none: optax updates
    every leaf (the moments decay), while torch's Adam would skip it.

    The ranks of a model group compute a replicated leaf's gradient alike,
    so its mean over every rank is its data group's; taking it over every
    rank keeps the replicas bit-equal where the card's kernels are not
    deterministic (atomics, per-process algorithm choices)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    if mesh is not None:
        all_reduce_mean_([p.grad for p in params if id(p) in split], mesh)
        all_reduce_mean_([p.grad for p in params if id(p) not in split], mesh, world=True)
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_step(cfg: Config, word_block_elems: int | None = None,
                    spectral_iters: int = 1, mesh: Mesh | None = None) -> Callable[..., dict]:
    """The step ``train_step(state, batch, noise, vgg=None) -> metrics`` for ``cfg``.

    ``batch`` holds ``imgs`` ``[B, H, W, 3]`` (uint8, normalized on the
    device, or float in [-1, 1]), ``sent_embs`` ``[B, E]`` and, with
    ``ENCODER_LOSS.WORD``, ``words_embs`` ``[B, T, E]`` and ``mask`` ``[B, T]``
    (True = padded word), as numpy arrays or tensors; ``noise`` is
    ``[B, NOISE_DIM]``; ``vgg`` is the frozen ``models.vgg.VGG19Features``
    that ``ENCODER_LOSS.VGG`` needs (``ValueError`` without it).  Everything
    runs on the state's device in the models' activation dtype; the
    word-score products take bf16 operands when that dtype is bf16.
    ``word_block_elems`` overrides ``losses.WORD_LOSS_BLOCK_ELEMS`` (0 sends
    every word-score call on the card to the fused kernels).  The metrics are 0-d tensors on the device,
    with the JAX step's keys.

    ``mesh`` (a ``parallel.Mesh``): the step of one data-parallel rank,
    whose ``batch`` and ``noise`` are its rows of the global batch (module
    docstring); every rank must call it, in the same order.  The state must
    start equal on every rank (``parallel.replicate``) and stays so; with
    ``mesh.tp`` > 1 it must be split first (``parallel.shard_state``, which
    the step checks), and each rank's split weights stay its own rows.

    Building the step turns TF32 off once, process-wide, so fp32 runs on the
    card are full fp32 as in the JAX package.
    """
    t = cfg.TRAIN
    el = t.ENCODER_LOSS
    if el.SENT and not (cfg.DISC.SENT_MATCH or cfg.DISC.IMG_MATCH):
        raise ValueError(
            "ENCODER_LOSS.SENT requires DISC.SENT_MATCH or DISC.IMG_MATCH (the reference "
            "asserts this, train_gan.py:217): the sentence contrastive loss needs image "
            "and sentence features projected into a shared space")
    use_labels = el.SENT or el.WORD or el.DISC or el.VGG
    block_elems = losses.WORD_LOSS_BLOCK_ELEMS if word_block_elems is None else word_block_elems
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def word_loss(regions, words, mask, labels, compute_dtype):
        if mesh is None:
            scores = losses.word_region_scores(regions, words, mask, t.SMOOTH.GAMMA1,
                                               t.SMOOTH.GAMMA2, block_elems, compute_dtype)
        else:
            scores = sharded_word_scores(regions, words, mask, mesh, t.SMOOTH.GAMMA1,
                                         t.SMOOTH.GAMMA2, block_elems, compute_dtype)
        return losses.word_loss_from_scores(scores, labels, el.B_GLOBAL, t.SMOOTH.GLOBAL,
                                            t.SMOOTH.GAMMA3)

    def gather(x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of a contrastive operand, with gradient."""
        return x if mesh is None else all_gather_with_grad(x.float(), mesh)

    def mismatch(d: nn.Module, feats_real: torch.Tensor, psent: torch.Tensor,
                 zero: torch.Tensor) -> torch.Tensor:
        """RMIS: image i against sentence i + 1 over the global batch."""
        bs = feats_real.shape[0]
        if mesh is None:
            return losses.hinge_fake(d.logits(feats_real[: bs - 1], psent[1:bs])[0])
        feats, sents, pairs = mismatch_pairs(feats_real, psent, mesh)
        if feats.shape[0] == 0:
            return zero
        hinge = torch.relu(1.0 + d.logits(feats, sents)[0].float()).sum()
        return hinge * (mesh.dp / pairs)

    def project_sent(g: nn.Module, sent: torch.Tensor) -> torch.Tensor:
        return sent if cfg.DISC.SEPERATE else g.project_sent(sent)

    def train_step(state: TrainState, batch: dict, noise: Any,
                   vgg: nn.Module | None = None) -> dict:
        if el.VGG and vgg is None:
            raise ValueError("ENCODER_LOSS.VGG is on: pass the frozen VGG-19 as the step's "
                             "4th argument (models.vgg.make_vgg)")
        g, d = state.g, state.d
        if mesh is not None and mesh.tp > 1 and not (
                getattr(g, "tp_mesh", None) is mesh and getattr(d, "tp_mesh", None) is mesh):
            raise ValueError(f"a tp={mesh.tp} step needs the state split over its mesh first: "
                             "parallel.shard_state(state, mesh)")
        set_mesh(g, mesh)
        split = frozenset(sharded_tensors(g) | sharded_tensors(d))
        if el.WORD and getattr(d, "region_proj", None) is None:
            raise NotImplementedError(
                f"ENCODER_LOSS.WORD needs a discriminator with a region head; "
                f"{type(d).__name__} has none")
        dev = next(d.parameters()).device
        dtype = d.dtype
        word_dtype = torch.bfloat16 if dtype == torch.bfloat16 else None
        # NHWC -> NCHW view: channels_last memory, no copy
        imgs = to_unit_range(_tensor(batch["imgs"], dev), dtype).permute(0, 3, 1, 2)
        sent = _tensor(batch["sent_embs"], dev).float()
        words = mask = None
        if "words_embs" in batch and batch["words_embs"] is not None:
            words = _tensor(batch["words_embs"], dev).float()
            mask = _tensor(batch["mask"], dev).bool()
        noise = _tensor(noise, dev).float()
        bs = imgs.shape[0]
        zero = torch.zeros((), device=dev)

        refresh_spectral(d, spectral_iters)
        with torch.no_grad():
            psent = project_sent(g, sent)
            labels = (losses.make_labels(sent if mesh is None else all_gather(sent, mesh),
                                         el.B_GLOBAL, t.SMOOTH.GLOBAL)
                      if use_labels else None)
            fake = g(noise, sent, words, mask)

        # ------------------------------------------------------- D update 1
        if el.WORD:
            feats_real, regions_real = d.features_and_regions(imgs)
        else:
            feats_real = d(imgs)
        match_real, img_feat_real, sent_proj = d.logits(feats_real, psent)
        errD_real = losses.hinge_real(match_real)
        match_fake = d.logits(d(fake), psent)[0]
        errD_fake = losses.hinge_fake(match_fake)
        mis_loss, errD_mismatch = errD_fake, zero
        if t.RMIS_LOSS:
            errD_mismatch = mismatch(d, feats_real, psent, zero)
            mis_loss = mis_loss + errD_mismatch
        enc_loss, ds_loss, ds_word = zero, zero, zero
        if el.SENT:
            ds_loss = losses.sent_loss(gather(img_feat_real), gather(sent_proj), labels,
                                       el.B_GLOBAL, t.SMOOTH.GLOBAL)
            enc_loss = enc_loss + t.SMOOTH.SENT * ds_loss
        if el.WORD:
            ds_word = word_loss(regions_real, words, mask, labels, word_dtype)
            enc_loss = enc_loss + t.SMOOTH.WORD * ds_word
        errD = errD_real + mis_loss * t.SMOOTH.MISMATCH + enc_loss
        d_params = list(d.parameters())
        _adam_step(state.d_opt, errD, d_params, mesh, split)

        # ------------------------------------------------- D update 2: MAGP
        d_loss_gp = zero
        if t.MAGP:
            def d_scalar(i, s):
                return d.logits(d(i), s)[0].float().sum()

            d_loss_gp = losses.magp_penalty(d_scalar, imgs, psent)
            _adam_step(state.d_opt, d_loss_gp, d_params, mesh, split)

        # ------------------------------------------------------- G update
        do_g = (state.step + 1) % t.N_CRITIC == 0
        errG, gs_loss, gs_word, disc_loss, vgg_loss = zero, zero, zero, zero, zero
        if do_g:
            fake_g = g(noise, sent, words, mask)
            psent_g = project_sent(g, sent)
            if el.WORD:
                feats, regions_fake = d.features_and_regions(fake_g)
            else:
                feats = d(fake_g)
            match, img_feat_fake, sent_proj = d.logits(feats, psent_g)
            enc_loss = zero
            if el.SENT:
                gs_loss = losses.sent_loss(gather(img_feat_fake), gather(sent_proj), labels,
                                           el.B_GLOBAL, t.SMOOTH.GLOBAL)
                enc_loss = enc_loss + t.SMOOTH.SENT * gs_loss
            if el.WORD:
                gs_word = word_loss(regions_fake, words, mask, labels, word_dtype)
                enc_loss = enc_loss + t.SMOOTH.WORD * gs_word
            if el.DISC:
                with torch.no_grad():
                    feats_real_g = d(imgs)
                disc_loss = losses.img_loss(gather(avg_pool(feats_real_g, 4).reshape(bs, -1)),
                                            gather(avg_pool(feats, 4).reshape(bs, -1)), labels,
                                            el.B_GLOBAL, t.SMOOTH.GLOBAL)
                enc_loss = enc_loss + t.SMOOTH.DISC * disc_loss
            if el.VGG:
                # image-image InfoNCE over the frozen VGG features, added
                # unweighted as in the JAX step
                with torch.no_grad():
                    vgg_real = vgg(imgs)
                vgg_loss = losses.img_loss(gather(vgg_real), gather(vgg(fake_g)), labels,
                                           el.B_GLOBAL, t.SMOOTH.GLOBAL)
                enc_loss = enc_loss + vgg_loss
            errG = losses.generator_loss(match) + enc_loss
            _adam_step(state.g_opt, errG, list(g.parameters()), mesh, split)
        state.step += 1

        metrics = {
            "Loss_D": errD, "Loss_G": errG, "errD_real": errD_real, "errD_fake": errD_fake,
            "errD_mismatch": errD_mismatch, "ds_loss": ds_loss, "gs_loss": gs_loss,
            "disc_loss": disc_loss,
            # the full penalty added to the D loss, 2*mean(||grad||^6), as in the JAX step
            "d_loss_gp": d_loss_gp,
            # a fill, not torch.tensor(..., device=): a copy from pageable
            # host memory would wait for the whole step on the card
            "g_updated": torch.full((), do_g, device=dev),
        }
        if el.WORD:
            metrics["ds_word"], metrics["gs_word"] = ds_word, gs_word
        if el.VGG:
            metrics["vgg_loss"] = vgg_loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            # the global metrics: the mean over every rank (the model groups'
            # ranks hold the same), one all_reduce on the device
            keys = [k for k in metrics if k != "g_updated"]
            row = torch.stack([metrics[k].float() for k in keys])
            all_reduce_mean_([row], mesh, world=True)
            metrics.update(zip(keys, row.unbind()))
        return metrics

    return train_step


def make_generator(cfg: Config, dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None, *,
                   weights: str | None = None, seed: int = 0,
                   fuse_upsample: bool = True) -> nn.Module:
    """``GEN.ENCODER_NAME`` (default ``DF_GEN``) with fp32 parameters and
    ``dtype`` activations, in eval mode on ``device`` (default ``cuda``).
    ``weights`` is a reference-named ``state_dict`` file (``.pth``), loaded
    strictly; without it the parameters are drawn from ``seed``."""
    dev = resolve_device(device)
    g_cls = get_generator(cfg.GEN.ENCODER_NAME or "DF_GEN")
    g = g_cls(cfg, dtype=dtype, fuse_upsample=fuse_upsample,
              gen=torch.Generator().manual_seed(seed))
    if weights:
        g.load_state_dict(load_state_dict(weights))
    return g.to(dev).eval().requires_grad_(False)


def make_sample_fn(cfg: Config, g_model: nn.Module | None = None,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None) -> Callable:
    """Sampling function ``(noise, sent, words=None, mask=None) -> images``
    (reference ``eval`` G forward, ``train_gan.py:361-365``).

    Without ``g_model`` a generator is built by :func:`make_generator` with
    ``dtype`` on ``device``; with one, its own dtype and device are used.
    Inputs are moved to the model's device.  The result is ``[B, H, W, 3]``
    fp32 in ``[-1, 1]`` (NHWC, as the JAX sampler returns).

    Building the sampler turns TF32 off once, process-wide
    (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``), so fp32 convolutions on the
    card are full fp32, as in the JAX package; calls leave the flags alone.
    """
    if g_model is None:
        g_model = make_generator(cfg, dtype, device)
    dev = next(g_model.parameters()).device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    @torch.inference_mode()
    def sample(noise, sent, words=None, mask=None) -> torch.Tensor:
        to = lambda t: None if t is None else torch.as_tensor(t).to(dev)
        img = g_model(to(noise).float(), to(sent).float(), to(words), to(mask))
        return img.permute(0, 2, 3, 1)

    return sample
