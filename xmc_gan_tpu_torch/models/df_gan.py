"""DF-GAN generator and discriminator as PyTorch modules (port of
``xmc_gan_tpu/models/df_gan.py``).

* **NetG** — ``Linear(noise -> 8*ngf*4*4)``, 5/6/7 text-conditional residual
  up-blocks, ``LeakyReLU -> Conv3x3 -> Tanh`` head (reference ``df_gan.py:64-103``).
* **GBlock** — residual block with four conditional affine modulations and a
  zero-initialized scalar gate, nearest 2x upsample (reference ``df_gan.py:179-224``).
* **Affine** — gamma/beta from two 2-layer MLPs on the sentence embedding
  (reference ``df_gan.py:227-263``); each modulation+LeakyReLU pair goes
  through ``ops/fused.py``, which launches the CUDA epilogue kernel on the card
  (forward and backward).
* **NetD** — ``conv_img`` + residual down-blocks + ``COND_DNET`` projection
  head (reference ``df_gan.py:106-176``), plus the word-loss region head.
* **ResD** — residual down-block with a zero-initialized gate (reference
  ``resD``, ``df_gan.py:266-294``); **DGetLogits** — the projection head
  returning ``(match, img_feat, sent_proj)``.

Activations are NCHW tensors in ``channels_last`` memory.  Module and
parameter names are the reference's (``upblocks.{i}.affine{j}.fc_gamma.linear1``,
``conv_out.1``, ``downblocks.{i}.conv_r.0``, ``COND_DNET.joint_conv.2``, ...),
so a reference ``NetG`` ``state_dict`` — or one exported from the JAX package
by ``df_gan_generator_state_dict`` — loads with ``strict=True``; JAX ``NetD``
trees load through ``utils/convert.df_gan_discriminator_state_dict``.
Spectral-normalized tensors keep the port's ``weight``/``weight_u``/
``weight_v`` names (``ops/modules.py``).  Parameters are fp32; ``dtype`` is
the activation type, as in the JAX module.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.models.common import (
    affine_out_inits,
    disc_arch,
    gen_arch,
    inits,
    split_upsample_schedule,
)
from xmc_gan_tpu_torch.ops.fused import double_modulate_lrelu
from xmc_gan_tpu_torch.ops.modules import (
    SNConv,
    SNDense,
    avg_pool,
    leaky_relu,
    upsample_nearest_2x,
)

__all__ = ["Affine", "GBlock", "NetG", "ResD", "DGetLogits", "NetD", "epilogue_shapes"]

AFFINE_HIDDEN = 256  # reference df_gan.py:233,239


def epilogue_shapes(cfg: Config, batch: int, fuse_upsample: bool = True
                    ) -> list[tuple[int, int, int, int]]:
    """NCHW shapes of the ``double_modulate_lrelu`` inputs of one ``NetG``
    forward, in call order (two per GBlock), from the arch table alone."""
    arch = gen_arch(cfg.IMG.SIZE, cfg.TRAIN.NCH)
    pre, post = split_upsample_schedule(arch["upsample"], fuse_upsample)
    shapes, res = [], 4
    for i in range(arch["depth"]):
        shapes.append((batch, arch["in_channels"][i], res, res))
        res *= 2 if pre[i] else 1
        shapes.append((batch, arch["out_channels"][i], res, res))
        res *= 2 if post[i] else 1
    return shapes


def _affine_mlp(cond_dim: int, num_features: int, he_init: bool, gamma: bool,
                gen: torch.Generator) -> nn.Sequential:
    k1, b1 = inits(he_init, cond_dim)
    k2, b2 = affine_out_inits(he_init, gamma=gamma, fan_in=AFFINE_HIDDEN)
    return nn.Sequential(OrderedDict(
        linear1=SNDense(cond_dim, AFFINE_HIDDEN, weight_init=k1, bias_init=b1, gen=gen),
        relu1=nn.ReLU(),
        linear2=SNDense(AFFINE_HIDDEN, num_features, weight_init=k2, bias_init=b2, gen=gen),
    ))


class Affine(nn.Module):
    """Conditional affine parameters (reference ``affine``, ``df_gan.py:227-263``).

    Returns the (gamma, beta) pair, each ``[B, num_features]``; the caller
    fuses the modulation so that consecutive affines share one epilogue kernel.
    """

    def __init__(self, num_features: int, cond_dim: int, he_init: bool, *,
                 gen: torch.Generator):
        super().__init__()
        self.fc_gamma = _affine_mlp(cond_dim, num_features, he_init, True, gen)
        self.fc_beta = _affine_mlp(cond_dim, num_features, he_init, False, gen)

    def forward(self, cond: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.fc_gamma(cond), self.fc_beta(cond)


class GBlock(nn.Module):
    """Text-conditional residual up-block (reference ``G_Block``,
    ``df_gan.py:179-224``).

    ``pre_upsample`` runs the *previous* block's trailing nearest-2x upsample
    here: modulation+LeakyReLU commute exactly with nearest upsampling, so the
    two affines before ``c1`` run at 1/4 the elements, the upsample folds into
    ``c1`` as a stride-2 transposed conv, and the shortcut's 1x1 conv also
    runs at the low resolution.  The parameters are unchanged.
    """

    def __init__(self, in_dim: int, out_dim: int, cond_dim: int, upsample: bool,
                 he_init: bool, pre_upsample: bool = False, *, gen: torch.Generator):
        super().__init__()
        self.upsample = upsample
        self.pre_upsample = pre_upsample
        k3_in, b3_in = inits(he_init, in_dim * 9)
        k3_out, b3_out = inits(he_init, out_dim * 9)
        self.affine0 = Affine(in_dim, cond_dim, he_init, gen=gen)
        self.affine1 = Affine(in_dim, cond_dim, he_init, gen=gen)
        self.affine2 = Affine(out_dim, cond_dim, he_init, gen=gen)
        self.affine3 = Affine(out_dim, cond_dim, he_init, gen=gen)
        self.c1 = SNConv(in_dim, out_dim, 3, padding=1, pre_upsample=pre_upsample,
                         weight_init=k3_in, bias_init=b3_in, gen=gen)
        self.c2 = SNConv(out_dim, out_dim, 3, padding=1, weight_init=k3_out,
                         bias_init=b3_out, gen=gen)
        self.gamma = nn.Parameter(torch.zeros(1))
        if in_dim != out_dim:
            k1, b1 = inits(he_init, in_dim)
            self.c_sc = SNConv(in_dim, out_dim, 1, weight_init=k1, bias_init=b1, gen=gen)
        else:
            self.c_sc = None

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        # residual: affine0 -> lrelu -> affine1 -> lrelu -> conv3x3
        #           affine2 -> lrelu -> affine3 -> lrelu -> conv3x3
        h = double_modulate_lrelu(x, *self.affine0(cond), *self.affine1(cond))
        h = self.c1(h)
        h = double_modulate_lrelu(h, *self.affine2(cond), *self.affine3(cond))
        h = self.c2(h)
        sc = x if self.c_sc is None else self.c_sc(x)
        if self.pre_upsample:
            sc = upsample_nearest_2x(sc)
        out = sc + self.gamma.to(h.dtype) * h
        if self.upsample:
            out = upsample_nearest_2x(out)
        return out


class NetG(nn.Module):
    """DF-GAN generator (reference ``NetG``, ``df_gan.py:64-103``).

    ``fuse_upsample`` (default on) defers each block's trailing nearest-2x
    upsample into the next block, where it folds into the first conv — exact
    math, same parameters.  ``forward`` returns ``tanh`` of the output in fp32,
    NCHW in ``channels_last`` memory, in ``[-1, 1]``.
    """

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32,
                 fuse_upsample: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        ngf = cfg.TRAIN.NCH
        he = cfg.TRAIN.HE_INIT
        arch = gen_arch(cfg.IMG.SIZE, ngf)
        k, b = inits(he, cfg.TRAIN.NOISE_DIM)
        self.proj_noise = SNDense(cfg.TRAIN.NOISE_DIM, 8 * ngf * 16, weight_init=k,
                                  bias_init=b, gen=gen)
        if cfg.TEXT.EMBEDDING_DIM != cfg.TRAIN.NEF:
            kp, bp = inits(he, cfg.TEXT.EMBEDDING_DIM)
            self.proj_sent = SNDense(cfg.TEXT.EMBEDDING_DIM, cfg.TRAIN.NEF, weight_init=kp,
                                     bias_init=bp, gen=gen)
        else:
            self.proj_sent = None
        pre, post = split_upsample_schedule(arch["upsample"], fuse_upsample)
        self.upblocks = nn.ModuleList(
            GBlock(arch["in_channels"][i], arch["out_channels"][i], cfg.TRAIN.NEF,
                   upsample=post[i], he_init=he, pre_upsample=pre[i], gen=gen)
            for i in range(arch["depth"])
        )
        ko, bo = inits(he, arch["out_channels"][-1] * 9)
        self.conv_out = nn.Sequential(
            nn.LeakyReLU(0.2),
            SNConv(arch["out_channels"][-1], 3, 3, padding=1, weight_init=ko, bias_init=bo,
                   gen=gen),
        )

    def project_sent(self, sent_embs: torch.Tensor) -> torch.Tensor:
        """The sentence projection also used to condition D
        (reference ``train_gan.py:191``)."""
        return sent_embs if self.proj_sent is None else self.proj_sent(sent_embs)

    def forward(self, noise: torch.Tensor, sent_embs: torch.Tensor,
                words_embs: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        ngf = self.cfg.TRAIN.NCH
        out = self.proj_noise(noise.to(self.dtype))
        # the reference's view(B, 8*ngf, 4, 4) (df_gan.py:94), then channels_last
        out = out.view(noise.shape[0], 8 * ngf, 4, 4).contiguous(
            memory_format=torch.channels_last)
        cond = self.project_sent(sent_embs.to(self.dtype))
        for block in self.upblocks:
            out = block(out, cond)
        return torch.tanh(self.conv_out(out).float())


class ResD(nn.Module):
    """Residual down-block (reference ``resD``, ``df_gan.py:266-294``).

    ``fuse_downsample`` (default on) runs the shortcut's 1x1 conv after the
    2x2 average pool instead of before: both are linear and the bias is
    pool-invariant, so the conv touches 1/4 the elements.  Same parameters,
    same math.  No ``conv_s`` exists when ``in_dim == out_dim`` (the
    reference builds one it never calls).
    """

    def __init__(self, in_dim: int, out_dim: int, downsample: bool, spec_norm: bool,
                 he_init: bool, fuse_downsample: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.downsample = downsample
        self.fuse_downsample = fuse_downsample
        k4, _ = inits(he_init, in_dim * 16)
        k3, _ = inits(he_init, out_dim * 9)
        self.conv_r = nn.Sequential(
            SNConv(in_dim, out_dim, 4, stride=2, padding=1, use_bias=False,
                   spec_norm=spec_norm, weight_init=k4, gen=gen),
            nn.LeakyReLU(0.2),
            SNConv(out_dim, out_dim, 3, padding=1, use_bias=False, spec_norm=spec_norm,
                   weight_init=k3, gen=gen),
            nn.LeakyReLU(0.2),
        )
        if in_dim != out_dim:
            k1, b1 = inits(he_init, in_dim)
            self.conv_s = SNConv(in_dim, out_dim, 1, spec_norm=spec_norm, weight_init=k1,
                                 bias_init=b1, gen=gen)
        else:
            self.conv_s = None
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_r(x)
        fold = self.downsample and self.fuse_downsample
        sc = avg_pool(x, 2) if fold else x
        if self.conv_s is not None:
            sc = self.conv_s(sc)
        if self.downsample and not fold:
            sc = avg_pool(sc, 2)
        return sc + self.gamma.to(h.dtype) * h


class DGetLogits(nn.Module):
    """Projection head returning ``(match_logit [B], img_feat, sent_proj)``
    (reference ``D_GET_LOGITS``, ``df_gan.py:134-176``; the JAX package's
    ``DGetLogits`` documents the reference's ``cond_dim`` handling)."""

    def __init__(self, cfg: Config, *, gen: torch.Generator):
        super().__init__()
        ndf, nef = cfg.TRAIN.NCH, cfg.TRAIN.NEF
        text_dim = cfg.TEXT.EMBEDDING_DIM
        spec_norm = cfg.DISC.SPEC_NORM
        he = cfg.TRAIN.HE_INIT
        self.img_match = cfg.DISC.IMG_MATCH
        if cfg.DISC.IMG_MATCH:
            k, b = inits(he, ndf * 16)
            self.proj_match = SNDense(ndf * 16, nef, spec_norm=spec_norm, weight_init=k,
                                      bias_init=b, gen=gen)
            cond_dim = nef
        elif cfg.DISC.SENT_MATCH:
            k, b = inits(he, nef)
            self.proj_match = SNDense(nef, ndf * 16, spec_norm=spec_norm, weight_init=k,
                                      bias_init=b, gen=gen)
            cond_dim = ndf * 16
        elif cfg.DISC.SEPERATE and text_dim != nef:
            k, b = inits(he, text_dim)
            self.proj_match = SNDense(text_dim, nef, spec_norm=spec_norm, weight_init=k,
                                      bias_init=b, gen=gen)
            cond_dim = nef
        else:
            self.proj_match = None
            cond_dim = text_dim if cfg.DISC.SEPERATE else nef
        kj, _ = inits(he, (ndf * 16 + cond_dim) * 9)
        kj2, _ = inits(he, ndf * 2 * 16)
        self.joint_conv = nn.Sequential(
            SNConv(ndf * 16 + cond_dim, ndf * 2, 3, padding=1, use_bias=False,
                   spec_norm=spec_norm, weight_init=kj, gen=gen),
            nn.LeakyReLU(0.2),
            SNConv(ndf * 2, 1, 4, use_bias=False, spec_norm=spec_norm, weight_init=kj2,
                   gen=gen),
        )

    def forward(self, x: torch.Tensor, sent_embs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        out = avg_pool(x, 4).reshape(b, -1)  # [B, ndf*16]
        if self.proj_match is not None:
            if self.img_match:
                out = self.proj_match(out)
            else:
                sent_embs = self.proj_match(sent_embs)
        c = sent_embs[:, :, None, None].expand(b, sent_embs.shape[1], 4, 4).to(x.dtype)
        h = torch.cat([x, c], dim=1).contiguous(memory_format=torch.channels_last)
        match = self.joint_conv(h)
        return match.reshape(b), out, sent_embs


class NetD(nn.Module):
    """DF-GAN discriminator (reference ``NetD``, ``df_gan.py:106-132``).

    ``forward`` returns the 4x4 trunk features; ``logits`` applies the
    projection head (the reference's ``COND_DNET``, called separately up to 4
    times per step); ``features_and_regions`` also returns the word-loss
    region projections ``[B, 256, TEXT.EMBEDDING_DIM]`` of the 16x16 stage
    (``region_proj``, built when ``ENCODER_LOSS.WORD`` is on; no reference
    counterpart: the reference's WORD branch raises).  Inputs are NCHW
    images in [-1, 1], cast to ``dtype``.
    """

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32,
                 fuse_downsample: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        ndf = cfg.TRAIN.NCH
        he = cfg.TRAIN.HE_INIT
        spec_norm = cfg.DISC.SPEC_NORM
        arch = disc_arch(cfg.IMG.SIZE, ndf)
        k, b = inits(he, 3 * 9)
        self.conv_img = SNConv(3, arch["out_channels"][0], 3, padding=1, spec_norm=spec_norm,
                               weight_init=k, bias_init=b, gen=gen)
        self.downblocks = nn.ModuleList(
            ResD(arch["in_channels"][i], arch["out_channels"][i], arch["downsample"][i],
                 spec_norm, he, fuse_downsample, gen=gen)
            for i in range(1, arch["depth"])
        )
        self.COND_DNET = DGetLogits(cfg, gen=gen)
        # the stage whose output is 16x16 (the table lists block inputs)
        self.region_stage = arch["resolution"].index(16) + 1
        if cfg.TRAIN.ENCODER_LOSS.WORD:
            c = arch["out_channels"][self.region_stage]
            kr, br = inits(he, c)
            self.region_proj = SNConv(c, cfg.TEXT.EMBEDDING_DIM, 1, spec_norm=spec_norm,
                                      weight_init=kr, bias_init=br, gen=gen)
        else:
            self.region_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_img(x.to(self.dtype))
        for block in self.downblocks:
            out = block(out)
        return out

    def features_and_regions(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One trunk pass: (4x4 features, ``[B, H*W, TEXT.EMBEDDING_DIM]``
        region projections of the 16x16 stage, rows in (h, w) order)."""
        if self.region_proj is None:
            raise ValueError("features_and_regions needs TRAIN.ENCODER_LOSS.WORD "
                             "(the region head is built only then)")
        out = self.conv_img(x.to(self.dtype))
        regions = out
        for i, block in enumerate(self.downblocks):
            out = block(out)
            if i + 1 == self.region_stage:
                regions = out
        r = self.region_proj(regions)
        b, d, h, w = r.shape
        return out, r.permute(0, 2, 3, 1).reshape(b, h * w, d)

    def logits(self, features: torch.Tensor, sent_embs: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.COND_DNET(features, sent_embs.to(self.dtype))

    def d_all(self, x: torch.Tensor, sent_embs: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Trunk + projection head in one call."""
        feats = self.features_and_regions(x)[0] if self.region_proj is not None else self(x)
        return self.logits(feats, sent_embs)
