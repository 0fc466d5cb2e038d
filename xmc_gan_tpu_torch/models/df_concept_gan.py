"""Concept-DF GAN models as PyTorch modules (port of
``xmc_gan_tpu/models/df_concept_gan.py``).

* **InNetG / OutNetG** (``CONCEPT_IN_DF_GEN`` / ``CONCEPT_OUT_DF_GEN``) — the
  DF-GAN skeleton whose residual branches split features into 16 concept
  groups, pool each group with attention over the spatial map, reason over
  the 16 concept states and modulate the grouped features with per-group
  gamma/beta MLPs (reference ``df_concept_gan.py:65-531``).
* **NetD / ConceptResD / ConceptDGetLogits** (``CONCEPT_NETD``) — the
  concept-attention discriminator: each down-block pools its 16 concept
  groups, reasons over them and modulates its own features with
  ``modulate_lrelu`` (reference ``:584-714``, whose ``__init__`` raises; the
  JAX package made the dead code below the raise work, with an IMG_MATCH
  head of its own).  MAGP differentiates it twice, so its epilogue runs the
  kernel's double backward on the card.
* The shared pieces that ``models/concept_gan.py`` also builds on:
  ``CARDINALITY``/``BOTTLENECK``/``STATE_DIM``, ``ConceptReasoner`` and
  ``ConceptSampler``.

The spatial samplers take a softmax over *space*, have no mask and attend
with a value that differs from the key, so they stay plain PyTorch (the JAX
package leaves them to XLA).  Each block's two ``modulate_lrelu`` go through
``ops/fused.modulate_lrelu``: the CUDA ``fused_affine`` kernel on the card.

Activations are NCHW tensors in ``channels_last`` memory: the memory of a
``[B, C*d, H, W]`` map is the JAX package's grouped ``[B, HW, C, d]``.
Module and parameter names are the reference's (``upblocks.{i}.concept1.
gamma1_gconv.{0,2}.weight``, ``concept_sampler1.query_gconv.weight`` as a
grouped 1x1 conv ``[C*d_out, d_in, 1, 1]``, ``gn.weight``, ``conv_out.1``),
the names ``xmc_gan_tpu/utils/convert.py:244-311`` reads, so a reference
``state_dict`` loads with ``strict=True``.  The reference D never ran, so
its names are the DF-GAN ``NetD``'s around the JAX module tree's
(``downblocks.{i}.concept_sampler.key_gconv.weight``,
``COND_DNET.joint_conv.0``; ``utils/convert.concept_discriminator_state_dict``).
Parameters are fp32; ``dtype`` is the activation type.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.models.common import disc_arch, gen_arch, inits, split_upsample_schedule
from xmc_gan_tpu_torch.ops.fused import modulate_lrelu
from xmc_gan_tpu_torch.ops.grouped import GroupedDense, GroupNorm
from xmc_gan_tpu_torch.ops.modules import (
    SNConv,
    SNDense,
    avg_pool,
    global_avg_pool,
    leaky_relu,
    upsample_nearest_2x,
)

__all__ = ["CARDINALITY", "BOTTLENECK", "STATE_DIM", "grouped", "ConceptReasoner",
           "ConceptSampler", "CondConceptSampler", "InConceptBlock", "OutConceptBlock",
           "InNetG", "OutNetG", "ConceptResD", "ConceptDGetLogits", "NetD", "modulation_shapes",
           "disc_modulation_shapes"]

CARDINALITY = 16  # concept groups (reference df_concept_gan.py:110)
BOTTLENECK = 8  # per-group width p (reference :110)
STATE_DIM = 4  # concept state width p' (reference :118)


def grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NCHW ``[B, groups*d, H, W]`` -> ``[B, HW, groups, d]`` (the JAX
    ``_group``, ``df_concept_gan.py:60``); a view of a channels_last map."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, groups, c // groups)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class _SkipNormBuffer(nn.Module):
    """Accepts and ignores a reference ``norm`` buffer (the sampler's
    ``rsqrt(state_dim)``, computed inline here) when a reference
    ``state_dict`` is loaded."""

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "norm", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class ConceptReasoner(nn.Module):
    """Graph reasoning over concept states (``df_concept_gan.py:66-85``,
    reference ``:304-326``): tanh adjacency from a p'->C projection, one
    propagation step, ReLU (``normalize`` is hardcoded off in the reference)."""

    def __init__(self, cardinality: int, state_dim: int, he_init: bool, *,
                 spec_norm: bool = False, gen: torch.Generator):
        super().__init__()
        k, _ = inits(he_init, state_dim)
        self.proj_edge = SNDense(state_dim, cardinality, use_bias=False, spec_norm=spec_norm,
                                 weight_init=k, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        adj = torch.tanh(self.proj_edge(x))  # [B, C, C]
        return torch.relu(x + torch.bmm(adj, x))


def _gn_vector(gn: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """Flax GroupNorm of ``[B, C, d]`` concept vectors: statistics per sample
    and group over ``d``."""
    b = x.shape[0]
    return gn(x.reshape(b, -1)).view(x.shape)


class ConceptSampler(_SkipNormBuffer):
    """Self-attention concept pooling (``df_concept_gan.py:88-127``, reference
    ``:535-581``): global-average query per group, key over the map, scaled
    softmax over space, value projection of the attended group features.
    ``[B, C*p, H, W]`` -> ``[B, C, p']``."""

    def __init__(self, cardinality: int, state_dim: int, normalize: bool, he_init: bool,
                 in_per_group: int = BOTTLENECK, *, spec_norm: bool = False,
                 gen: torch.Generator):
        super().__init__()
        C, p, q = cardinality, in_per_group, state_dim
        self.cardinality, self.scale = C, state_dim ** -0.5
        k, _ = inits(he_init, p)
        for name in ("query_gconv", "key_gconv", "value_gconv"):
            self.add_module(name, GroupedDense(C, p, q, use_bias=False, spec_norm=spec_norm,
                                               weight_init=k, gen=gen))
        self.gn1 = GroupNorm(C, C * q) if normalize else None
        self.gn2 = GroupNorm(C, C * q) if normalize else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = self.cardinality
        query = self.query_gconv(x.mean(dim=(2, 3)).view(x.shape[0], C, -1))  # [B, C, p']
        key = self.key_gconv.conv(x)  # [B, C*p', H, W]
        if self.gn1 is not None:
            query = _gn_vector(self.gn1, query)
            key = self.gn2(key)
        attn = torch.einsum("bcq,bncq->bcn", query, grouped(key, C)) * self.scale
        attn = torch.softmax(attn, dim=-1)  # over space
        pooled = torch.einsum("bcn,bncp->bcp", attn, grouped(x, C))
        return self.value_gconv(pooled)


class CondConceptSampler(_SkipNormBuffer):
    """Sentence-conditioned concept pooling (``df_concept_gan.py:130-170``,
    reference ``:256-302``): query from the tiled sentence embedding, unscaled
    softmax over space (the reference omits the 1/sqrt(d) here)."""

    def __init__(self, cardinality: int, state_dim: int, cond_dim: int, normalize: bool,
                 he_init: bool, in_per_group: int = BOTTLENECK, *, gen: torch.Generator):
        super().__init__()
        C, p, q = cardinality, in_per_group, state_dim
        self.cardinality = C
        kq, _ = inits(he_init, cond_dim)
        kk, _ = inits(he_init, p)
        self.query_gconv = GroupedDense(C, cond_dim, q, use_bias=False, weight_init=kq, gen=gen)
        self.key_gconv = GroupedDense(C, p, q, use_bias=False, weight_init=kk, gen=gen)
        self.value_gconv = GroupedDense(C, p, q, use_bias=False, weight_init=kk, gen=gen)
        self.gn1 = GroupNorm(C, C * q) if normalize else None
        self.gn2 = GroupNorm(C, C * q) if normalize else None

    def forward(self, x: torch.Tensor, sent_embs: torch.Tensor) -> torch.Tensor:
        C = self.cardinality
        b = x.shape[0]
        query = self.query_gconv(sent_embs[:, None, :].expand(b, C, sent_embs.shape[1]))
        key = self.key_gconv.conv(x)
        if self.gn1 is not None:
            query = _gn_vector(self.gn1, query)
            key = self.gn2(key)
        attn = torch.softmax(torch.einsum("bcq,bncq->bcn", query, grouped(key, C)), dim=-1)
        pooled = torch.einsum("bcn,bncp->bcp", attn, grouped(x, C))
        return self.value_gconv(pooled)


class _GammaBetaMLP(nn.Sequential):
    """Per-group two-layer modulation MLP (``df_concept_gan.py:173-193``,
    reference grouped 1x1 conv pairs ``:178-200``, whose Sequential indices
    ``0``/``2`` it keeps): (cond+p') -> 2p' -> p per group, returned as
    ``[B, C*p]``."""

    def __init__(self, cardinality: int, state_dim: int, cond_in: int, out_per_group: int,
                 he_init: bool, *, gen: torch.Generator):
        k1, b1 = inits(he_init, cond_in)
        k2, b2 = inits(he_init, 2 * state_dim)
        super().__init__(OrderedDict([
            ("0", GroupedDense(cardinality, cond_in, 2 * state_dim, weight_init=k1,
                               bias_init=b1, gen=gen)),
            ("1", nn.LeakyReLU(0.2)),
            ("2", GroupedDense(cardinality, 2 * state_dim, out_per_group, weight_init=k2,
                               bias_init=b2, gen=gen)),
        ]))

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        out = super().forward(cond)
        return out.reshape(out.shape[0], -1)


class _ConceptTrunk(nn.Module):
    """The split 1x1 conv, grouped 3x3 conv and GroupNorm that open every
    concept block (``df_concept_gan.py:223-230``, ``concept_gan.py:219-225``).
    ``pre_upsample`` folds a deferred nearest-2x upsample into the grouped
    3x3: the 1x1 split conv and the activation commute exactly with it."""

    def _build_trunk(self, in_dim: int, normalize: bool, he_init: bool, pre_upsample: bool,
                     gen: torch.Generator) -> None:
        C = self.cardinality = CARDINALITY
        gw = C * BOTTLENECK
        k1, _ = inits(he_init, in_dim)
        k3, _ = inits(he_init, BOTTLENECK * 9)
        self.split_conv = SNConv(in_dim, gw, 1, use_bias=False, weight_init=k1, gen=gen)
        self.trans_gconv = SNConv(gw, gw, 3, padding=1, use_bias=False, groups=C,
                                  pre_upsample=pre_upsample, weight_init=k3, gen=gen)
        self.gn = GroupNorm(C, gw) if normalize else None

    def _trunk(self, x: torch.Tensor, act) -> torch.Tensor:
        h = self.trans_gconv(act(self.split_conv(x)))
        if self.gn is not None:
            h = self.gn(h)
        return channels_last(act(h))


class InConceptBlock(_ConceptTrunk):
    """Sentence-conditioned concept block (``df_concept_gan.py:196-250``,
    reference ``InConceptBlock`` ``:159-253``)."""

    def __init__(self, in_dim: int, cond_dim: int, normalize: bool, he_init: bool,
                 pre_upsample: bool = False, *, gen: torch.Generator):
        super().__init__()
        self._build_trunk(in_dim, normalize, he_init, pre_upsample, gen)
        C, q = CARDINALITY, STATE_DIM
        for ph in (1, 2):
            self.add_module(f"concept_sampler{ph}", CondConceptSampler(
                C, q, cond_dim, normalize, he_init, gen=gen))
            self.add_module(f"concept_reasoner{ph}", ConceptReasoner(C, q, he_init, gen=gen))
            for name in ("gamma", "beta"):
                self.add_module(f"{name}{ph}_gconv", _GammaBetaMLP(
                    C, q, cond_dim + q, BOTTLENECK, he_init, gen=gen))

    def forward(self, x: torch.Tensor, sent_embs: torch.Tensor) -> torch.Tensor:
        img_embs = self._trunk(x, leaky_relu)
        gc = sent_embs[:, None, :].expand(x.shape[0], CARDINALITY, sent_embs.shape[1])
        for ph in (1, 2):
            ctx = getattr(self, f"concept_sampler{ph}")(img_embs, sent_embs)
            ctx = getattr(self, f"concept_reasoner{ph}")(ctx)
            cond = torch.cat([gc, ctx], dim=-1)  # [B, C, cond+p']
            img_embs = modulate_lrelu(img_embs, getattr(self, f"gamma{ph}_gconv")(cond),
                                      getattr(self, f"beta{ph}_gconv")(cond))
        return img_embs


class OutConceptBlock(_ConceptTrunk):
    """Self-attention concept block with sentence-query context selection
    (``df_concept_gan.py:253-312``, reference ``OutConceptBlock``
    ``:421-531``)."""

    def __init__(self, in_dim: int, cond_dim: int, normalize: bool, he_init: bool,
                 pre_upsample: bool = False, *, gen: torch.Generator):
        super().__init__()
        self._build_trunk(in_dim, normalize, he_init, pre_upsample, gen)
        C, q = CARDINALITY, STATE_DIM
        ks, _ = inits(he_init, cond_dim)
        for ph in (1, 2):
            self.add_module(f"concept_sampler{ph}", ConceptSampler(C, q, normalize, he_init,
                                                                   gen=gen))
            self.add_module(f"concept_reasoner{ph}", ConceptReasoner(C, q, he_init, gen=gen))
            self.add_module(f"sent_linear{ph}", SNDense(cond_dim, q, use_bias=False,
                                                        weight_init=ks, gen=gen))
            for name in ("gamma", "beta"):
                self.add_module(f"{name}{ph}_gconv", _GammaBetaMLP(
                    C, q, cond_dim + q, BOTTLENECK, he_init, gen=gen))

    def forward(self, x: torch.Tensor, sent_embs: torch.Tensor) -> torch.Tensor:
        img_embs = self._trunk(x, leaky_relu)
        gc = sent_embs[:, None, :].expand(x.shape[0], CARDINALITY, sent_embs.shape[1])
        for ph in (1, 2):
            state = getattr(self, f"concept_sampler{ph}")(img_embs)
            state = getattr(self, f"concept_reasoner{ph}")(state)  # [B, C, p']
            s = getattr(self, f"sent_linear{ph}")(sent_embs)  # [B, p']
            # sentence-query attention over concepts (reference get_context_embs, :471-478)
            attn = torch.softmax(torch.bmm(state, s[:, :, None])[..., 0], dim=-1)  # [B, C]
            cond = torch.cat([gc, state * attn[:, :, None]], dim=-1)
            img_embs = modulate_lrelu(img_embs, getattr(self, f"gamma{ph}_gconv")(cond),
                                      getattr(self, f"beta{ph}_gconv")(cond))
        return img_embs


class _ConceptGBlock(nn.Module):
    """Residual up-block wrapping two concept blocks (``df_concept_gan.py:315-362``,
    reference ``ICAttnG_Block`` ``:108-156`` / ``OCAG_Block`` ``:369-418``:
    3x3 output convs for In, 1x1 for Out) with a zero-initialized gate."""

    def __init__(self, in_dim: int, out_dim: int, cond_dim: int, upsample: bool,
                 normalize: bool, he_init: bool, inner: str, pre_upsample: bool = False, *,
                 gen: torch.Generator):
        super().__init__()
        self.upsample, self.pre_upsample = upsample, pre_upsample
        block_cls = InConceptBlock if inner == "in" else OutConceptBlock
        gw = CARDINALITY * BOTTLENECK
        conv_k = 3 if inner == "in" else 1
        kk, bb = inits(he_init, BOTTLENECK * conv_k * conv_k * CARDINALITY)
        self.concept1 = block_cls(in_dim, cond_dim, normalize, he_init, pre_upsample, gen=gen)
        self.conv_out1 = SNConv(gw, out_dim, conv_k, padding=conv_k // 2, weight_init=kk,
                                bias_init=bb, gen=gen)
        self.concept2 = block_cls(out_dim, cond_dim, normalize, he_init, gen=gen)
        self.conv_out2 = SNConv(gw, out_dim, conv_k, padding=conv_k // 2, weight_init=kk,
                                bias_init=bb, gen=gen)
        self.gamma = nn.Parameter(torch.zeros(1))
        if in_dim != out_dim:
            k1, b1 = inits(he_init, in_dim)
            self.c_sc = SNConv(in_dim, out_dim, 1, weight_init=k1, bias_init=b1, gen=gen)
        else:
            self.c_sc = None

    def forward(self, x: torch.Tensor, sent_embs: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.conv_out1(self.concept1(x, sent_embs)))
        h = self.conv_out2(self.concept2(h, sent_embs))
        sc = x if self.c_sc is None else self.c_sc(x)
        if self.pre_upsample:
            sc = upsample_nearest_2x(sc)
        out = self.gamma.to(h.dtype) * h + sc
        if self.upsample:
            out = upsample_nearest_2x(out)
        return out


class _ConceptNetG(nn.Module):
    """Shared generator skeleton (``df_concept_gan.py:365-427``, reference
    ``InNetG`` ``:65-105`` / ``OutNetG`` ``:328-367``).

    ``fuse_upsample`` (default on) moves each block's trailing upsample into
    the next block's first concept stage, where it folds into the grouped 3x3
    (``split_upsample_schedule``).  ``forward`` returns ``tanh`` of the output
    in fp32, NCHW in ``channels_last`` memory; ``words_embs``/``mask`` are
    accepted and unused (the sentence conditions everything).
    """

    inner = "in"

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32,
                 fuse_upsample: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        ngf, he = cfg.TRAIN.NCH, cfg.TRAIN.HE_INIT
        arch = gen_arch(cfg.IMG.SIZE, ngf)
        k, b = inits(he, cfg.TRAIN.NOISE_DIM)
        self.proj_noise = SNDense(cfg.TRAIN.NOISE_DIM, 8 * ngf * 16, weight_init=k, bias_init=b,
                                  gen=gen)
        if cfg.TEXT.EMBEDDING_DIM != cfg.TRAIN.NEF:
            kp, bp = inits(he, cfg.TEXT.EMBEDDING_DIM)
            self.proj_sent = SNDense(cfg.TEXT.EMBEDDING_DIM, cfg.TRAIN.NEF, weight_init=kp,
                                     bias_init=bp, gen=gen)
        else:
            self.proj_sent = None
        pre, post = split_upsample_schedule(arch["upsample"], fuse_upsample)
        self.upblocks = nn.ModuleList(
            _ConceptGBlock(arch["in_channels"][i], arch["out_channels"][i], cfg.TRAIN.NEF,
                           post[i], cfg.GEN.NORMALIZE, he, self.inner, pre[i], gen=gen)
            for i in range(arch["depth"])
        )
        ko, bo = inits(he, arch["out_channels"][-1] * 9)
        self.conv_out = nn.Sequential(
            nn.LeakyReLU(0.2),
            SNConv(arch["out_channels"][-1], 3, 3, padding=1, weight_init=ko, bias_init=bo,
                   gen=gen),
        )

    def project_sent(self, sent_embs: torch.Tensor) -> torch.Tensor:
        return sent_embs if self.proj_sent is None else self.proj_sent(sent_embs)

    def forward(self, noise: torch.Tensor, sent_embs: torch.Tensor,
                words_embs: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        ngf = self.cfg.TRAIN.NCH
        out = self.proj_noise(noise.to(self.dtype))
        out = channels_last(out.view(noise.shape[0], 8 * ngf, 4, 4))
        cond = self.project_sent(sent_embs.to(self.dtype))
        for block in self.upblocks:
            out = block(out, cond)
        return torch.tanh(self.conv_out(out).float())


class InNetG(_ConceptNetG):
    inner = "in"


class OutNetG(_ConceptNetG):
    inner = "out"


def modulation_shapes(cfg: Config, batch: int, fuse_upsample: bool = True
                      ) -> list[tuple[int, int, int, int]]:
    """NCHW shapes of the ``modulate_lrelu`` inputs of one concept-DF
    generator forward, in call order (two per concept block, two concept
    blocks per GBlock), from the arch table alone."""
    arch = gen_arch(cfg.IMG.SIZE, cfg.TRAIN.NCH)
    pre, post = split_upsample_schedule(arch["upsample"], fuse_upsample)
    gw = CARDINALITY * BOTTLENECK
    shapes, res = [], 4
    for i in range(arch["depth"]):
        res *= 2 if pre[i] else 1
        shapes += [(batch, gw, res, res)] * 4
        res *= 2 if post[i] else 1
    return shapes


class ConceptResD(_ConceptTrunk):
    """Concept-attention residual down-block (``df_concept_gan.py:430-499``,
    reference ``ConceptResD`` ``:614-679``): a 4x4 stride-2 split conv and a
    grouped 3x3 (the trunk), self-attention concept pooling and reasoning,
    a single-hidden-layer grouped gamma/beta per group, ``modulate_lrelu``,
    a 1x1 output conv and a zero-initialized gate over the shortcut.  The
    shortcut pools before its 1x1 conv (the JAX block's ``fuse_downsample``
    fold): a 1x1 conv commutes with the 2x2 average pool, so this is the
    same function at 1/4 the elements."""

    def __init__(self, in_dim: int, out_dim: int, downsample: bool, normalize: bool,
                 spec_norm: bool, he_init: bool, *, gen: torch.Generator):
        super().__init__()
        C, q = CARDINALITY, STATE_DIM
        gw = C * BOTTLENECK
        self.downsample = downsample
        k4, _ = inits(he_init, in_dim * 16)
        k3, _ = inits(he_init, BOTTLENECK * 9)
        self.split_conv = SNConv(in_dim, gw, 4, stride=2, padding=1, use_bias=False,
                                 spec_norm=spec_norm, weight_init=k4, gen=gen)
        self.trans_gconv = SNConv(gw, gw, 3, padding=1, use_bias=False, groups=C,
                                  spec_norm=spec_norm, weight_init=k3, gen=gen)
        self.gn = GroupNorm(C, gw) if normalize else None
        self.concept_sampler = ConceptSampler(C, q, normalize, he_init, spec_norm=spec_norm,
                                              gen=gen)
        self.concept_reasoner = ConceptReasoner(C, q, he_init, spec_norm=spec_norm, gen=gen)
        kg, bg = inits(he_init, q)
        for name in ("gamma", "beta"):  # reference :634-644
            self.add_module(f"{name}_g1", GroupedDense(C, q, q, spec_norm=spec_norm,
                                                       weight_init=kg, bias_init=bg, gen=gen))
            self.add_module(f"{name}_g2", GroupedDense(C, q, BOTTLENECK, spec_norm=spec_norm,
                                                       weight_init=kg, bias_init=bg, gen=gen))
        k1o, b1o = inits(he_init, gw)
        self.conv_out = SNConv(gw, out_dim, 1, spec_norm=spec_norm, weight_init=k1o,
                               bias_init=b1o, gen=gen)
        if in_dim != out_dim:
            k1, b1 = inits(he_init, in_dim)
            self.conv_s = SNConv(in_dim, out_dim, 1, spec_norm=spec_norm, weight_init=k1,
                                 bias_init=b1, gen=gen)
        else:
            self.conv_s = None
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        img_embs = self._trunk(x, leaky_relu)
        ctx = self.concept_reasoner(self.concept_sampler(img_embs))  # [B, C, p']
        b = x.shape[0]
        gamma = self.gamma_g2(leaky_relu(self.gamma_g1(ctx))).reshape(b, -1)
        beta = self.beta_g2(leaky_relu(self.beta_g1(ctx))).reshape(b, -1)
        out = self.conv_out(modulate_lrelu(img_embs, gamma, beta))
        sc = avg_pool(x, 2) if self.downsample else x
        if self.conv_s is not None:
            sc = self.conv_s(sc)
        return sc + self.gamma.to(out.dtype) * out


class ConceptDGetLogits(nn.Module):
    """Projection head of the concept discriminator (``df_concept_gan.py:502-554``,
    reference ``D_GET_LOGITS`` ``:681-714``), returning ``(match_logit [B],
    img_feat, sent_proj)``.  ``sent_dim`` is the width of the sentence
    tensor the train step hands D (``TEXT.EMBEDDING_DIM`` with
    ``DISC.SEPERATE``, else G's ``TRAIN.NEF`` projection): the JAX head sizes
    its projection from that tensor.  ``IMG_MATCH`` is the JAX package's
    extension (the reference head has none): the pooled image features are
    projected into the text space and the sentence conditions as it is."""

    def __init__(self, cfg: Config, sent_dim: int, *, gen: torch.Generator):
        super().__init__()
        ndf, nef = cfg.TRAIN.NCH, cfg.TRAIN.NEF
        spec_norm, he = cfg.DISC.SPEC_NORM, cfg.TRAIN.HE_INIT
        self.img_match = cfg.DISC.IMG_MATCH
        if cfg.DISC.IMG_MATCH:
            k, b = inits(he, ndf * 16)
            self.proj_match = SNDense(ndf * 16, nef, spec_norm=spec_norm, weight_init=k,
                                      bias_init=b, gen=gen)
            cond_dim = sent_dim
        elif cfg.DISC.SENT_MATCH or sent_dim != nef:
            out = ndf * 16 if cfg.DISC.SENT_MATCH else nef
            k, b = inits(he, sent_dim)
            self.proj_match = SNDense(sent_dim, out, spec_norm=spec_norm, weight_init=k,
                                      bias_init=b, gen=gen)
            cond_dim = out
        else:
            self.proj_match = None
            cond_dim = nef
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
        out = global_avg_pool(x)  # [B, ndf*16] (reference adaptive_avg_pool2d)
        if self.proj_match is not None:
            if self.img_match:
                out = self.proj_match(out)
            else:
                sent_embs = self.proj_match(sent_embs)
        c = sent_embs[:, :, None, None].expand(b, sent_embs.shape[1], 4, 4).to(x.dtype)
        h = torch.cat([x, c], dim=1).contiguous(memory_format=torch.channels_last)
        return self.joint_conv(h).reshape(b), out, sent_embs


class NetD(nn.Module):
    """Concept discriminator, ``CONCEPT_NETD`` (``df_concept_gan.py:557-600``,
    reference ``NetD`` ``:584-612``): ``conv_img``, one ``ConceptResD`` per
    ``disc_arch`` stage after the first, the ``ConceptDGetLogits`` head.
    ``forward`` returns the 4x4 trunk features, ``logits`` applies the head;
    it has no word-region head (as in the JAX package, ``ENCODER_LOSS.WORD``
    needs ``DF_DISC``).  Inputs are NCHW images in [-1, 1], cast to
    ``dtype``."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32, *,
                 gen: torch.Generator):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        ndf, he, spec_norm = cfg.TRAIN.NCH, cfg.TRAIN.HE_INIT, cfg.DISC.SPEC_NORM
        arch = disc_arch(cfg.IMG.SIZE, ndf)
        k, b = inits(he, 3 * 9)
        self.conv_img = SNConv(3, arch["out_channels"][0], 3, padding=1, spec_norm=spec_norm,
                               weight_init=k, bias_init=b, gen=gen)
        self.downblocks = nn.ModuleList(
            ConceptResD(arch["in_channels"][i], arch["out_channels"][i], arch["downsample"][i],
                        cfg.GEN.NORMALIZE, spec_norm, he, gen=gen)
            for i in range(1, arch["depth"])
        )
        # the step conditions D on the raw sentence with DISC.SEPERATE, else
        # on G's projection (xmc_gan_tpu/train.py:88)
        sent_dim = cfg.TEXT.EMBEDDING_DIM if cfg.DISC.SEPERATE else cfg.TRAIN.NEF
        self.COND_DNET = ConceptDGetLogits(cfg, sent_dim, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_img(x.to(self.dtype))
        for block in self.downblocks:
            out = block(out)
        return out

    def logits(self, features: torch.Tensor, sent_embs: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.COND_DNET(features, sent_embs.to(self.dtype))

    def d_all(self, x: torch.Tensor, sent_embs: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Trunk + projection head in one call."""
        return self.logits(self(x), sent_embs)


def disc_modulation_shapes(cfg: Config, batch: int) -> list[tuple[int, int, int, int]]:
    """NCHW shapes of the ``modulate_lrelu`` inputs of one ``CONCEPT_NETD``
    trunk pass, in call order (one per ``ConceptResD``: 128 channels at
    half each block's input resolution), from the arch table alone."""
    arch = disc_arch(cfg.IMG.SIZE, cfg.TRAIN.NCH)
    res = cfg.IMG.SIZE
    shapes = []
    for i in range(1, arch["depth"]):
        res //= 2  # conv_img keeps the size; each block's split conv halves it
        shapes.append((batch, CARDINALITY * BOTTLENECK, res, res))
    return shapes
