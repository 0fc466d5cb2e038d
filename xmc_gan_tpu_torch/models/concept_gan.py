"""Word-attention concept GAN generators (``CONCEPT_INATTN_GEN`` /
``CONCEPT_OUTATTN_GEN``) as PyTorch modules (port of
``xmc_gan_tpu/models/concept_gan.py``).

* **InNetG / OutNetG** — global condition ``[noise; proj_sent]``, two plain
  conditional-BN ``ResBlockUp`` stages, then word-attention concept blocks,
  ``lrelu -> conv3x3 -> tanh`` (``:355-429``).
* **InConceptBlock** — image queries attend over the caption's words per
  concept group (``WordCondConceptSampler``); **OutConceptBlock** — concept
  states attend over the words.  Both feed per-group gamma/beta projections
  that modulate the grouped features.

The two masked word attentions are the function of
``ops/cross_attention.masked_cross_attention``, so they go through it: on the
card, the hand-written CUDA kernel.  (The JAX package computes them as an
einsum + softmax chain, ``:167-179`` and ``:299-306``, for a reason of the
TPU's matrix unit that does not hold here.)  For every caption with at least
one word the result is the JAX package's; a caption whose words are all
padded gets a zero context where the JAX chain gives NaN.

The reference module was never runnable (``concept_gan.py:8-21``), so the
parameter names follow the JAX module tree: ``block{i}.concept1.
concept_sampler1.query_gconv.weight`` and so on, with ``kernel`` as
``weight`` in PyTorch layout (grouped projections as grouped 1x1 conv
weights ``[C*d_out, d_in, 1, 1]``), GroupNorm ``scale`` as ``weight``
(``utils/convert.concept_generator_state_dict``).  Activations are NCHW in
``channels_last`` memory; parameters are fp32, ``dtype`` is the activation
type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.models.common import concept_gen_arch, inits
from xmc_gan_tpu_torch.models.df_concept_gan import (
    BOTTLENECK,
    CARDINALITY,
    STATE_DIM,
    ConceptReasoner,
    ConceptSampler,
    _ConceptTrunk,
    channels_last,
    grouped,
)
from xmc_gan_tpu_torch.ops.cross_attention import masked_cross_attention
from xmc_gan_tpu_torch.ops.grouped import GroupedDense, GroupNorm
from xmc_gan_tpu_torch.ops.modules import SNConv, SNDense, leaky_relu, upsample_nearest_2x

__all__ = ["ResBlockUp", "set_mesh", "WordCondConceptSampler", "InConceptBlock",
           "OutConceptBlock", "InNetG", "OutNetG", "attention_shapes", "attention_step_launches"]


def _batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5, mesh=None) -> torch.Tensor:
    """Pure batch-statistics BatchNorm2d of an NCHW tensor (``:57-64``).

    Not ``nn.BatchNorm2d``: ``make_generator`` puts G in ``eval()``, where
    that module would read running averages.  The JAX module normalizes by
    the current batch's statistics always (the reference's train-mode
    behaviour, without the running-average side channel).

    Under data parallelism (``mesh``, a ``parallel.Mesh``) the statistics
    are the *global* batch's, as under the JAX package's mesh (module
    docstring ``:28-30``): the sum, then the sum of squared deviations from
    the global mean, each all-reduced with gradient over the data group."""
    xf = x.float()
    if mesh is None:
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), keepdim=True, correction=0)
    else:
        from xmc_gan_tpu_torch.parallel.collectives import all_reduce_with_grad

        n = xf.shape[0] * xf.shape[2] * xf.shape[3] * mesh.dp
        mean = all_reduce_with_grad(xf.sum((0, 2, 3), keepdim=True), mesh) / n
        var = all_reduce_with_grad((xf - mean).square().sum((0, 2, 3), keepdim=True), mesh) / n
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)


class ResBlockUp(nn.Module):
    """Conditional-BN residual up-block of the first two stages (``:67-119``,
    reference ``:454-512``): gamma/beta from bias-free Linears on the global
    condition, BN -> modulate -> ReLU -> (up) -> conv3x3, twice; plain
    residual add.  ``fuse_upsample`` folds the pre-conv upsample into ``c1``
    as a stride-2 transposed conv and runs the shortcut's 1x1 at the low
    resolution (exact math, same parameters)."""

    def __init__(self, in_dim: int, out_dim: int, cond_dim: int, upsample: bool,
                 normalize: bool, he_init: bool, fuse_upsample: bool = True, *,
                 gen: torch.Generator):
        super().__init__()
        self.upsample, self.normalize = upsample, normalize
        self.mesh = None  # the data-parallel group of the BN statistics (set_mesh)
        self.fold = upsample and fuse_upsample
        kc, _ = inits(he_init, cond_dim)
        for idx, feat in ((1, in_dim), (2, out_dim)):
            for name in ("gamma", "beta"):
                self.add_module(f"linear_{name}{idx}", SNDense(
                    cond_dim, feat, use_bias=False, weight_init=kc, gen=gen))
            if normalize:
                self.register_parameter(f"bn{idx}_scale", nn.Parameter(torch.ones(feat)))
                self.register_parameter(f"bn{idx}_bias", nn.Parameter(torch.zeros(feat)))
        k1, b1 = inits(he_init, in_dim * 9)
        self.c1 = SNConv(in_dim, out_dim, 3, padding=1, pre_upsample=self.fold, weight_init=k1,
                         bias_init=b1, gen=gen)
        k2, b2 = inits(he_init, out_dim * 9)
        self.c2 = SNConv(out_dim, out_dim, 3, padding=1, weight_init=k2, bias_init=b2, gen=gen)
        if in_dim != out_dim:
            ks, bs_ = inits(he_init, in_dim)
            self.c_sc = SNConv(in_dim, out_dim, 1, weight_init=ks, bias_init=bs_, gen=gen)
        else:
            self.c_sc = None

    def _affine(self, h: torch.Tensor, cond: torch.Tensor, idx: int) -> torch.Tensor:
        gamma = getattr(self, f"linear_gamma{idx}")(cond)[:, :, None, None]
        beta = getattr(self, f"linear_beta{idx}")(cond)[:, :, None, None]
        if self.normalize:
            h = _batch_norm(h, getattr(self, f"bn{idx}_scale"), getattr(self, f"bn{idx}_bias"),
                            mesh=self.mesh)
        return torch.relu(gamma * h + beta)

    def forward(self, x: torch.Tensor, global_cond: torch.Tensor) -> torch.Tensor:
        out = self._affine(x, global_cond, 1)
        if self.upsample and not self.fold:
            out = upsample_nearest_2x(out)
        out = self.c2(self._affine(self.c1(out), global_cond, 2))
        sc = upsample_nearest_2x(x) if self.upsample and not self.fold else x
        if self.c_sc is not None:
            sc = self.c_sc(sc)
        if self.fold:
            sc = upsample_nearest_2x(sc)
        return out + sc


def set_mesh(model: nn.Module, mesh) -> None:
    """Normalize every ``ResBlockUp`` of ``model`` by the statistics of the
    global batch of ``mesh``'s ranks (``None``: of the local batch).  Every
    rank must then run each of the model's forwards, since each BatchNorm
    is a collective."""
    for m in model.modules():
        if isinstance(m, ResBlockUp):
            m.mesh = mesh


class WordCondConceptSampler(nn.Module):
    """Masked word-region attention per concept group (``:122-179``,
    reference ``CondConceptSampler`` ``:516-580``): image queries
    ``[B, HW, C, p']`` against per-group word keys ``[B, T, C, p']``, cosine
    similarity over ``p'`` (both l2-normalized), padding masked, softmax over
    words, context = attention-weighted *normalized keys*, mean over space ->
    ``[B, C, p']``.

    The attention is ``masked_cross_attention(qn, kn, kn, mask, scale=1)`` on
    ``[B, C, HW, p']`` / ``[B, C, T, p']`` views of the grouped tensors, the
    mask shared by the C groups; the queries are read in place (a strided
    view of the channels_last query map).  The key GroupNorm takes its
    statistics over all T word slots, padded ones included (``:163-165``)."""

    def __init__(self, cardinality: int, state_dim: int, text_dim: int, normalize: bool,
                 he_init: bool, in_per_group: int = BOTTLENECK, *, gen: torch.Generator):
        super().__init__()
        C, q = cardinality, state_dim
        self.cardinality = C
        kq, _ = inits(he_init, in_per_group)
        kk, _ = inits(he_init, text_dim)
        self.query_gconv = GroupedDense(C, in_per_group, q, use_bias=False, weight_init=kq,
                                        gen=gen)
        self.key_gconv = GroupedDense(C, text_dim, q, use_bias=False, weight_init=kk, gen=gen)
        self.gn1 = GroupNorm(C, C * q) if normalize else None
        self.gn2 = GroupNorm(C, C * q) if normalize else None

    def forward(self, x: torch.Tensor, words_embs: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        C = self.cardinality
        b, T, e = words_embs.shape
        query = self.query_gconv.conv(x)  # [B, C*p', H, W]
        key = self.key_gconv(words_embs[:, :, None, :].expand(b, T, C, e).reshape(b * T, C, e))
        key = key.view(b, T, C, -1)
        if self.gn1 is not None:
            query = self.gn1(query)
            # [B, C*p', T]: statistics per group over every word slot
            key = self.gn2(key.reshape(b, T, -1).transpose(1, 2)).transpose(1, 2).reshape(key.shape)
        qn = F.normalize(grouped(query, C), dim=-1)  # [B, HW, C, p']
        kn = F.normalize(key, dim=-1).transpose(1, 2)  # [B, C, T, p']
        ctx = masked_cross_attention(qn.transpose(1, 2), kn, kn, mask, 1.0)  # [B, C, HW, p']
        return ctx.mean(dim=2)


class _WordGammaBeta(nn.Module):
    """Single grouped 1x1 modulation projection (``:182-193``, reference
    ``gamma*_gconv`` ``:189-192``): ``[B, C, gc_dim+p'] -> [B, C, p]``."""

    def __init__(self, cardinality: int, cond_in: int, out_per_group: int, he_init: bool, *,
                 gen: torch.Generator):
        super().__init__()
        k, b = inits(he_init, cond_in)
        self.g = GroupedDense(cardinality, cond_in, out_per_group, weight_init=k, bias_init=b,
                              gen=gen)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        return self.g(cond)


def _modulate_relu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``relu(gamma * x + beta)`` with ``[B, C, p]`` projections broadcast over
    the NCHW map's space (channel ``c*p + j``)."""
    b = x.shape[0]
    return torch.relu(gamma.reshape(b, -1, 1, 1) * x + beta.reshape(b, -1, 1, 1))


class _WordConceptBlock(_ConceptTrunk):
    """What the two word-attention blocks share: the trunk (ReLU), the
    reasoners and the gamma/beta projections of both phases; ``upsample``
    runs after phase 1 (threaded explicitly: the reference forgets to set
    it)."""

    def __init__(self, in_dim: int, gc_dim: int, upsample: bool, normalize: bool,
                 he_init: bool, *, gen: torch.Generator):
        super().__init__()
        self._build_trunk(in_dim, normalize, he_init, False, gen)
        self.upsample = upsample
        for ph in (1, 2):
            self.add_module(f"concept_reasoner{ph}", ConceptReasoner(
                CARDINALITY, STATE_DIM, he_init, gen=gen))
            for name in ("gamma", "beta"):
                self.add_module(f"{name}{ph}_gconv", _WordGammaBeta(
                    CARDINALITY, gc_dim + STATE_DIM, BOTTLENECK, he_init, gen=gen))

    def _context(self, out: torch.Tensor, ph: int, words_embs: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """Phase ``ph``'s ``[B, C, p']`` word context of the map ``out``."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor, global_cond: torch.Tensor, words_embs: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        out = self._trunk(x, torch.relu)
        gc = global_cond[:, None, :].expand(x.shape[0], CARDINALITY, global_cond.shape[1])
        for ph in (1, 2):
            cond = torch.cat([gc, self._context(out, ph, words_embs, mask)], dim=-1)
            out = _modulate_relu(out, getattr(self, f"gamma{ph}_gconv")(cond),
                                 getattr(self, f"beta{ph}_gconv")(cond))
            if ph == 1 and self.upsample:
                out = upsample_nearest_2x(out)
        return channels_last(out)


class InConceptBlock(_WordConceptBlock):
    """Word-attention concept block, image-query variant (``:196-249``,
    reference ``InConceptBlock`` ``:169-239``)."""

    def __init__(self, in_dim: int, gc_dim: int, text_dim: int, upsample: bool,
                 normalize: bool, he_init: bool, *, gen: torch.Generator):
        super().__init__(in_dim, gc_dim, upsample, normalize, he_init, gen=gen)
        for ph in (1, 2):
            self.add_module(f"concept_sampler{ph}", WordCondConceptSampler(
                CARDINALITY, STATE_DIM, text_dim, normalize, he_init, gen=gen))

    def _context(self, out, ph, words_embs, mask):
        ctx = getattr(self, f"concept_sampler{ph}")(out, words_embs, mask)
        return getattr(self, f"concept_reasoner{ph}")(ctx)


class OutConceptBlock(_WordConceptBlock):
    """Word-attention concept block, concept-state-query variant
    (``:252-316``, reference ``OutConceptBlock`` ``:346-449``, with the
    JAX package's fixes of the phase-2 wiring and the cosine axes): each
    phase's concept states ``[B, C, p']`` attend over the words projected to
    ``p'``, ``masked_cross_attention(sn, wn, wn, mask)`` on l2-normalized
    operands."""

    def __init__(self, in_dim: int, gc_dim: int, text_dim: int, upsample: bool,
                 normalize: bool, he_init: bool, *, gen: torch.Generator):
        super().__init__(in_dim, gc_dim, upsample, normalize, he_init, gen=gen)
        kw, _ = inits(he_init, text_dim)
        for ph in (1, 2):
            self.add_module(f"concept_sampler{ph}", ConceptSampler(
                CARDINALITY, STATE_DIM, normalize, he_init, gen=gen))
            self.add_module(f"word_conv{ph}", SNDense(text_dim, STATE_DIM, use_bias=False,
                                                      weight_init=kw, gen=gen))

    def _context(self, out, ph, words_embs, mask):
        state = getattr(self, f"concept_reasoner{ph}")(getattr(self, f"concept_sampler{ph}")(out))
        sn = F.normalize(state, dim=-1)  # [B, C, p']
        wn = F.normalize(getattr(self, f"word_conv{ph}")(words_embs), dim=-1)  # [B, T, p']
        return masked_cross_attention(sn, wn, wn, mask, 1.0)


class _AttnResBlockUp(nn.Module):
    """Residual wrapper around one word-attention concept block (``:319-352``,
    reference ``ICAttnResBlockUp`` ``:123-166`` / ``OCAttnResBlockUp``
    ``:300-343``): residual = concept -> 1x1 conv; shortcut = (up) + 1x1 when
    the dims change (the 1x1 runs before the upsample here: it commutes
    exactly with nearest upsampling); plain add."""

    def __init__(self, in_dim: int, out_dim: int, gc_dim: int, text_dim: int, upsample: bool,
                 normalize: bool, he_init: bool, inner: str, *, gen: torch.Generator):
        super().__init__()
        self.upsample = upsample
        block_cls = InConceptBlock if inner == "in" else OutConceptBlock
        self.concept1 = block_cls(in_dim, gc_dim, text_dim, upsample, normalize, he_init,
                                  gen=gen)
        gw = CARDINALITY * BOTTLENECK
        ko, bo = inits(he_init, gw)
        self.conv_out1 = SNConv(gw, out_dim, 1, weight_init=ko, bias_init=bo, gen=gen)
        if in_dim != out_dim:
            ks, bs_ = inits(he_init, in_dim)
            self.c_sc = SNConv(in_dim, out_dim, 1, weight_init=ks, bias_init=bs_, gen=gen)
        else:
            self.c_sc = None

    def forward(self, x, global_cond, words_embs, mask):
        h = self.conv_out1(self.concept1(x, global_cond, words_embs, mask))
        sc = x if self.c_sc is None else self.c_sc(x)
        if self.upsample:
            sc = upsample_nearest_2x(sc)
        return h + sc


class _AttnNetG(nn.Module):
    """Shared skeleton (``:355-421``, reference ``InNetG`` ``:67-121`` /
    ``OutNetG`` ``:244-298``).  ``forward(noise, sent_embs, words_embs,
    mask)`` needs the words and their mask (``ValueError`` without them) and
    returns ``tanh`` of the output in fp32, NCHW in ``channels_last`` memory.
    ``fuse_upsample`` folds ``ResBlockUp``'s in-block upsample (the attention
    blocks' mid-block upsample sits between attention statistics and is never
    folded)."""

    inner = "in"

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32,
                 fuse_upsample: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        nef, he, emb = cfg.TRAIN.NEF, cfg.TRAIN.HE_INIT, cfg.TEXT.EMBEDDING_DIM
        arch = self.arch = concept_gen_arch(cfg.IMG.SIZE, cfg.TRAIN.NCH)
        gc_dim = cfg.TRAIN.NOISE_DIM + nef
        ks, bs_ = inits(he, emb)
        self.proj_sent_dense = SNDense(emb, nef, weight_init=ks, bias_init=bs_, gen=gen)
        kw, bw = inits(he, emb)
        self.proj_word = SNDense(emb, nef, weight_init=kw, bias_init=bw, gen=gen)
        kc, bc = inits(he, gc_dim)
        self.proj_cond = SNDense(gc_dim, arch["in_channels"][0] * 16, weight_init=kc,
                                 bias_init=bc, gen=gen)
        for i in range(arch["depth"]):
            dims = arch["in_channels"][i], arch["out_channels"][i]
            if arch["attention"][i]:
                block = _AttnResBlockUp(*dims, gc_dim, nef, arch["upsample"][i],
                                        cfg.GEN.NORMALIZE, he, self.inner, gen=gen)
            else:
                block = ResBlockUp(*dims, gc_dim, arch["upsample"][i], cfg.GEN.NORMALIZE, he,
                                   fuse_upsample, gen=gen)
            self.add_module(f"block{i}", block)
        ko, bo = inits(he, arch["out_channels"][-1] * 9)
        self.conv_out = SNConv(arch["out_channels"][-1], 3, 3, padding=1, weight_init=ko,
                               bias_init=bo, gen=gen)

    def project_sent(self, sent_embs: torch.Tensor) -> torch.Tensor:
        return self.proj_sent_dense(sent_embs)

    def forward(self, noise: torch.Tensor, sent_embs: torch.Tensor,
                words_embs: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if words_embs is None or mask is None:
            raise ValueError(f"{type(self).__name__} attends over the caption's words: pass "
                             "words_embs [B, T, E] and mask [B, T]")
        bs = noise.shape[0]
        sent = self.project_sent(sent_embs.to(self.dtype))
        words = self.proj_word(words_embs.to(self.dtype))  # [B, T, nef]
        mask = mask.bool()
        global_cond = torch.cat([noise.to(self.dtype), sent], dim=1)
        # the reference's view(B, C, 4, 4): already NCHW here (JAX :414 transposes to NHWC)
        out = channels_last(self.proj_cond(global_cond).view(bs, self.arch["in_channels"][0],
                                                              4, 4))
        for i in range(self.arch["depth"]):
            block = getattr(self, f"block{i}")
            if self.arch["attention"][i]:
                out = block(out, global_cond, words, mask)
            else:
                out = block(out, global_cond)
        return torch.tanh(self.conv_out(leaky_relu(out)).float())


class InNetG(_AttnNetG):
    inner = "in"


class OutNetG(_AttnNetG):
    inner = "out"


def attention_shapes(cfg: Config, batch: int, inner: str = "in"
                     ) -> list[tuple[int, int, int, int, int]]:
    """``(B, G, N, T, D)`` of each ``masked_cross_attention`` launch of one
    word-attention generator forward, in call order (two per attention
    block), from the arch table alone: In attends ``HW`` queries per concept
    group (``G = 16``), Out the 16 concept states of a row (``G = 1``)."""
    arch = concept_gen_arch(cfg.IMG.SIZE, cfg.TRAIN.NCH)
    T = cfg.TEXT.MAX_LENGTH
    shapes, res = [], 4
    for i in range(arch["depth"]):
        after = res * 2 if arch["upsample"][i] else res
        if arch["attention"][i]:
            if inner == "in":
                shapes += [(batch, CARDINALITY, res * res, T, STATE_DIM),
                           (batch, CARDINALITY, after * after, T, STATE_DIM)]
            else:
                shapes += [(batch, 1, CARDINALITY, T, STATE_DIM)] * 2
        res = after
    return shapes


def attention_step_launches(cfg: Config, inner: str = "in") -> dict[str, int]:
    """``masked_cross_attention`` launches of one train step that updates G
    (every step at ``N_CRITIC`` = 1), from the arch table: one forward per
    attention for D's fake (under ``no_grad``), one more under autograd for
    G's update, and one backward each (12 / 6 at 64²: attention at blocks
    2-4)."""
    n = len(attention_shapes(cfg, 1, inner))
    return {"cross_attention.forward": 2 * n, "cross_attention.backward": n}
