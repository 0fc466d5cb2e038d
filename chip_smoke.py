#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then non-zero):

1. Card check: CUDA must be available; prints the card's name and power limit.
2. Build: compiles the three CUDA sources (``xmc_gan_tpu_torch/csrc``), one
   ``nvcc`` each (``damsm_score.cu`` three, ``ds.LIBRARIES``: the
   forward's, d_regions' and d_words' entry points), started together, and
   prints the build time.
3. Each kernel against its plain PyTorch version on the card: the
   ``fused_affine`` forward and backward (both forms, fp32 and bf16) at the
   14 epilogue shapes of the 256², NCH=32, batch-128 generator, at the
   LN-COCO step's 14 at its own batch of 256 and, in fp32 with fp32
   vectors, at the fp32 LN-COCO step's 14 at batch 128 (the plain versions
   a few images at a time) plus a ragged one, the backward with fp32 and
   with bf16 vectors, each launch on the kernel and grid ``plan_bwd`` gives the
   step (``fused_affine_bwd_vec`` at every path width), and the single form through its wrapper at the distinct
   ``modulate_lrelu`` shapes of a 256² concept-DF request at batch 128 (128
   channels, up to 2^30 elements); the ``damsm_score`` forward, d_regions and d_words at the flagship
   word-loss shape (B = Bc = 128, R = 256, T = 20, D = 256), at a ragged
   one (R = 50, T = 7, D = 48, one all-padded caption) and at the edges of
   the bf16 tensor-core kernels and the bf16 CUDA-core ones at R = 300
   (``DAMSM_EDGES``), compute dtype fp32 and bf16, through ``damsm_scores``
   (captions longer than a kernel of the route takes as sub-captions), each
   launch's kernel the one the route rule names; fp32 also at its own edges
   (``DAMSM_F32_EDGES``: D = 42; T = 64 as two 48-slot sub-captions, the
   packed d_regions' rows; T = 64 unsplit at R = 300; R = 300 at D = 768,
   the CUDA-core kernels' 256-column chunks); the bf16
   forward, d_regions and d_words, which run on the tensor cores
   (``mma.sync``; the d_words with the regions streamed at every D), and
   the fp32 forward and d_regions (CUDA cores, packed real words, regions
   streamed; the fp32 d_words on the CUDA cores), also
   twice bit-equal, the forwards' all-padded caption scoring exactly the
   plain value, the d_regions unmoved by its cotangent and its d_words
   exactly 0; the three
   ``damsm_score`` kernels at the LN-COCO word shape (B = Bc = 256, R = 256,
   T = 200, D = 768: each caption's real words packed into sub-captions of
   32 slots in bf16, 16 in fp32 (``LN_WIDTH``), as many as the longest
   caption needs) in fp32 and
   bf16, and in fp32 at the fp32 step's B = Bc = 128 (``LN_CHECKS``), through ``damsm_scores`` against the plain version on the whole
   captions, with an all-padded caption (its score bit-equal to the plain
   value, no d_words), two runs bit-equal, and the profiler's kernel names
   showing each kernel's route (at D = 768 the bf16 kernels on the tensor
   cores with the regions streamed, the fp32 forward and d_regions on the
   wide packed kernels, the fp32 d_words on the CUDA cores), the all-padded
   caption's cotangent moving no d_regions; the three kernels above
   D = 256 also at their edges in both dtypes (``DAMSM_STREAMED``: D = 520,
   770 and 1024, through ``damsm_scores``; bf16 streamed, fp32 wide)
   against the plain version, the all-padded caption's score the plain
   value, twice bit-equal, its cotangent moving nothing; the forward and
   d_regions on a data-parallel rank's row blocks (``DAMSM_ROW_BLOCKS``:
   the first and the last B_local of B_global images against all B_global
   captions, [128, 256] and [4, 8] at the flagship word shape), fp32 and
   bf16, through ``damsm_scores`` against the plain version, each launch on
   the kernel the route names, and against the same rows of one
   [B_global, B_global] launch (logged bit-equal or not); the forward and
   d_regions on a tensor-parallel rank's column blocks
   (``DAMSM_COL_BLOCKS``: B_local images against the last B/tp captions,
   [64, 32] at the LN word shape in bf16 on the tensor cores and [4, 4] of
   [8, 8] at the flagship's in fp32) against the plain version and the
   same block of one whole launch; the
   ``cross_attention`` kernels through the wrapper the concept
   models call, fp32 and bf16, at the distinct
   shapes of a 256² ``CONCEPT_INATTN_GEN`` request at batch 128 (2048 rows
   of T = 15, D = 4, N from 256 to 65,536, the grouped queries read
   strided: ``attn_grouped``), the ``CONCEPT_OUTATTN_GEN`` shape, the JAX
   package's kernel shape (N = 300, T = 260, D = 32), a D = 256 one, a
   ragged one and ``attn_grouped``'s edges (``ATTN_EXTRA``), with a
   fully padded row (0 in both), each shape's planned kernel logged; the
   ``fused_affine`` single form's backward at every shape of the published
   ``concept_out_df_gan.yml`` step (batch 88, 128 channels, D's 32² to 4²,
   G's 4² to 64²) and its double backward (``fused_affine_bwd2_vec``, what
   MAGP through ``CONCEPT_NETD`` launches) at D's four, fp32 and bf16, the
   vectors in x's dtype, and the double backward in fp32 against fp64
   autograd of the plain epilogue (``BWD2_FP64_SHAPE``); the
   ``cross_attention`` backward (the port's own: ``attn_bwd_warp`` up to
   32 words and D = 4, ``attn_bwd`` past them) against
   ``masked_cross_attention_bwd_ref``, fp32 and bf16, at every distinct In
   and Out shape of the 64² word-attention train step (batch 88, the In
   queries as rows and as planes), ``ATTN_BWD_WARP_EDGES`` (T = 1, 20 and
   32, N = 1, 33 and 77, D = 3, queries 30 times as long) and
   ``ATTN_BWD_EXTRA`` (``attn_bwd``'s: T = 200, D = 12 at T = 33, the
   widest plan), fully padded rows (zero gradients) and one-word rows
   (exactly zero dq and dk),
   through autograd with dO as the upstream op hands it over (dense from
   the In sampler's mean, a strided slice from the Out block's
   concatenation), two runs bit-equal, each launch's kernel the one
   ``plan_bwd`` names.
4. On the card against the CPU, fp32 with TF32 off, on the same seeded,
   perturbed weights and numpy inputs: (a) the serving slice (DAMSM encoder
   + NetG at 256², NCH=32, batch 4), (b) the train slice (NCH=8, 64², batch
   4, WORD + SPEC_NORM + MAGP, two steps; the card's word scores go through
   the damsm kernels), (c) the four concept generators (NCH=8, 64², batch 4,
   T = 15, one caption of one word), (d) the LN-COCO step
   (``ln_coco_256.yml`` at NCH=8, 64², batch 4, word shape kept: T = 200,
   D = 768; two steps, the card's word scores through the damsm kernels as
   sub-captions, the CPU's through the plain path on whole captions), (e)
   the ``concept_out_df_gan.yml`` step at NCH=8, batch 4 (two steps, MAGP
   through ``CONCEPT_NETD``: the card's 60 / 40 / 4 ``fused_affine``
   forward / backward / double-backward launches a step asserted), (f) a
   step of each word-attention generator (``concept_in_df_gan.yml`` with
   ``GEN.ENCODER_NAME`` set, NCH=8, 64², batch 4, two steps: the card's
   12 / 6 ``cross_attention`` forward / backward launches a step asserted),
   (g) the train slice of (b) with ``ENCODER_LOSS.VGG`` on (the same random
   VGG-19 on both).
5. Full-width serving: random caption ids (batch 128, mixed lengths) ->
   ``make_encode_fn`` -> ``make_sample_fn``, fp32 and bf16, (a) for DF_GEN
   (``df_gan_damsm.yml``, T = 20) and (c) for each concept generator
   (``concept_in_df_gan.yml``, T = 15, NCH=32, 256²); checks each request's
   kernel launches (DF_GEN: fused_affine 14; CONCEPT_IN/OUT_DF_GEN:
   fused_affine 28; CONCEPT_INATTN/OUTATTN_GEN: cross_attention 10, by the
   profiler's names ``attn_grouped`` for In and ``attn_small`` for Out;
   nothing else), that the images are finite, in [-1, 1] and of the right
   shape, and prints images/s (median of 5), peak memory, and where one request's
   device time goes (``torch.profiler``, by kernel category; every trace
   must be whole: each runtime launch with its kernel and the counted
   launches of the port's kernels by name, ``profiling.device_kernels``);
   (5c) ``ln_coco_256.yml`` (NCH 96) serving from its SBERT cache: 128
   captions' rows of a synthetic ``sbert_cache_test.npz`` (T = 200, D = 768,
   fp16) -> ``make_encode_fn`` -> ``make_sample_fn`` -> 128 images at 256²,
   fp32 and bf16, 14 ``fused_affine`` forwards asserted, the cache read, the
   encode and the G forward timed apart; (5d) the exported samplers
   (``utils/export.py``, ``torch.export``): DF_GEN and the two
   word-attention generators at 256², NCH 32, on phase 5's perturbed
   weights, each exported in fp32 and bf16 with a symbolic batch and saved
   (export seconds, the graph's operator nodes: 14 / 10 / 10), then loaded
   in one fresh process that imports only ``utils.export`` (and the
   profiler reader; any other module of the port fails the phase), which
   serves a 128-row and a 3-row request of each: launches counted by the
   wrappers (14 ``fused_affine``; 10 ``cross_attention``, nothing else)
   and by the profiler's names (``fused_affine_vec``, ``attn_grouped`` for
   In, ``attn_small`` for Out), the request's median of 5; the images held
   to ``make_sample_fn``'s on the same weights and inputs (``EXPORT_TOL``:
   fp32, TF32 off, 1e-5 or twice the spread of two ``make_sample_fn`` runs
   where cuDNN's fp32 algorithms make that larger; bf16 one bf16 ulp), and
   the program (before it was saved) and ``make_sample_fn`` timed in turns
   in this process (median of 5 each); (5e) SBERT encoding
   (``data/text_encode.py``: the port's byte-level BPE tokenizer and RoBERTa
   encoder) on a seeded checkpoint at the published ``stsb-roberta-base``
   shape in a temporary HF hub cache (``HF_HUB_CACHE``):
   ``build_sbert_cache`` over 2,048 train and 512 test LN-length captions
   (some longer than T = 200 tokens), the caches read back; the tokenizer
   (host) and the encoder (card, fp32, TF32 off) timed apart, the encoder's
   busy share, bound and peak memory; the card's embeddings against the
   port's CPU encode (``SBERT_TOL``); 128 new captions through
   ``make_hf_sbert_encode`` -> ``SBERTEncoder`` -> the ``ln_coco_256.yml`` G
   at 256², fp32 and bf16, 14 ``fused_affine`` forwards asserted; ``cli
   sample`` and ``cli prep-ln --build_cache`` once (its caches within one
   fp16 ulp of ``build_sbert_cache``'s rows); ``cli train --synthetic
   --max_steps 2 --gpu 0 --debug_nans`` as a process of its own, run beside
   phase 3 (which times nothing) and checked after it.
6. Full-width training: the ``flagship_word`` step (DF-GAN G + D at 256²,
   NCH=32, batch 128, RMIS, MAGP, sentence/image/word-region InfoNCE) from
   ``create_train_state`` + ``make_train_step``, bf16 activations (2 warm-up
   and 5 timed steps) and fp32 with TF32 off (1 warm-up, 2 timed); checks
   each kernel's launches in one step (fused_affine 28 forward / 14
   backward, damsm 2 forward / 2 d_regions / 0 d_words), that the trace's
   forward and d_regions launches are the kernels the route rule names (the
   tensor-core ones in bf16; in fp32 the forward and the d_regions with
   packed words), that its 14 ``fused_affine`` backward launches are the
   kernels and grids ``plan_bwd`` gives, by the profiler's names and grids
   (the trace whole, as in phase 5), and that the losses
   are finite; prints the kernels one step launches, the copies of dy that
   the backward's wrapper made, images/s (median),
   peak memory, one step's device time by kernel category and the damsm
   kernels by name.  Then the LN-COCO step (``ln_coco_256.yml`` as it
   stands: NCH=96, NOISE_DIM=128, batch 256, T = 200, word D = 768,
   synthetic embeddings, about half the word slots real, one all-padded
   caption) in bf16, and in fp32 (TF32 off) at batch 128
   (``LN_FP32_BATCH``: 256 does not fit the card in fp32): 1 counted
   warm-up step each (the launches asserted as above, the damsm forward and
   d_regions in bf16 on the tensor cores with the regions streamed, in fp32
   on the wide packed kernels, 2 launches each by the profiler's names), 2
   timed in bf16 and 1 in fp32, 1 profiled; prints the step ms, images/s, peak memory, the
   device ms by category (``damsm_score`` among them) and the ten largest
   kernels.
6b. Full-width training through ``Trainer.fit`` (the port's training
   program): the flagship_word config of phase 6 in bf16 on 512 synthetic
   examples (4 steps an epoch, one in-epoch grid an epoch), 2 epochs with
   ``save_after=0``, auto-checkpoints every 3 steps and FID after the second
   (the random-init Inception, the 128-example test split), steps 2
   and 3 traced by the trainer's own ``profile_dir``; then a fresh
   ``Trainer`` on the same run resumes from the newest auto-checkpoint
   (step 6, 2 batches of epoch 2 skipped) and trains on to the end of
   epoch 3, its epochs without FID (``eval_fid=False``).  Checks every
   launch of both runs (28 / 14 ``fused_affine``, 2 / 2 / 0 damsm a step,
   14 ``fused_affine`` forwards a grid or FID batch), the traced steps'
   kernels by name, the files the run wrote (``img/``, ``log/``,
   ``model/`` epochs 1 and 2, ``model/auto`` steps 3 and 6) and finite
   losses; prints the loop's step wall (median over the
   steps without a trace, save or epoch edge) beside phase 6's bare step,
   the loader's ms a batch and the decode route, the device busy share,
   one checkpoint's save and restore ms and bytes, the FID eval's ms (and
   the host ``sqrtm``'s part) and peak memory.  (Phase 5e runs ``cli
   train``.)  The runs' directories are deleted.
6c. ``concept_out_df_gan.yml`` as published (CONCEPT_OUT_DF_GEN +
   CONCEPT_NETD, SBERT synthetic table, 64², NCH 32, batch 88, MAGP, RMIS,
   SENT + DISC) through ``Trainer.fit``, bf16 and fp32: one epoch of
   ``CONCEPT_LOOP_STEPS`` steps, a checkpoint, the epoch's grid; the fit's
   launches and one more step's (``concept_step_launches``: 60 / 40 / 4
   ``fused_affine`` forward / backward / double backward, from
   ``gen_arch``/``disc_arch`` and the step's passes) asserted, the double
   backward's kernels by name; prints the loop step, the bare step (median
   of 3), one step's device time by category, a checkpoint's save ms.
6d. ``ln_coco_256.yml`` as it stands (NCH 96, batch 256, bf16) through
   ``Trainer.fit`` on the SBERT synthetic table, ``LN_LOOP_STEPS`` steps, no
   FID and no checkpoint: damsm 2 + 2 and ``fused_affine`` 28 / 14 a step
   asserted; prints the loop step beside phase 6's bare LN step.
6e. The word-attention generators train: ``concept_in_df_gan.yml`` as
   published (64², NCH 32, batch 88, T = 15, RNN words, GroupNorm, RMIS,
   MAGP, DF_DISC) with ``GEN.ENCODER_NAME`` = CONCEPT_INATTN_GEN and
   CONCEPT_OUTATTN_GEN, through ``Trainer.fit`` in bf16 and fp32 (TF32
   off), ``ATTN_LOOP_STEPS`` steps and the epoch's grid: 12 / 6
   ``cross_attention`` forward / backward launches a step
   (``attention_step_launches``) and no other of the port's kernels, by
   the counts and by the profiler's names; prints the loop step, the bare
   step (median of 3), images/s, peak memory and one step's device time by
   category.
6f. The flagship_word step of phase 6 with ``ENCODER_LOSS.VGG`` on and a
   random-init VGG-19, bf16, 2 warm-up and 3 timed steps: the launches of
   phase 6 asserted (``fused_affine`` 28 / 14, damsm 2 + 2); prints the
   step beside phase 6's and the VGG's share of the step's device time.
6g. Data parallelism (``parallel``, ``make_train_step(mesh=...)``): (a) the
   flagship_word bf16 step of phase 6 on a one-rank NCCL group in this
   process (real NCCL init, all_gather and all_reduce; 2 warm-up, 5 timed,
   launches and kernels asserted as in phase 6), its step beside phase 6's;
   (b) two ranks on this one card over gloo (NCCL refuses two ranks on one
   card; gloo stages CUDA tensors through the host), processes of this
   script (``--dp-rank``): the parity step (fp32, TF32 off, NCH 8, 64², a
   global batch of 8, each rank's [4, 8] word-score row block on the damsm
   kernels, 2 steps) against one process on the card at batch 8 (metrics
   and parameters within phase 4's bounds, the ranks' parameters
   bit-equal, each rank's damsm launches asserted), then the full width
   (bf16, 256², NCH 32, 2 x 128 rows, the [128, 256] row block on the
   kernels; 1 warm-up, 1 counted, 2 timed steps): each rank's step, the
   global images/s, peak memory a rank, the gradient mean's own time; (c)
   where the machine has two cards or more, the full width on two NCCL
   ranks, one card each.  Prints which of them ran.
6h. Tensor parallelism (``parallel.shard_state``, the JAX rule's split of
   G's and D's large weights by output features over the model group):
   (a) four gloo ranks on this card as dp 2 x tp 2 (``--dp-tp 2``): phase
   6g's parity step (fp32, TF32 off, NCH 8, 64², a global batch of 8, the
   weights split at the JAX tests' 2^12, each rank's [4, 4] word-score
   column block on the damsm kernels, 2 steps) against one process on the
   card (metrics, the gathered parameters and spectral vectors within
   phase 4's bounds, the ranks' gathered states bit-equal, each rank's
   damsm launches asserted); (b) two gloo ranks as dp 1 x tp 2 at the
   LN-COCO model's full width (``ln_coco_256.yml``: NCH 96, 256², D = 768,
   T = 200) in bf16 at a global batch of ``TP_BATCH`` = 64 (256 is the
   config's; two ranks with whole activations must fit), the JAX rule's
   2^16: one step (tens of seconds of gloo), timed, with its launches
   asserted and each collective's own time; each rank's step (its first,
   beside one process's first and next two), collectives, peak memory and
   parameter / moment bytes beside one process's at the same batch, the
   [64, 32] column block on the tensor cores; (c) where the machine has
   two cards or more, the same on two NCCL ranks, one card each.
7. Kernel times against their bounds (CUDA events over repeated launches),
   beside the plain version's and, for cross_attention, PyTorch's
   ``scaled_dot_product_attention`` on the same inputs; for the
   ``fused_affine`` backward (its vectors in x's dtype, as the step's) and
   cross_attention also ``kernel_ms``, the profiler's device time of the
   kernels alone (the events' time holds the host's between launches),
   traced after phase 3, as one
   ``{"kernels": [...]}`` line; the ``fused_affine`` backward also at the
   LN-COCO bf16 step's 14 inputs (each shape alone); the damsm kernels at
   the flagship and at the word shape of each LN step (``LN_STEP_SHAPES``:
   fp32 at batch 128, bf16 at 256; 2 timed launches there; their launches
   those of that step; the flagship rows also with a data-parallel rank
   step's launches, phase 6g, and the row blocks' errors, phase 3; the LN
   bf16 rows with a tensor-parallel rank step's, phase 6h(b), and the
   column block's errors, phase 3); the single form's backward at the 40 inputs of one
   concept step and its double backward at the 4 (``concept_rows``); the
   ``cross_attention`` backward at the 6 In and the 6 Out launches of one
   64² word-attention step, with SDPA's forward and backward as a
   yardstick, and an empty kernel's device time beside the Out rows (the
   launch floor).
8. Before the ``kernels`` line, the seconds of every phase (``[t]``; each
   phase also prints its own as it ends).  Last line: ``{"ok": true,
   "device": {...}}``.

Imports nothing of JAX or of the JAX package.  The weights are random (from
fixed seeds): no trained checkpoint is in the repository.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import math
import shutil
import statistics
import subprocess
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.models.concept_gan import attention_shapes, attention_step_launches
from xmc_gan_tpu_torch.models.df_concept_gan import disc_modulation_shapes, modulation_shapes
from xmc_gan_tpu_torch.models.df_gan import epilogue_shapes
from xmc_gan_tpu_torch.models.vgg import make_vgg
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.ops.cuda.build import load_all
from xmc_gan_tpu_torch import eval as fid_eval
from xmc_gan_tpu_torch.data import native
from xmc_gan_tpu_torch.losses import WORD_LOSS_BLOCK_ELEMS, word_scores_backend
from xmc_gan_tpu_torch.parallel import (
    gather_state,
    make_mesh,
    replicate,
    shard_batch,
    shard_state,
    shutdown,
)
from xmc_gan_tpu_torch.parallel.tensor import sharded_tensors
from xmc_gan_tpu_torch.parallel.collectives import all_reduce_mean_
from xmc_gan_tpu_torch.profiling import cuda_ms, device_kernels, read_trace
from xmc_gan_tpu_torch.train import (
    create_train_state,
    make_generator,
    make_sample_fn,
    make_train_step,
)
from xmc_gan_tpu_torch.trainer import Trainer, make_encode_fn
from xmc_gan_tpu_torch.utils.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parent
CFG = REPO / "xmc_gan_tpu" / "cfg" / "df_gan_damsm.yml"  # the YAML schema file only
CONCEPT_CFG = REPO / "xmc_gan_tpu" / "cfg" / "concept_in_df_gan.yml"
LN_CFG = REPO / "xmc_gan_tpu" / "cfg" / "ln_coco_256.yml"
# the concept GAN as the JAX package ships it: CONCEPT_OUT_DF_GEN + CONCEPT_NETD,
# SBERT sentences (768), 64², NCH 32, batch 88, MAGP, RMIS, SENT + DISC
CONCEPT_TRAIN_CFG = REPO / "xmc_gan_tpu" / "cfg" / "concept_out_df_gan.yml"
CONCEPT_GENS = ("CONCEPT_INATTN_GEN", "CONCEPT_OUTATTN_GEN", "CONCEPT_IN_DF_GEN",
                "CONCEPT_OUT_DF_GEN")
BATCH = 128  # serving and training batch (docs/SERVING.md; the flagship step)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
BF16_ULP = 2.0 ** -7
COUNTS = {"fused_affine.forward": fa.FORWARD, "fused_affine.backward": fa.BACKWARD,
          "fused_affine.double_backward": fa.DOUBLE_BACKWARD,
          "damsm_score.forward": ds.FORWARD, "damsm_score.d_regions": ds.D_REGIONS,
          "damsm_score.d_words": ds.D_WORDS, "cross_attention.forward": ca.FORWARD,
          "cross_attention.backward": ca.BACKWARD}
# the kernels each count's wrapper launches, by the profiler's names (re.search)
KERNEL_PATTERN = {"fused_affine.forward": r"fused_affine_(vec|scalar)<",
                  "fused_affine.backward": r"fused_affine_bwd_(vec|scalar)<",
                  "fused_affine.double_backward": r"fused_affine_bwd2_vec<",
                  "damsm_score.forward": r"damsm_fwd", "damsm_score.d_regions": r"damsm_bwd_dr",
                  "damsm_score.d_words": r"damsm_bwd_dw",
                  "cross_attention.forward": r"attn_(small|wide|grouped)<",
                  "cross_attention.backward": r"attn_bwd(_warp)?<"}
# launches of one flagship_word train step
STEP_LAUNCHES = {"fused_affine.forward": 28, "fused_affine.backward": 14,
                 "fused_affine.double_backward": 0,
                 "damsm_score.forward": 2, "damsm_score.d_regions": 2,
                 "damsm_score.d_words": 0, "cross_attention.forward": 0,
                 "cross_attention.backward": 0}
# launches of one serving request at 256², NCH=32 (every other count 0)
REQUEST_LAUNCHES = {"DF_GEN": {"fused_affine.forward": 14},
                    "CONCEPT_INATTN_GEN": {"cross_attention.forward": 10},
                    "CONCEPT_OUTATTN_GEN": {"cross_attention.forward": 10},
                    "CONCEPT_IN_DF_GEN": {"fused_affine.forward": 28},
                    "CONCEPT_OUT_DF_GEN": {"fused_affine.forward": 28}}
# fused_affine forward vs plain (rtol, atol).  fp32: the kernel contracts each
# g*y+b into one FMA, the plain version rounds the product first; with N(0, 1)
# inputs the chain's terms reach ~1e2, so one fp32 rounding of them is up to
# ~1e-5 absolute.  bf16: the same values rounded once on store, so one bf16
# ulp, plus that fp32 difference where the result is near zero.
KERNEL_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (BF16_ULP, 2e-5)}
# fused_affine backward: dx is the plain version's arithmetic in the same
# order (bit-equal but for FMA contraction of d1 * g1); the [B, C] sums run
# over up to 65,536 pixels in another order (per-thread runs, warps, blocks
# and atomics against PyTorch's tree), so they are held to 1e-4 of their
# largest magnitude, with a 1e-4 relative part.
BWD_TOL = {"dx_rtol": 1e-5, "dx_atol": 2e-5, "sum_rtol": 1e-4, "sum_scale": 1e-4}
# fused_affine double backward vs plain: g_x and g_dy are the plain
# version's products and sums in the same order, each rounded (no FMA), so
# bit-equal in fp32 up to the rounding of a bf16 store; held as dx is
# (BWD_TOL; bf16: one ulp).  g_gamma is a sum over H*W in another order:
# as the backward's sums.  Against autograd of the plain epilogue in fp64
# (``BWD2_FP64_SHAPE``): the kernel's fp32 rounding, 1e-5 of each result's
# largest magnitude.
BWD2_FP64_SHAPE = (4, 128, 8, 8)
BWD2_FP64_TOL = 1e-5
# phase 3 runs the plain fused_affine on this many elements at a time (a few
# images: an image's result and [C] sums do not depend on the others), so
# that it checks the LN-COCO step's own batch of 256 (its C = 96 input alone
# is 6.4 GB in fp32)
PLAIN_ELEMS = 2**27
# damsm kernels vs plain, the scores against the plain version summed in
# fp64 around the same rounding points (``exact_scores``).  fp32: the same
# math in another summation order: scores to 1e-5 (the all-padded
# caption's -2e29 by the relative part), the gradients to 1e-5 of their
# largest magnitude.  bf16: both round the products' operands to bf16,
# but the attention weights a and the cotangents come from sums in another
# order, so an operand can round to the neighbouring bf16 value: scores to
# 2^-12 absolute, gradients to one bf16 ulp (2^-7) of their largest
# magnitude.
DAMSM_TOL = {None: {"score": 1e-5, "grad_scale": 1e-5},
             torch.bfloat16: {"score": 2.0 ** -12, "grad_scale": BF16_ULP}}
# cross_attention vs plain.  fp32: the same math in another order (scores kept
# in log2 units, running sums rescaled once per word tile); with N(0, 1)
# operands at D = 256 the scores reach ~1e2 and one fp32 rounding of them
# moves a softmax weight by ~1e-5 relative: (rtol 1e-5, atol 1e-4).  bf16:
# both compute in fp32 and round once on store, so one bf16 ulp of the value
# where the two fp32 results straddle a rounding boundary.
ATTN_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (BF16_ULP, 1e-4)}
ATTN_SCALE = 0.7  # any scale; the generators use 1
# (B, G, N, T, D, strided, fully padded row): the Out shape, the JAX
# package's kernel shape, a D = 256 one, a ragged one; then attn_grouped's
# edges (``ca.plan``): N no multiple of a tile, T at the cap, G = 8 and 32,
# the keys as the In sampler lays them with GEN.NORMALIZE ("sampler": [B,
# G, D, T] in memory) and with them its queries as they come on the card
# ("planes": [B, G, D, N], as a CUDA GroupNorm leaves them), and the shapes
# next to it that attn_small takes (T = 33, G = 12, dense queries, planes
# off 16 bytes); the In shapes come from attention_shapes, as rows and as
# planes
ATTN_EXTRA = [(BATCH, 1, 16, 15, 4, False, False), (2, 1, 300, 260, 32, False, False),
              (4, 1, 1024, 200, 256, False, False), (3, 2, 77, 33, 48, True, True),
              (3, 16, 77, 15, 4, True, True), (3, 16, 80, 15, 4, "planes", True),
              (2, 16, 300, 32, 4, "sampler", True), (3, 8, 96, 20, 4, "planes", True),
              (2, 32, 130, 15, 4, True, True), (2, 16, 300, 33, 4, True, True),
              (2, 12, 50, 15, 4, True, True), (2, 16, 300, 15, 4, False, True),
              (2, 16, 77, 15, 4, "planes", True)]
# cross_attention backward vs plain (``ca.masked_cross_attention_bwd_ref``),
# each gradient to rtol and to atol times its largest magnitude.  fp32: the
# same math in another order (scores in log2 units through exp2, dk and dv
# summed over up to 4,096 queries in batch and warp order against PyTorch's
# einsum): (1e-4, 1e-5).  bf16: both compute in fp32 and round once on
# store, so one bf16 ulp where the two fp32 results straddle a rounding
# boundary.
ATTN_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (BF16_ULP, 1e-5)}
# (B, G, N, T, D, layout, fully padded row, upstream[, query norm]): the
# backward's shapes past the 64² step's own (``attention_shapes``, whose In
# launches go as rows and as planes).  upstream: how dO reaches the kernel,
# "mean" through the In sampler's mean over the queries (dense), "cat"
# through the Out block's concatenation (a strided slice).  Row 1 of every
# shape has one real word.  attn_bwd_warp's edges: T = 1 (every row one
# word or none), T = 20 and 32 (TMAX 32: its slots in steps of 4, more
# than 32 dS and P rows at T = 32), N = 1, N = 33 (a second warp with one
# query) and 77 (a ragged vector of four queries as planes), D = 3 (every
# operand a value at a time), the Out shape at N = 33, and queries 30 times
# as long at the In and Out shapes (scores up to ~30 in log2 units and more:
# the exact maximum matters)
ATTN_BWD_WARP_EDGES = [(3, 16, 77, 1, 4, "planes", True, "mean"),
                       (3, 16, 300, 20, 4, True, True, "mean"),
                       (2, 16, 130, 32, 4, "sampler", True, "mean"),
                       (4, 16, 1, 15, 4, "planes", True, "mean"),
                       (3, 16, 33, 15, 4, "planes", True, "mean"),
                       (3, 2, 50, 15, 3, False, True, "cat"),
                       (88, 1, 33, 15, 4, False, True, "cat"),
                       (4, 16, 1024, 15, 4, "planes", True, "mean", 30.0),
                       (88, 1, 16, 15, 4, False, True, "cat", 30.0)]
# then a ragged T (7) with N no multiple of a tile and the planes at N = 80
# (attn_bwd_warp's), and attn_bwd's own: T = 200 with the sampler's keys,
# D = 12 at T = 33, the widest plan (T = 256, D = 32: 209 KB of shared
# memory) and T = 200 at the Out shape
ATTN_BWD_EXTRA = [(3, 16, 77, 7, 4, True, True, "mean"), (3, 16, 80, 15, 4, "planes", True, "mean"),
                  (2, 16, 300, 200, 4, "sampler", True, "mean"),
                  (3, 1, 50, 33, 12, False, True, "cat"), (2, 1, 100, 256, 32, False, True, "cat"),
                  (2, 1, 16, 200, 4, False, True, "cat")]
# the word-attention generators (phases 4f, 6e) and the sampler each drives
ATTN_GENS = {"CONCEPT_INATTN_GEN": "in", "CONCEPT_OUTATTN_GEN": "out"}
# phase 6e: steps of Trainer.fit for each word-attention generator and dtype
ATTN_LOOP_STEPS = 4
# the kernel each word-attention request launches, as the profiler names it
REQUEST_ATTN_KERNEL = {"CONCEPT_INATTN_GEN": "attn_grouped<", "CONCEPT_OUTATTN_GEN": "attn_small<"}
# card vs CPU, fp32 with TF32 off: summation order of cuDNN vs CPU kernels
SLICE_TOL = {"words": 1e-4, "sent": 1e-4, "images": 2e-3}
# train slice, card vs CPU after two steps (fp32, TF32 off).  Metrics to 1e-4
# relative.  Parameters: Adam with beta1 = 0.5 moves each one by about +-lr a
# step whatever its gradient's size, so an element whose gradient is near 0
# (|g| ~ eps = 1e-8) can take the other sign on the two devices and land up
# to 2 lr per step away; all elements are held to that, and 99.9% of them to
# lr / 20.  The power-iteration vectors u/v to 1e-4.
TRAIN_TOL = {"metric": 1e-4, "param_share": 0.999, "param_lr_frac": 0.05, "uv": 1e-4}
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}
DTYPES_BY_NAME = {v: k for k, v in DTYPE_NAME.items()}
CD_NAME = {None: "fp32", torch.bfloat16: "bf16"}
TRAIN_OVERRIDES = {  # the flagship_word step: bf16 activations, fp32 params
    "TRAIN": {"NCH": 32, "NEF": 256, "NOISE_DIM": 100, "HE_INIT": True, "RMIS_LOSS": True,
              "MAGP": True, "N_CRITIC": 1, "BATCH_SIZE": BATCH,
              "ENCODER_LOSS": {"SENT": True, "DISC": True, "B_GLOBAL": True, "WORD": True},
              "SMOOTH": {"GLOBAL": 0.0}},
    "IMG": {"SIZE": 256},
    "TEXT": {"EMBEDDING_DIM": 256, "MAX_LENGTH": 20},
    "DISC": {"SPEC_NORM": True, "IMG_MATCH": True},
}
DAMSM_FLAGSHIP = (BATCH, BATCH, 256, 20, 256)  # B, Bc, R, T, D
DAMSM_RAGGED = (3, 5, 50, 7, 48)
# (B, Bc, R, T, D), an all-padded caption, longest caption (None: T): the
# bf16 tensor-core kernels' edges (16-row x 8-region x 16-feature tiles,
# passes of up to 64 packed word rows).  B = 132 images, no fewer than the
# H100's multiprocessors, gives one split (``ds.plan_fwd``, ``ds.plan_dr``),
# so each block's passes pack runs of several captions: D = 40 with an all-padded caption
# inside a pass; R = 50 with T = 20 (passes of word rows no multiple of 16,
# captions crossing a 16-row tile, Bc = 9); T = 33; T = 64 with captions of
# at most 2 words (whole 16-row tiles without a word; in fp32 the slots past
# the longest caption are cut, see DAMSM_F32_EDGES); B != Bc throughout.
# Last, R = 300, more regions than the tensor-core kernels take: the bf16
# forward and d_regions there run on the CUDA cores
DAMSM_EDGES = [((132, 7, 64, 7, 40), True, None), ((132, 9, 50, 20, 40), False, None),
               ((132, 2, 24, 33, 24), True, None), ((132, 3, 50, 64, 40), False, 2),
               ((4, 5, 300, 20, 48), True, None)]
# (B, Bc, R, T, D), an all-padded caption, longest caption (None: T), caption 0
# all real words: the fp32 edges.  D = 42, no multiple of 4 (the packed
# kernels' plain loads, not cp.async; the d_regions' scalar d_r stores); T = 64 with
# caption 0 whole, so every caption goes as two 48-slot sub-captions
# (the packed d_regions' rows) combined by logsumexp; T = 64 at R = 300 with
# captions of at most 2 words, unsplit: every fp32 kernel on the CUDA cores
# at 64 rows, whole 16-row tiles without a word; R = 300 at D = 768, where
# the packed kernels stop and the CUDA-core ones take 256-column chunks
DAMSM_F32_EDGES = [((132, 6, 40, 11, 42), True, None, False),
                   ((132, 5, 50, 64, 40), True, None, True),
                   ((132, 3, 300, 64, 40), False, 2, False),
                   ((4, 5, 300, 20, 768), True, None, False)]
REGIONS = 256  # DF_DISC's region head, always its 16x16 stage
# the LN-COCO word shape (ln_coco_256.yml: batch 256, MAX_LENGTH 200,
# EMBEDDING_DIM 768): B, Bc, R, T, D.  D > 256: the bf16 forward, d_regions
# and d_words run on the tensor cores with the regions streamed, the fp32
# forward and d_regions on the wide packed kernels (the context in
# 256-feature groups), the fp32 d_words on the CUDA cores
DAMSM_LN = (256, 256, REGIONS, 200, 768)
# the forward, d_regions and d_words at 256 < D <= 1024 by compute dtype, as
# the profiler names them: bf16 streamed on the tensor cores, fp32 wide
# packed (the d_words on the CUDA cores)
LN_KERNELS = {None: ("damsm_fwd_f32w_kernel<", "damsm_bwd_dr_f32w_kernel<",
                     "damsm_bwd_dw_kernel<"),
              torch.bfloat16: ("damsm_fwd_tcs_kernel<", "damsm_bwd_dr_tcs_kernel<",
                               "damsm_bwd_dw_tcs_kernel<")}
# the sub-captions' slots at the LN word shape by compute dtype
# (``ds.sub_caption_width``): bf16 the tensor-core kernels' 32 rows a pass,
# fp32 the CUDA-core d_words' 16
LN_WIDTH = {None: 16, torch.bfloat16: 32}
# the LN-COCO fp32 step's batch: ln_coco_256.yml's 256 needs ~130 GiB in
# fp32; 128 takes 72.42 GiB of an H100's 80 GB
LN_FP32_BATCH = 128
# the word shape of phase 6's LN-COCO step in each compute dtype, at which
# phase 7 times the kernels whose launches it reports
LN_STEP_SHAPES = {None: (LN_FP32_BATCH, LN_FP32_BATCH, REGIONS, 200, 768),
                  torch.bfloat16: DAMSM_LN}
# phase 3's LN checks (shape, compute dtype): the LN word shape in both
# dtypes, and the fp32 step's own
LN_CHECKS = [(DAMSM_LN, None), (DAMSM_LN, torch.bfloat16), (LN_STEP_SHAPES[None], None)]
# (B, Bc, R, T, D), an all-padded caption, longest caption (None: T): the
# edges at 256 < D <= 1024 of the streamed bf16 forward and d_regions
# (64-column region chunks, 16 or 32 word rows a pass) and of the wide fp32
# ones (32-column and 32-row chunks, 256-feature groups, 32 or 24 rows a
# pass), through ``damsm_scores``: D = 520 (a partial last chunk and group,
# no multiple of 16) with R = 50; D = 770 (rows not 16-byte aligned: plain
# loads instead of cp.async) with an all-padded caption inside a pass;
# D = 1024 (bf16 d_regions: 16-row passes; fp32: 24) with captions of at
# most 2 words
DAMSM_STREAMED = [((132, 9, 50, 20, 520), False, None), ((132, 7, 64, 7, 770), True, None),
                  ((132, 3, 256, 64, 1024), False, 2)]
# the plain version at the LN shape streams caption blocks of this many fp32
# elements of the [B, Bc, T, R] similarity (the whole one is 13 GB)
LN_PLAIN_BLOCK = 2**28


# the packed kernels' routes as a row of the ``kernels`` line names them, by
# the profiler name's end (``ds.kernel_name``); every other kernel: CUDA cores
ROUTE_LABELS = {"_tc_kernel<": "tensor cores (mma.sync)",
                "_tcs_kernel<": "tensor cores (mma.sync), regions streamed",
                "_f32_kernel<": "CUDA cores, packed real words, regions streamed",
                "_f32w_kernel<": "CUDA cores, packed real words, regions streamed, context in "
                                 "256-feature groups"}


def route_label(which: str, R: int, D: int, cd) -> str:
    """The route of one kernel (``which``: "fwd", "dr" or "dw") as a row of
    the ``kernels`` line names it, from the kernel ``ds.kernel_name`` names."""
    name = ds.kernel_name(which, R, D, cd)
    return next((label for end, label in ROUTE_LABELS.items() if name.endswith(end)),
                "CUDA cores")


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0


def read_counts() -> dict[str, int]:
    return {k: c.launches for k, c in COUNTS.items()}


def card_check() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| device 0: {torch.cuda.get_device_name(0)}")
    return card


def build_kernels() -> float:
    """One nvcc per library (``damsm_score.cu`` as three), all started together."""
    t0 = time.perf_counter()
    libs = (fa.KERNEL, *ds.LIBRARIES, ca.KERNEL)
    load_all(libs)
    dt = time.perf_counter() - t0
    log(f"[2] built {', '.join(' '.join((lib.source, *lib.flags)) for lib in libs)} in "
        f"{dt:.2f} s")
    return dt


def perturbed_state_dict(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Every parameter replaced by a seeded value that keeps activations
    O(1) with non-zero gates (a fresh model's zero gates would hide the
    residual branches): weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2),
    affine outputs gamma ~ 1 +- 0.1 and beta ~ 0 +- 0.1, gates ~ U(0.5,
    1.5), normalization scales (GroupNorm ``weight``, BatchNorm
    ``bn*_scale``) ~ 1 +- 0.1.  Spectral-norm vectors
    (``weight_u``/``weight_v``) are kept."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(("weight_u", "weight_v")):
            out[name] = t.clone()
            continue
        if name.endswith(".gamma"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("_scale") or (name.endswith("weight") and len(shape) == 1):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("weight"):
            std = 0.1 if ".linear2." in name else 1.0
            v = rng.standard_normal(shape) * std / math.sqrt(math.prod(shape[1:]))
        else:
            base = 1.0 if "fc_gamma.linear2" in name else 0.0
            v = base + 0.1 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def random_captions(rng, batch: int, T: int, vocab: int) -> dict:
    lens = rng.randint(1, T + 1, batch)
    lens[:3] = (1, T, T // 2)
    caps = np.zeros((batch, T), np.int64)
    for i, n in enumerate(lens):
        caps[i, :n] = rng.randint(1, vocab, n)
    return {"caps": caps, "cap_lens": lens}


def prefix_mask(rng, batch: int, T: int) -> np.ndarray:
    """Word mask (True = padded) of captions of 1 to T words, each its first
    slots."""
    lens = rng.randint(1, T + 1, batch)
    return np.arange(T)[None, :] >= lens[:, None]


def ln_mask(rng, batch: int, T: int) -> np.ndarray:
    """The LN word mask as ``benchmarks/ln_word_loss.py`` draws it: about
    half the slots real, the padding scattered; caption 1 all padded."""
    mask = rng.rand(batch, T) > 0.5
    mask[1] = True
    return mask


def train_batch(rng, cfg, batch: int, mask_fn) -> dict:
    """uint8 images, sentence/word embeddings and the word mask ``mask_fn``
    draws, as numpy arrays at ``cfg``'s image size and word shape."""
    size, emb, T = cfg.IMG.SIZE, cfg.TEXT.EMBEDDING_DIM, cfg.TEXT.MAX_LENGTH
    mask = mask_fn(rng, batch, T)
    return {
        "imgs": rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
        "sent_embs": rng.randn(batch, emb).astype(np.float32),
        "words_embs": rng.randn(batch, T, emb).astype(np.float32),
        "mask": mask,
    }


def ln_cfg(overrides: dict | None = None):
    """``ln_coco_256.yml`` read as YAML, with ``overrides``."""
    return cfg_from_dict(overrides or {}, base=cfg_from_file(str(LN_CFG)))


def kernel_category(name: str) -> str:
    n = name.lower()
    if "attn_small" in n or "attn_wide" in n or "attn_grouped" in n:
        return "cross_attention"
    if "attn_bwd" in n:
        return "cross_attention backward"
    if "damsm" in n or "sum_splits" in n:
        return "damsm_score"
    if "fused_affine_bwd2" in n:
        return "fused_affine double backward"
    if "fused_affine_bwd" in n:
        return "fused_affine backward"
    if "fused_affine" in n:
        return "fused_affine"
    if "upsample" in n:
        return "upsample"
    if any(k in n for k in ("xmma", "gemm", "conv", "cutlass", "cudnn", "dgrad", "fprop",
                            "wgrad", "winograd", "implicit", "fft", "complex", "sm90_")):
        return "conv/matmul (cuDNN, cuBLAS)"
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer (Adam)"
    if any(k in n for k in ("nchw", "nhwc", "transpose")):
        return "layout transforms"
    if "lstm" in n or "rnn" in n:
        return "text encoder RNN"
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reductions (sum, softmax, norm)"
    return "other (elementwise, casts, copies)"


def by_category(kernels: list[dict]) -> dict[str, float]:
    cats: dict[str, float] = {}
    for k in kernels:
        cat = kernel_category(k["name"])
        cats[cat] = cats.get(cat, 0.0) + k["ms"]
    return dict(sorted(cats.items(), key=lambda kv: -kv[1]))


def top_kernels(kernels: list[dict], n: int) -> list[dict]:
    """The ``n`` largest (kernel, launching op, input shapes) groups by
    summed device time, with their launch count and streams."""
    groups: dict[tuple, dict] = {}
    for k in kernels:
        key = (k["name"][:90], k["op"], str(k["dims"]))
        g = groups.setdefault(key, {"kernel": key[0], "op": k["op"], "dims": k["dims"],
                                    "ms": 0.0, "launches": 0, "streams": set()})
        g["ms"] += k["ms"]
        g["launches"] += 1
        g["streams"].add(k["stream"])
    top = sorted(groups.values(), key=lambda g: -g["ms"])[:n]
    return [{**g, "streams": sorted(map(str, g["streams"]))} for g in top]


def epilogue_inputs(shape, dtype, gen):
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    mods = [torch.randn(b, c, generator=gen, device="cuda") for _ in range(4)]
    return x, mods


def damsm_inputs(shape, gen, allpad: bool, max_len: int | None = None, full: bool = False):
    b, bc, R, T, D = shape
    r = torch.nn.functional.normalize(torch.randn(b, R, D, generator=gen, device="cuda"), dim=-1)
    w = torch.nn.functional.normalize(torch.randn(bc, T, D, generator=gen, device="cuda"), dim=-1)
    lens = torch.randint(1, (max_len or T) + 1, (bc,), generator=gen, device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    if allpad:
        mask[1] = True
    if full:
        mask[0] = False
    up = torch.randn(b, bc, generator=gen, device="cuda")
    return r, w, mask, up


def check_epilogue(shapes, ln_shapes, ln32_shapes) -> dict:
    """Phase 3, fused_affine: forward and backward, both forms, both dtypes,
    at every epilogue input of the flagship step and of the LN-COCO step
    (``ln_shapes``, at its own batch), and in fp32 with fp32 vectors at those
    of the fp32 LN-COCO step (``ln32_shapes``, at ``LN_FP32_BATCH``: another
    grid), the plain versions a few images at a time (``PLAIN_ELEMS``); the
    backward with fp32 and with bf16 vectors (G's bf16 step hands them over
    in bf16), its fp32 sums held to the plain version's before their one
    cast, and each launch the one that ``plan_bwd`` gives the step at that
    shape (the vector kernel at every path width, the scalar one at the
    ragged shape): phase 6 holds the step's launches to that plan by the
    profiler's names and grids."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ragged = (3, 13, 7, 9)  # C not a multiple of the vector width, H*W odd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = KERNEL_TOL[dtype]
        dx_rtol = BWD_TOL["dx_rtol"] if dtype == torch.float32 else BF16_ULP
        worst = {"fwd1": 0.0, "fwd2": 0.0, "bwd1": 0.0, "bwd2": 0.0}
        kernels = set()
        both = (torch.float32, torch.bfloat16)
        cases = [(s, both) for s in [*shapes, *ln_shapes, ragged]]
        if dtype == torch.float32:
            cases += [(s, (torch.float32,)) for s in ln32_shapes]
        for shape, vdts in cases:
            b, c, h, w = shape
            x, mods = epilogue_inputs(shape, dtype, gen)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
                memory_format=torch.channels_last)
            images = [slice(i, i + max(1, PLAIN_ELEMS // (c * h * w)))
                      for i in range(0, b, max(1, PLAIN_ELEMS // (c * h * w)))]
            for nmod, kern, ref in ((1, fa.modulate_lrelu_kernel, fa.modulate_lrelu_ref),
                                    (2, fa.double_modulate_lrelu_kernel,
                                     fa.double_modulate_lrelu_ref)):
                m = tuple(mods[: 2 * nmod])
                got = kern(x, *m)
                for i in images:
                    got_i = got[i].float()
                    want = ref(x[i], *(t[i] for t in m)).float()
                    torch.testing.assert_close(got_i, want, rtol=rtol, atol=atol)
                    worst[f"fwd{nmod}"] = max(worst[f"fwd{nmod}"],
                                              (got_i - want).abs().max().item())
                    del got_i, want
                del got
                for vdt in vdts:
                    mv = tuple(t.to(vdt) for t in m)
                    got_dx, got_sums = fa._launch_bwd_sums(x, mv, dy, 0.2)
                    p = fa.plan_bwd(b, h * w, c, dtype, vdt, (x.data_ptr(), dy.data_ptr(),
                                                              got_dx.data_ptr()), sms)
                    if p != fa.plan_bwd(b, h * w, c, dtype, vdt, (0, 0, 0), sms) or p.kernel != (
                            fa.BWD_SCALAR if shape == ragged else fa.BWD_VEC):
                        raise AssertionError(f"fused_affine backward at {shape}: planned {p}")
                    kernels.add(fa.bwd_kernel_name(p, dtype, vdt, nmod))
                    want_sums = []
                    for i in images:
                        want_b = fa.fused_affine_bwd_ref(x[i], tuple(t[i].float() for t in mv),
                                                         dy[i], 0.2)
                        got_i = got_dx[i].float()
                        torch.testing.assert_close(got_i, want_b[0].float(), rtol=dx_rtol,
                                                   atol=BWD_TOL["dx_atol"])
                        worst[f"bwd{nmod}"] = max(worst[f"bwd{nmod}"],
                                                  (got_i - want_b[0].float()).abs().max().item())
                        want_sums.append(torch.stack(want_b[1:]))
                        del want_b, got_i
                    want_sums = torch.cat(want_sums, 1)  # [2 * nmod, B, C], fp32
                    for g_, w_ in zip(got_sums.unbind(0), want_sums.unbind(0)):
                        torch.testing.assert_close(
                            g_, w_, rtol=BWD_TOL["sum_rtol"],
                            atol=BWD_TOL["sum_scale"] * w_.abs().max().item())
                    worst[f"bwd{nmod}"] = max(worst[f"bwd{nmod}"],
                                              (got_sums - want_sums).abs().max().item())
                    del got_dx, got_sums, want_sums
            del x, mods, dy
            torch.cuda.empty_cache()
        errs[dtype] = worst
        log(f"[3] fused_affine {DTYPE_NAME[dtype]}: max_abs_err forward 1-mod {worst['fwd1']:.3g}, "
            f"2-mod {worst['fwd2']:.3g}; backward (fp32 and bf16 vectors) 1-mod "
            f"{worst['bwd1']:.3g}, 2-mod {worst['bwd2']:.3g} over {len(shapes)} flagship shapes, "
            f"{len(ln_shapes)} LN-COCO ones (batch {ln_shapes[0][0]}"
            + (f"; fp32 with fp32 vectors also at batch {ln32_shapes[0][0]}"
               if dtype == torch.float32 else "") + f") + ragged {ragged} "
            f"(forward tolerance rtol {rtol:g} atol {atol:g}; backward: {BWD_TOL}); backward "
            f"kernels {sorted(kernels)}")
    return errs


def check_modulation(shapes) -> dict:
    """Phase 3, fused_affine single form through its wrapper at the distinct
    ``modulate_lrelu`` input shapes of a 256² NCH=32 concept-DF request at
    batch 128 (up to [128, 128, 256, 256], 2^30 elements), both dtypes."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = KERNEL_TOL[dtype]
        worst = 0.0
        for shape in shapes:
            x, mods = epilogue_inputs(shape, dtype, gen)
            got = fa.modulate_lrelu_kernel(x, mods[0], mods[1])
            want = fa.modulate_lrelu_ref(x, mods[0], mods[1])
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
            worst = max(worst, (got.float() - want.float()).abs().max().item())
            del x, mods, got, want
            torch.cuda.empty_cache()
        errs[dtype] = worst
        log(f"[3] fused_affine modulate_lrelu {DTYPE_NAME[dtype]}: max_abs_err {worst:.3g} at "
            f"the concept-DF shapes {shapes} (tolerance rtol {rtol:g} atol {atol:g})")
    return errs


def concept_train_cfg(overrides: dict | None = None):
    """``concept_out_df_gan.yml`` as published, with ``overrides``."""
    return cfg_from_dict(overrides or {}, base=cfg_from_file(str(CONCEPT_TRAIN_CFG)))


def concept_step_launches(cfg) -> dict[str, int]:
    """The kernel launches of one ``concept_out_df_gan.yml`` train step, from
    the arch tables: G runs twice (the fake for D, again for G's update), D's
    trunk five times (real and fake for D, MAGP's, G's fake, G's real for the
    DISC loss); the backward runs through D's two D-loss passes, MAGP's pass
    twice (its input gradient under ``create_graph``, then that gradient's
    own gradient, which also launches the double backward once a
    ``ConceptResD``) and G's fake with G itself."""
    g = len(modulation_shapes(cfg, 1))
    d = len(disc_modulation_shapes(cfg, 1))
    if not (cfg.TRAIN.MAGP and cfg.TRAIN.ENCODER_LOSS.DISC and cfg.TRAIN.N_CRITIC == 1):
        raise ValueError("the launch count assumes MAGP, the DISC loss and N_CRITIC 1")
    return {**{k: 0 for k in COUNTS}, "fused_affine.forward": 2 * g + 5 * d,
            "fused_affine.backward": 2 * d + 2 * d + d + g,
            "fused_affine.double_backward": d}


def attn_step_launches(cfg, name: str) -> dict[str, int]:
    """Every count of one train step of word-attention generator ``name``:
    12 / 6 ``cross_attention`` forward / backward at 64², 0 of the others."""
    return {**{k: 0 for k in COUNTS}, **attention_step_launches(cfg, ATTN_GENS[name])}


def concept_step_bwd_shapes(cfg, batch: int) -> list[tuple[int, int, int, int]]:
    """The single-form backward's inputs in one concept train step (see
    ``concept_step_launches``): D's four shapes five times, G's twenty."""
    return 5 * disc_modulation_shapes(cfg, batch) + modulation_shapes(cfg, batch)


def bwd2_inputs(shape, dtype, gen):
    """x, gamma, beta, dy and the gradients (gx, gg, gb) arriving at the
    backward's (dx, dgamma, dbeta), the vectors in x's dtype as D's grouped
    MLPs hand them over; about half of gamma*x + beta negative."""
    b, c = shape[:2]
    acts = [torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last) for _ in range(3)]
    vecs = [torch.randn(b, c, generator=gen, device="cuda").to(dtype) for _ in range(4)]
    vecs[0] = (1 + 0.5 * vecs[0].float()).to(dtype)
    x, dy, gx = acts
    g, beta, gg, gb = vecs
    return x, g, beta, dy, gx, gg, gb


def fp64_second(x, g, beta, dy, gx, gg, gb, slope: float = 0.2):
    """``(g_x, g_dy, g_gamma)`` as fp64 autograd of the plain epilogue gives
    them (no wrapper, no kernel): the gradient of sum(gx*dx) + sum(gg*dg) +
    sum(gb*db), where (dx, dg, db) = grad of sum(dy * lrelu(g*x + beta))."""
    x, g, beta, dy = (t.detach().double().requires_grad_() for t in (x, g, beta, dy))
    z = g[:, :, None, None] * x + beta[:, :, None, None]
    y = torch.where(z >= 0, z, slope * z)
    dx, dg, db = torch.autograd.grad(y, (x, g, beta), dy, create_graph=True)
    scalar = ((gx.double() * dx).sum() + (gg.double() * dg).sum()
              + (gb.double() * db).sum())
    return torch.autograd.grad(scalar, (x, dy, g))


def check_double_backward(cfg) -> dict:
    """Phase 3, the ``fused_affine`` single form's backward and double
    backward against their plain versions at the inputs of the published
    ``concept_out_df_gan.yml`` step (``cfg``, batch 88, 128 channels): the
    backward at every distinct shape of the step's 40 launches (D's 32² to
    4², G's 4² to 64²), the double backward at D's four, fp32 and bf16, the
    vectors in x's dtype, each launch on the kernel ``plan_bwd`` gives it
    (the vector kernels); then the double backward in fp32 at
    ``BWD2_FP64_SHAPE`` against fp64 autograd of the plain epilogue
    (``fp64_second``)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bs = cfg.TRAIN.BATCH_SIZE
    shapes = disc_modulation_shapes(cfg, bs)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol = BWD_TOL["dx_rtol"] if dtype == torch.float32 else BF16_ULP
        worst1 = 0.0
        for shape in sorted(set(concept_step_bwd_shapes(cfg, bs))):
            x, g, beta, dy = bwd2_inputs(shape, dtype, gen)[:4]
            got_dx, got_sums = fa._launch_bwd_sums(x, (g, beta), dy, 0.2)
            want = fa.fused_affine_bwd_ref(x, (g.float(), beta.float()), dy, 0.2)
            torch.testing.assert_close(got_dx.float(), want[0].float(), rtol=rtol,
                                       atol=BWD_TOL["dx_atol"])
            for g_, w_ in zip(got_sums.unbind(0), want[1:]):
                torch.testing.assert_close(g_, w_, rtol=BWD_TOL["sum_rtol"],
                                           atol=BWD_TOL["sum_scale"] * w_.abs().max().item())
                worst1 = max(worst1, (g_ - w_).abs().max().item())
            worst1 = max(worst1, (got_dx.float() - want[0].float()).abs().max().item())
            del x, g, beta, dy, got_dx, got_sums, want
        worst, kernels = 0.0, set()
        for shape in shapes:
            ins = bwd2_inputs(shape, dtype, gen)
            b, c, h, w = shape
            before = fa.DOUBLE_BACKWARD.launches
            got = fa._launch_bwd2(*ins, 0.2)
            torch.cuda.synchronize()
            if fa.DOUBLE_BACKWARD.launches != before + 1:
                raise AssertionError("fused_affine double backward: launch not counted")
            p = fa.plan_bwd(b, h * w, c, dtype, dtype, (0,) * 5, sms)
            if p.kernel != fa.BWD_VEC:
                raise AssertionError(f"fused_affine double backward at {shape}: planned {p}")
            kernels.add(fa.bwd2_kernel_name(p, dtype, dtype))
            want = fa.fused_affine_bwd2_ref(*ins, 0.2)
            for gt, wt in zip(got[:2], want[:2]):
                torch.testing.assert_close(gt.float(), wt.float(), rtol=rtol,
                                           atol=BWD_TOL["dx_atol"])
                worst = max(worst, (gt.float() - wt.float()).abs().max().item())
            scale = want[2].float().abs().max().item()
            torch.testing.assert_close(got[2].float(), want[2].float(),
                                       rtol=BWD_TOL["sum_rtol"] + (rtol if rtol > 1e-4 else 0),
                                       atol=BWD_TOL["sum_scale"] * scale)
            worst = max(worst, (got[2].float() - want[2].float()).abs().max().item())
            del ins, got, want
        torch.cuda.empty_cache()
        errs[dtype] = {"bwd1": worst1, "bwd2": worst}
        log(f"[3] fused_affine single-form backward {DTYPE_NAME[dtype]} at the concept step's "
            f"shapes: max_abs_err {worst1:.3g} (as the backward above); double backward: "
            f"max_abs_err {worst:.3g} at the concept D shapes {shapes} (g_x, g_dy: rtol "
            f"{rtol:g} atol {BWD_TOL['dx_atol']:g}; g_gamma: {BWD_TOL['sum_rtol']:g} relative, "
            f"{BWD_TOL['sum_scale']:g} of its largest magnitude); kernels {sorted(kernels)}")
    ins = bwd2_inputs(BWD2_FP64_SHAPE, torch.float32, gen)
    got = fa._launch_bwd2(*ins, 0.2)
    want = fp64_second(*ins)
    err64 = 0.0
    for gt, wt in zip(got, want):
        scale = wt.abs().max().item()
        err = (gt.double() - wt).abs().max().item()
        if not err <= BWD2_FP64_TOL * scale:
            raise AssertionError(f"fused_affine double backward vs fp64 autograd: {err} > "
                                 f"{BWD2_FP64_TOL} x {scale}")
        err64 = max(err64, err / scale)
    log(f"[3] fused_affine double backward fp32 at {BWD2_FP64_SHAPE} against fp64 autograd of "
        f"the plain epilogue: largest error {err64:.3g} of each result's largest magnitude "
        f"(tolerance {BWD2_FP64_TOL:g})")
    errs["fp64"] = err64
    return errs


def check_damsm_shape(shape, allpad, max_len, cd, gen, worst, full: bool = False) -> None:
    """One phase-3 damsm shape: forward, d_regions and d_words through
    ``damsm_scores`` (one launch each; captions longer than a kernel of the
    route holds as sub-captions) against the plain version and its autograd
    on the whole captions, each launch's kernel the one the route rule names
    (profiler trace); the largest errors go into ``worst``."""
    tol = DAMSM_TOL[cd]
    r, w, mask, up = damsm_inputs(shape, gen, allpad, max_len, full)
    ri, wi = r.clone().requires_grad_(), w.clone().requires_grad_()
    got = {}

    def run():
        got["forward"] = ds.damsm_scores(ri, wi, mask, 4.0, 5.0, cd)
        got["d_regions"], got["d_words"] = torch.autograd.grad(got["forward"], (ri, wi), up)

    names = damsm_kernel_names(run)
    for which in ("fwd", "dr", "dw"):
        kernel = ds.kernel_name(which, shape[2], shape[4], cd)
        if not any(kernel in n for n in names):
            raise AssertionError(f"damsm {shape} {CD_NAME[cd]}: no {kernel} among {names}")
    want = exact_scores(r, w, mask, cd)
    out = got["forward"].detach()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=tol["score"])
    if allpad and not bool(torch.isfinite(out).all()):
        raise AssertionError("all-padded caption gave a non-finite score")
    worst["forward"] = max(worst["forward"], (out - want).abs().max().item())
    for which, key in (("dr", "d_regions"), ("dw", "d_words")):
        want_g = ds._plain_vjp(which, r, w, mask, up, 4.0, 5.0, cd)
        torch.testing.assert_close(got[key], want_g, rtol=0,
                                   atol=tol["grad_scale"] * want_g.abs().max().item())
        worst[key] = max(worst[key], (got[key] - want_g).abs().max().item())


def check_damsm() -> dict:
    """Phase 3, damsm_score: forward, d_regions, d_words against the plain
    version and its autograd, at the flagship, a ragged and the edge
    shapes (``check_damsm_shape``), and the fp32 kernels' own edges; the
    bf16 and fp32 forward and d_regions also for determinism and the
    all-padded caption."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    shapes = [(DAMSM_FLAGSHIP, False, None), (DAMSM_RAGGED, True, None), *DAMSM_EDGES]
    for cd in (None, torch.bfloat16):
        worst = {"forward": 0.0, "d_regions": 0.0, "d_words": 0.0}
        for shape, allpad, max_len in shapes:
            check_damsm_shape(shape, allpad, max_len, cd, gen, worst)
            torch.cuda.empty_cache()
        errs[cd] = worst
        log(f"[3] damsm_score compute {CD_NAME[cd]}: max_abs_err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + f" at {DAMSM_FLAGSHIP}, ragged "
            f"{DAMSM_RAGGED} with an all-padded caption and the edges {DAMSM_EDGES}, each on "
            f"its route's kernels (tolerance {DAMSM_TOL[cd]})")
    f32_gen = torch.Generator(device="cuda").manual_seed(16)
    for shape, allpad, max_len, full in DAMSM_F32_EDGES:
        _, _, R, T, D = shape
        width = ds.sub_caption_width(R, T, D, None)
        if full and not width < T:
            raise AssertionError(f"fp32 damsm edge {shape}: caption 0 ({T} words) is not split "
                                 f"(sub-captions of {width} slots)")
        check_damsm_shape(shape, allpad, max_len, None, f32_gen, errs[None], full)
        torch.cuda.empty_cache()
        log(f"[3] damsm_score fp32 at {shape} (longest caption {T if full else max_len or T}, "
            f"sub-captions of {width} slots): fwd, d_regions, d_words on " + ", ".join(
                ds.kernel_name(which, R, D, None) for which in ("fwd", "dr", "dw")))
    log(f"[3] damsm_score fp32 at its own edges {DAMSM_F32_EDGES}: max_abs_err, all fp32 "
        f"shapes: " + ", ".join(f"{k} {v:.3g}" for k, v in errs[None].items()))
    # the bf16 d_regions (tensor cores): two launches bit-equal; the
    # all-padded caption's cotangent adds exactly nothing
    r, w, mask, up = damsm_inputs(DAMSM_FLAGSHIP, gen, True)
    up2 = up.clone()
    up2[:, 1] = 100.0
    runs = [ds._launch_bwd("dr", r, w, mask, u, 4.0, 5.0, torch.bfloat16) for u in (up, up, up2)]
    torch.cuda.synchronize()
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])):
        raise AssertionError("bf16 d_regions: launches differ, or the all-padded caption "
                             "moved the gradient")
    log("[3] damsm_score bf16 d_regions (tensor cores): two launches bit-equal; the "
        "all-padded caption's cotangent changes nothing")
    # the bf16 d_words (tensor cores): two launches bit-equal, the all-padded
    # caption's d_words and every padded slot's exactly 0, the trace's kernel
    dws = []
    kernel = ds.kernel_name("dw", DAMSM_FLAGSHIP[2], DAMSM_FLAGSHIP[4], torch.bfloat16)
    names = damsm_kernel_names(lambda: dws.append(
        ds._launch_bwd("dw", r, w, mask, up, 4.0, 5.0, torch.bfloat16)))
    torch.cuda.synchronize()
    if not any(kernel in n for n in names):
        raise AssertionError(f"bf16 d_words at {DAMSM_FLAGSHIP}: no {kernel} among {names}")
    if not (torch.equal(dws[0], dws[1]) and dws[0][1].abs().max().item() == 0.0
            and dws[0][mask].abs().max().item() == 0.0):
        raise AssertionError("bf16 d_words: launches differ, or the all-padded caption or a "
                             "padded slot got a d_words")
    log(f"[3] damsm_score bf16 d_words ({kernel}): two launches bit-equal; the all-padded "
        f"caption's d_words and every padded slot's exactly 0; the trace's kernels {names}")
    del dws
    # the fp32 d_regions (packed words): the same, the launches its kernel
    runs = []
    kernel = ds.kernel_name("dr", DAMSM_FLAGSHIP[2], DAMSM_FLAGSHIP[4], None)
    names = damsm_kernel_names(lambda: runs.extend(
        ds._launch_bwd("dr", r, w, mask, u, 4.0, 5.0, None) for u in (up, up, up2)))
    torch.cuda.synchronize()
    if not any(kernel in n for n in names):
        raise AssertionError(f"fp32 d_regions at {DAMSM_FLAGSHIP}: no {kernel} among {names}")
    if not all(torch.equal(runs[0], x) for x in runs[1:]):
        raise AssertionError("fp32 d_regions: launches differ, or the all-padded caption "
                             "moved the gradient")
    log(f"[3] damsm_score fp32 d_regions ({kernel}): {len(runs)} launches bit-equal, every "
        "third with the all-padded caption's cotangent at 100")
    # the bf16 forward (tensor cores): two launches bit-equal, every score
    # finite, the all-padded caption's (it takes no row) the plain value
    scores = [ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16) for _ in range(2)]
    want = ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, torch.bfloat16)
    torch.cuda.synchronize()
    if not (torch.equal(scores[0], scores[1]) and bool(torch.isfinite(scores[0]).all())
            and torch.equal(scores[0][:, 1], want[:, 1])):
        raise AssertionError("bf16 forward: launches differ, a score is not finite, or the "
                             "all-padded caption's score is not the plain value")
    log(f"[3] damsm_score bf16 forward (tensor cores): two launches bit-equal, all finite; the "
        f"all-padded caption scores {scores[0][0, 1].item():.6g}, as the plain version")
    # the fp32 forward (packed words): the same, the launches its kernel,
    # the scores within the tolerance of the fp64-summed plain version
    scores = []
    kernel = ds.kernel_name("fwd", DAMSM_FLAGSHIP[2], DAMSM_FLAGSHIP[4], None)
    names = damsm_kernel_names(lambda: scores.extend(
        ds._launch_fwd(r, w, mask, 4.0, 5.0, None) for _ in range(2)))
    want = ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, None)
    torch.cuda.synchronize()
    if not any(kernel in n for n in names):
        raise AssertionError(f"fp32 forward at {DAMSM_FLAGSHIP}: no {kernel} among {names}")
    if not (all(torch.equal(scores[0], x) for x in scores[1:])
            and bool(torch.isfinite(scores[0]).all())
            and torch.equal(scores[0][:, 1], want[:, 1])):
        raise AssertionError("fp32 forward: launches differ, a score is not finite, or the "
                             "all-padded caption's score is not the plain value")
    torch.testing.assert_close(scores[0], exact_scores(r, w, mask, None), rtol=1e-5,
                               atol=DAMSM_TOL[None]["score"])
    log(f"[3] damsm_score fp32 forward ({kernel}): {len(scores)} launches bit-equal, all finite, "
        f"within {DAMSM_TOL[None]['score']} of the fp64-summed plain version; the all-padded "
        f"caption scores {scores[0][0, 1].item():.6g}, as the plain version")
    del r, w, mask, up, up2, runs, scores, want
    torch.cuda.empty_cache()
    return errs


def ln_damsm_inputs(shape, gen):
    """An LN word shape on the card: normalized regions and words, about
    half the word slots real with the padding scattered, caption 1 all
    padded, caption 2 with 4 real words (one sub-caption of words, the
    rest of its sub-captions all padded)."""
    b, bc, R, T, D = shape
    r = torch.nn.functional.normalize(torch.randn(b, R, D, generator=gen, device="cuda"), dim=-1)
    w = torch.nn.functional.normalize(torch.randn(bc, T, D, generator=gen, device="cuda"), dim=-1)
    mask = torch.rand(bc, T, generator=gen, device="cuda") > 0.5
    mask[1] = True
    mask[2] = True
    mask[2, 1:5] = False
    up = torch.randn(b, bc, generator=gen, device="cuda")
    return r, w, mask, up


def exact_scores(r, w, mask, cd, block_elems: int | None = None) -> torch.Tensor:
    """The scores that the kernels' fp32 scores are held against: the plain
    version summed in fp64 around the same bf16 rounding points
    (``ds.damsm_scores_ref`` on fp64 operands), as fp32."""
    return ds.damsm_scores_ref(r.double(), w.double(), mask, 4.0, 5.0, cd, block_elems).float()


def damsm_kernel_names(fn) -> list[str]:
    """The damsm kernels that a call of ``fn`` launches, by name, from a
    whole trace of it (``device_kernels``); the first call, before the
    trace, loads and sets up every kernel it launches."""
    fn()
    torch.cuda.synchronize()
    return sorted({k["name"] for k in device_kernels(fn)[0] if "damsm" in k["name"]})


def check_damsm_ln() -> dict:
    """Phase 3, damsm_score at the LN word shapes (``LN_CHECKS``), through
    ``damsm_scores`` (the sub-caption split and combine) against the plain
    version on the whole captions: scores, d_regions and d_words; the
    all-padded caption's score bit-equal to the plain value and its d_words
    0; a second forward + d_regions bit-equal; the launches' kernel names
    each kernel's route (``LN_KERNELS``: the bf16 kernels on the tensor
    cores with the regions streamed, no bf16 CUDA-core forward; the fp32
    forward and d_regions on the wide packed kernels, the fp32 d_words on
    the CUDA cores) at the dtype's width (``LN_WIDTH``).  The errors by
    (shape, compute dtype)."""
    errs = {}
    for shape, cd in LN_CHECKS:
        gen = torch.Generator(device="cuda").manual_seed(12)
        r, w, mask, up = ln_damsm_inputs(shape, gen)
        b, bc, R, T, D = shape
        tol = DAMSM_TOL[cd]
        width = ds.sub_caption_width(R, T, D, cd)
        kernels = tuple(ds.kernel_name(which, R, D, cd) for which in ("fwd", "dr", "dw"))
        if kernels != LN_KERNELS[cd] or width != LN_WIDTH[cd]:
            raise AssertionError(f"LN {shape} {CD_NAME[cd]}: width {width}, kernels {kernels}; "
                                 f"want {LN_WIDTH[cd]} slots on {LN_KERNELS[cd]}")
        ri, wi = r.clone().requires_grad_(), w.clone().requires_grad_()
        got = {}

        def run():
            got["s"] = ds.damsm_scores(ri, wi, mask, 4.0, 5.0, cd)
            got["dr"], got["dw"] = torch.autograd.grad(got["s"], (ri, wi), up)

        names = damsm_kernel_names(run)
        for want in LN_KERNELS[cd]:
            if not any(want in n for n in names):
                raise AssertionError(f"LN {shape} {CD_NAME[cd]}: no {want} among {names}")
        if any("_tc_kernel" in n or "damsm_fwd_bf16_kernel" in n for n in names):
            raise AssertionError(f"LN {shape} {CD_NAME[cd]}: a resident-region or bf16 "
                                 f"CUDA-core kernel at D = {D}: {names}")
        want_s = exact_scores(r, w, mask, cd, LN_PLAIN_BLOCK)
        torch.testing.assert_close(got["s"].detach(), want_s, rtol=1e-5, atol=tol["score"])
        plain_pad = ds.damsm_scores_ref(r, w[1:2], mask[1:2], 4.0, 5.0, cd)
        if not (torch.equal(got["s"][:, 1:2].detach(), plain_pad)
                and got["dw"][1].abs().max().item() == 0.0):
            raise AssertionError(f"LN {shape} {CD_NAME[cd]}: the all-padded caption's score is "
                                 "not the plain value, or it got a d_words")
        worst = {"forward": (got["s"].detach() - want_s).abs().max().item()}
        for which, key in (("dr", "d_regions"), ("dw", "d_words")):
            want_g = ds._plain_vjp(which, r, w, mask, up, 4.0, 5.0, cd, LN_PLAIN_BLOCK)
            torch.testing.assert_close(got[which], want_g, rtol=0,
                                       atol=tol["grad_scale"] * want_g.abs().max().item())
            worst[key] = (got[which] - want_g).abs().max().item()
            del want_g
        ri2 = r.clone().requires_grad_()
        s2 = ds.damsm_scores(ri2, w, mask, 4.0, 5.0, cd)
        up2 = up.clone()
        up2[:, 1] = 100.0
        (dr2,) = torch.autograd.grad(s2, ri2, up2)
        torch.cuda.synchronize()
        if not (torch.equal(s2, got["s"]) and torch.equal(dr2, got["dr"])):
            raise AssertionError(f"LN {shape} {CD_NAME[cd]}: two runs of forward + d_regions "
                                 "differ, or the all-padded caption's cotangent moved d_regions")
        errs[shape, cd] = worst
        k = -(-int((~mask).sum(1).max()) // width)
        log(f"[3] damsm_score LN {shape} compute {CD_NAME[cd]} ({k} sub-captions of {width} "
            f"slots a caption, {int((~mask).sum())} real words): max_abs_err " + ", ".join(
                f"{k} {v:.3g}" for k, v in worst.items()) + f" (tolerance {tol}); all-padded "
            f"caption {got['s'][0, 1].item():.6g} = plain, no d_words; two runs bit-equal, the "
            f"second with the all-padded caption's cotangent at 100; kernels {names}")
        del r, w, mask, up, ri, wi, got, want_s, ri2, s2, dr2, up2
        torch.cuda.empty_cache()
    return errs


def check_damsm_streamed() -> dict:
    """Phase 3, the forward, d_regions and d_words at their edges above
    D = 256 (``DAMSM_STREAMED``) in both compute dtypes (bf16: the streamed
    tensor-core kernels; fp32: the wide packed ones and the CUDA-core
    d_words), through ``damsm_scores`` as the word loss calls it: scores,
    d_regions and d_words against the plain version on the whole captions
    (the scores summed in fp64) under ``DAMSM_TOL``; the launches are the
    route's kernels (``LN_KERNELS``), an all-padded caption scores
    the plain value bit for bit, and a second run's scores and d_regions,
    with the all-padded caption's cotangent at 100, are bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    errs = {}
    for cd in (None, torch.bfloat16):
        tol = DAMSM_TOL[cd]
        worst = {"forward": 0.0, "d_regions": 0.0, "d_words": 0.0}
        for shape, allpad, max_len in DAMSM_STREAMED:
            r, w, mask, up = damsm_inputs(shape, gen, allpad, max_len)
            ri, wi = r.clone().requires_grad_(), w.clone().requires_grad_()
            got = {}

            def run():
                got["s"] = ds.damsm_scores(ri, wi, mask, 4.0, 5.0, cd)
                got["dr"], got["dw"] = torch.autograd.grad(got["s"], (ri, wi), up)

            names = damsm_kernel_names(run)
            for kernel in LN_KERNELS[cd]:
                if not any(kernel in n for n in names):
                    raise AssertionError(f"{CD_NAME[cd]} edge {shape}: no {kernel} among {names}")
            want = exact_scores(r, w, mask, cd)
            torch.testing.assert_close(got["s"].detach(), want, rtol=1e-5, atol=tol["score"])
            plain_pad = ds.damsm_scores_ref(r, w[1:2], mask[1:2], 4.0, 5.0, cd)
            if allpad and not torch.equal(got["s"][:, 1:2].detach(), plain_pad):
                raise AssertionError(f"{CD_NAME[cd]} edge {shape}: the all-padded caption's "
                                     "score is not the plain value")
            worst["forward"] = max(worst["forward"],
                                   (got["s"].detach() - want).abs().max().item())
            for which, key in (("dr", "d_regions"), ("dw", "d_words")):
                want_g = ds._plain_vjp(which, r, w, mask, up, 4.0, 5.0, cd)
                torch.testing.assert_close(got[which], want_g, rtol=0,
                                           atol=tol["grad_scale"] * want_g.abs().max().item())
                worst[key] = max(worst[key], (got[which] - want_g).abs().max().item())
            ri2 = r.clone().requires_grad_()
            s2 = ds.damsm_scores(ri2, w, mask, 4.0, 5.0, cd)
            up2 = up.clone()
            up2[:, 1] = 100.0
            (dr2,) = torch.autograd.grad(s2, ri2, up2 if allpad else up)
            torch.cuda.synchronize()
            if not (torch.equal(s2, got["s"]) and torch.equal(dr2, got["dr"])):
                raise AssertionError(f"{CD_NAME[cd]} edge {shape}: two runs of forward + "
                                     "d_regions differ, or the all-padded caption moved d_regions")
            del r, w, mask, up, ri, wi, got, want, want_g, ri2, s2, dr2, up2
        torch.cuda.empty_cache()
        errs[cd] = worst
        log(f"[3] damsm_score {CD_NAME[cd]}, forward, d_regions and d_words on {LN_KERNELS[cd]} "
            f"at the "
            f"edges {DAMSM_STREAMED}: max_abs_err " + ", ".join(
                f"{k} {v:.3g}" for k, v in worst.items()) + f" (tolerance {tol}); all-padded "
            "caption = plain; two runs of forward + d_regions bit-equal, the all-padded "
            "caption's cotangent moving nothing")
    return errs


# (B_local, B_global, R, T, D): the word-score row blocks a data-parallel rank
# launches: the flagship step's at 2 x 128 rows (phase 6g's full width, B !=
# Bc) and phase 6g's parity step's (4 of 8)
DAMSM_ROW_BLOCKS = [(BATCH, 2 * BATCH, REGIONS, 20, 256), (4, 8, REGIONS, 20, 256)]


def check_damsm_row_blocks() -> dict:
    """Phase 3, damsm_score on data-parallel row blocks: the forward and
    d_regions (the words carry no gradient, as in the step) of the first and
    the last ``B_local`` images against all ``B_global`` captions, through
    ``damsm_scores``, against the plain version (``DAMSM_TOL``), each launch
    on the kernel the route names; and against the same rows of one launch
    on the whole ``[B_global, B_global]``, which logs whether they are
    bit-equal (and holds them to ``DAMSM_TOL`` either way)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    errs, same = {}, {}
    for cd in (None, torch.bfloat16):
        worst = {"forward": 0.0, "d_regions": 0.0}
        for b, bc, R, T, D in DAMSM_ROW_BLOCKS:
            r, w, mask, up = damsm_inputs((bc, bc, R, T, D), gen, False)
            full = ds._launch_fwd(r, w, mask, 4.0, 5.0, cd)
            full_dr = ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, cd)
            for rows in (slice(0, b), slice(bc - b, bc)):
                ri, got = r[rows].clone().requires_grad_(), {}

                def run():
                    got["forward"] = ds.damsm_scores(ri, w, mask, 4.0, 5.0, cd)
                    got["d_regions"], = torch.autograd.grad(got["forward"], ri, up[rows])

                names = damsm_kernel_names(run)
                for which in ("fwd", "dr"):
                    kernel = ds.kernel_name(which, R, D, cd)
                    if not any(kernel in n for n in names):
                        raise AssertionError(f"damsm row block [{b}, {bc}] {CD_NAME[cd]}: no "
                                             f"{kernel} among {names}")
                if any("damsm_bwd_dw" in n for n in names):
                    raise AssertionError(f"damsm row block [{b}, {bc}]: d_words launched")
                want = {"forward": exact_scores(r[rows], w, mask, cd),
                        "d_regions": ds._plain_vjp("dr", r[rows], w, mask, up[rows], 4.0, 5.0,
                                                   cd)}
                out = got["forward"].detach()
                torch.testing.assert_close(out, want["forward"], rtol=1e-5,
                                           atol=DAMSM_TOL[cd]["score"])
                scale = DAMSM_TOL[cd]["grad_scale"] * want["d_regions"].abs().max().item()
                torch.testing.assert_close(got["d_regions"], want["d_regions"], rtol=0,
                                           atol=scale)
                torch.testing.assert_close(out, full[rows], rtol=1e-5,
                                           atol=DAMSM_TOL[cd]["score"])
                torch.testing.assert_close(got["d_regions"], full_dr[rows], rtol=0, atol=scale)
                for key, ref in (("forward", full[rows]), ("d_regions", full_dr[rows])):
                    worst[key] = max(worst[key], (got[key] - want[key]).abs().max().item())
                    diff = (got[key] - ref).abs().max().item()
                    k = (cd, b, bc, key)
                    same[k] = max(same.get(k, 0.0), diff)
            del r, w, mask, up, full, full_dr
            torch.cuda.empty_cache()
        errs[cd] = worst
        log(f"[3] damsm_score row blocks {CD_NAME[cd]} (B_local, B_global, R, T, D) "
            f"{DAMSM_ROW_BLOCKS}: forward and d_regions on "
            + ", ".join(ds.kernel_name(which, REGIONS, 256, cd) for which in ("fwd", "dr"))
            + ", max_abs_err " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f" (tolerance {DAMSM_TOL[cd]})")
    for (cd, b, bc, key), diff in same.items():
        verdict = "bit-equal" if diff == 0.0 else f"max abs diff {diff:.3g} ({DAMSM_TOL[cd]})"
        log(f"[3] damsm_score {CD_NAME[cd]} {key}, row block [{b}, {bc}] against the same rows "
            f"of one [{bc}, {bc}] launch: {verdict}")
    return errs


# (B_local, B_global, cols, R, T, D, compute dtype): the word-score column
# blocks a tensor-parallel rank launches (its B_local images against its
# ``cols`` of the B_global captions): phase 6h(b)'s LN-COCO bf16 step at a
# global batch of 64 over tp = 2 ([64, 32] on the tensor cores) and phase
# 6h(a)'s fp32 parity step (4 images, 4 of 8 captions)
DAMSM_COL_BLOCKS = [(64, 64, 32, REGIONS, 200, 768, torch.bfloat16),
                    (4, 8, 4, REGIONS, 20, 256, None)]


def check_damsm_col_blocks() -> dict:
    """Phase 3, damsm_score on tensor-parallel column blocks: the forward
    and d_regions of ``B_local`` images against the last ``cols`` captions
    (model rank tp - 1's), through ``damsm_scores``, against the plain
    version (``DAMSM_TOL``) and against the same block of one launch on the
    whole ``[B_global, B_global]``; each launch on the kernel the route
    names (the bf16 LN block on the tensor cores).  Returns the worst
    errors by (B_local, cols, dtype)."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    errs = {}
    for b, bc, cols, R, T, D, cd in DAMSM_COL_BLOCKS:
        inputs = ln_damsm_inputs if T == 200 else functools.partial(damsm_inputs, allpad=False)
        r, w, mask, up = inputs((bc, bc, R, T, D), gen)
        full = ds.damsm_scores(r, w, mask, 4.0, 5.0, cd).detach()
        rows, cs = slice(0, b), slice(bc - cols, bc)
        ri, wc, mc, upc = r[rows].clone().requires_grad_(), w[cs], mask[cs], up[rows, cs]
        got = {}

        def run():
            got["forward"] = ds.damsm_scores(ri, wc, mc, 4.0, 5.0, cd)
            got["d_regions"], = torch.autograd.grad(got["forward"], ri, upc)

        names = damsm_kernel_names(run)
        for which in ("fwd", "dr"):
            kernel = ds.kernel_name(which, R, D, cd)
            if not any(kernel in n for n in names):
                raise AssertionError(f"damsm column block [{b}, {cols}] {CD_NAME[cd]}: no "
                                     f"{kernel} among {names}")
        if any("damsm_bwd_dw" in n for n in names):
            raise AssertionError(f"damsm column block [{b}, {cols}]: d_words launched")
        want = {"forward": exact_scores(r[rows], wc, mc, cd),
                "d_regions": ds._plain_vjp("dr", r[rows], wc, mc, upc.contiguous(), 4.0, 5.0,
                                           cd)}
        out = got["forward"].detach()
        torch.testing.assert_close(out, want["forward"], rtol=1e-5, atol=DAMSM_TOL[cd]["score"])
        torch.testing.assert_close(out, full[rows, cs], rtol=1e-5, atol=DAMSM_TOL[cd]["score"])
        scale = DAMSM_TOL[cd]["grad_scale"] * want["d_regions"].abs().max().item()
        torch.testing.assert_close(got["d_regions"], want["d_regions"], rtol=0, atol=scale)
        errs[b, cols, CD_NAME[cd]] = {k: (got[k] - want[k]).abs().max().item()
                                      for k in ("forward", "d_regions")}
        log(f"[3] damsm_score column block [{b}, {cols}] of [{bc}, {bc}] (R={R}, T={T}, D={D}) "
            f"{CD_NAME[cd]}: forward and d_regions on "
            + ", ".join(ds.kernel_name(which, R, D, cd) for which in ("fwd", "dr"))
            + f" ({route_label('fwd', R, D, cd)}), max_abs_err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs[b, cols, CD_NAME[cd]].items())
            + f" (tolerance {DAMSM_TOL[cd]}); the block of one whole launch within the same "
              f"tolerance, max abs diff {(out - full[rows, cs]).abs().max().item():.3g}")
        del r, w, mask, up, full, ri, got
        torch.cuda.empty_cache()
    return errs


def attention_inputs(shape, dtype, gen, allpad: bool):
    """q, k, v, mask at ``(B, G, N, T, D, strided)``.  Strided: the In
    sampler's layout, q and k = v lying as [B, N, G, D] and [B, T, G, D] in
    memory, viewed as [B, G, N, D]; l2-normalized like its operands.
    "sampler": k lies as the sampler's keys with GEN.NORMALIZE, [B, G, D, T];
    "planes": q too, [B, G, D, N], as a CUDA GroupNorm leaves the query map
    (the In sampler's operands on the card)."""
    b, g, n, t, d, strided = shape[:6]
    norm = torch.nn.functional.normalize
    if strided:
        q = norm(torch.randn(b, n, g, d, generator=gen, device="cuda"), dim=-1).to(dtype)
        k = norm(torch.randn(b, t, g, d, generator=gen, device="cuda"), dim=-1).to(dtype)
        q, k = q.transpose(1, 2), k.transpose(1, 2)
        if strided in ("sampler", "planes"):
            k = k.permute(0, 1, 3, 2).contiguous().transpose(2, 3)
        if strided == "planes":
            q = q.permute(0, 1, 3, 2).contiguous().transpose(2, 3)
        v = k
    else:
        q, k, v = (torch.randn(b, g, m, d, generator=gen, device="cuda").squeeze(1).to(dtype)
                   for m in (n, t, t))
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    mask = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
    if allpad:
        mask[0] = True
    return q, k, v, mask


def check_attention(in_shapes) -> dict:
    """Phase 3, cross_attention: the wrapper the concept models call vs the
    plain version at the distinct In shapes of a 256² request (batch 128)
    and ``ATTN_EXTRA``, fp32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes = [(*s, layout, False) for s in sorted(set(in_shapes)) for layout in (True, "planes")]
    shapes += ATTN_EXTRA
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = ATTN_TOL[dtype]
        worst = 0.0
        planned = []
        for shape in shapes:
            q, k, v, mask = attention_inputs(shape, dtype, gen, shape[6])
            planned.append(ca.kernel_name(ca.plan_for(q, k), dtype, shape[4]))
            got = ca.masked_cross_attention_kernel(q, k, v, mask, ATTN_SCALE)
            want = ca.masked_cross_attention_ref(q, k, v, mask, ATTN_SCALE)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
            if shape[6] and not (bool((got[0] == 0).all()) and bool((want[0] == 0).all())):
                raise AssertionError("cross_attention: a fully padded row did not give 0")
            worst = max(worst, (got.float() - want.float()).abs().max().item())
            del q, k, v, mask, got, want
            torch.cuda.empty_cache()
        errs[dtype] = worst
        log(f"[3] cross_attention {DTYPE_NAME[dtype]}: max_abs_err {worst:.3g} over "
            f"{len(shapes)} shapes (B, G, N, T, D, strided, padded row) and the kernels the "
            f"plan names: {list(zip(shapes, planned))} (tolerance rtol {rtol:g} atol {atol:g})")
    return errs


def upstream_loss(out: torch.Tensor, upstream: str, gen) -> torch.Tensor:
    """A scalar of the attention's output that hands its backward dO as a
    word-attention block does: "mean", the In sampler's mean over the
    queries; "cat", the Out block's concatenation with the global condition."""
    if upstream == "mean":
        x = out.mean(dim=2)
    else:
        x = torch.cat([torch.zeros(*out.shape[:-1], 8, device="cuda", dtype=out.dtype), out], -1)
    w = torch.randn(x.shape, generator=gen, device="cuda")
    return (x.float() * w).sum()


def check_attention_bwd(step_in, step_out) -> dict:
    """Phase 3, the cross_attention backward (``attn_bwd_warp``,
    ``attn_bwd``): at the distinct In shapes of the 64² train step (queries
    as rows and as planes), its Out shape, ``ATTN_BWD_WARP_EDGES`` and
    ``ATTN_BWD_EXTRA``, fp32 and bf16, keys passed as the values as both
    samplers do.  Through autograd (``masked_cross_attention_kernel`` under
    grad: one backward launch, dO as the upstream op hands it over), then the
    kernel alone on that dO twice (bit-equal) against the plain version;
    autograd's q and k gradients are the kernel's dq and dk + dv; a fully
    padded row gets zero gradients, a one-word row (row 1) exactly zero dq
    and dk; dq has q's strides; the profiler sees the kernel ``plan_bwd``
    names at every launch."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = [(*s, layout, False, "mean") for s in sorted(set(step_in)) for layout in (True, "planes")]
    shapes += [(*s, False, False, "cat") for s in sorted(set(step_out))]
    shapes += ATTN_BWD_WARP_EDGES + ATTN_BWD_EXTRA
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, frac = ATTN_BWD_TOL[dtype]
        worst = 0.0
        calls, planned, douts = [], [], []
        for shape in shapes:
            q, k, _, mask = attention_inputs(shape, dtype, gen, shape[6])
            if len(shape) > 8:
                q.mul_(shape[8])  # in place: q keeps its layout
            if mask.shape[0] > 1:  # row 1: one real word
                mask[1] = True
                mask[1, 0] = False
            qg, kg = q.detach().requires_grad_(), k.detach().requires_grad_()
            seen = {}
            before = ca.BACKWARD.launches
            out = ca.masked_cross_attention_kernel(qg, kg, kg, mask, ATTN_SCALE)
            out.register_hook(lambda g: seen.__setitem__("dout", g))
            upstream_loss(out, shape[7], gen).backward()
            if ca.BACKWARD.launches != before + 1:
                raise AssertionError(f"cross_attention backward {shape}: "
                                     f"{ca.BACKWARD.launches - before} launches, want 1")
            dout = seen["dout"]
            douts.append((shape[7], tuple(dout.stride()), dout.is_contiguous()))
            got = ca._launch_bwd(q, k, k, mask, dout, ATTN_SCALE)
            again = ca._launch_bwd(q, k, k, mask, dout, ATTN_SCALE)
            want = ca.masked_cross_attention_bwd_ref(q, k, k, mask, dout, ATTN_SCALE)
            torch.cuda.synchronize()
            for name, a, b_, w in zip(("dq", "dk", "dv"), got, again, want):
                if not torch.equal(a, b_):
                    raise AssertionError(f"cross_attention backward {shape} {name}: two runs "
                                         "differ")
                scale = w.float().abs().max().item()
                torch.testing.assert_close(a.float(), w.float(), rtol=rtol, atol=frac * scale,
                                           msg=lambda m: f"backward {shape} {name}: {m}")
                worst = max(worst, (a.float() - w.float()).abs().max().item())
                if shape[6] and not (bool((a[0] == 0).all()) and bool((w[0] == 0).all())):
                    raise AssertionError(f"cross_attention backward {shape} {name}: a fully "
                                         "padded row got a gradient")
                if name != "dv" and mask.shape[0] > 1 and not (
                        bool((a[1] == 0).all()) and bool((w[1] == 0).all())):
                    raise AssertionError(f"cross_attention backward {shape} {name}: a one-word "
                                         "row's gradient is not exactly 0")
            if not (torch.equal(qg.grad, got[0]) and torch.equal(kg.grad, got[1] + got[2])):
                raise AssertionError(f"cross_attention backward {shape}: autograd's gradients "
                                     "are not the kernel's")
            if got[0].stride() != q.stride():
                raise AssertionError(f"cross_attention backward {shape}: dq strides "
                                     f"{got[0].stride()}, q's {q.stride()}")
            q4 = q if q.dim() == 4 else q.unsqueeze(1)
            p = ca.plan_bwd(*q4.shape[:3], k.shape[-2], q.shape[-1], dtype)
            planned.append(ca.bwd_kernel_name(p, dtype))
            calls.append((q, k, mask, dout))
            del qg, kg, out, got, again, want
        seen_names = [k["name"] for k in device_kernels(
            lambda: [ca._launch_bwd(q, k, k, m, g, ATTN_SCALE) for q, k, m, g in calls],
            expect={KERNEL_PATTERN["cross_attention.backward"]: len(calls)})[0]
            if re.search(KERNEL_PATTERN["cross_attention.backward"], k["name"])]
        if sorted(next((w for w in set(planned) if w in n), n) for n in seen_names) != sorted(
                planned):
            raise AssertionError(f"cross_attention backward {DTYPE_NAME[dtype]}: kernels "
                                 f"{seen_names}, planned {planned}")
        errs[dtype] = worst
        log(f"[3] cross_attention backward {DTYPE_NAME[dtype]}: max_abs_err {worst:.3g} over "
            f"{len(shapes)} shapes (B, G, N, T, D, layout, padded row, upstream[, query norm]), "
            f"two runs bit-equal, one-word rows' dq and dk exactly 0, the kernels plan_bwd names "
            f"{sorted(set(planned))} by the profiler, each shape's "
            f"{list(zip(shapes, planned))}; dO "
            f"as autograd hands it over (upstream, strides, contiguous): {sorted(set(douts))} "
            f"(tolerance rtol {rtol:g}, atol {frac:g} of each gradient's largest magnitude)")
        del calls
        torch.cuda.empty_cache()
    return errs


def check_slice_against_cpu(cfg, g_cpu) -> None:
    """Phase 4a: encoder + NetG at 256², NCH=32, batch 4, fp32, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    batch = random_captions(rng, 4, cfg.TEXT.MAX_LENGTH, cfg.TEXT.VOCA_SIZE)
    noise = rng.randn(4, cfg.TRAIN.NOISE_DIM).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        words, sent, mask = make_encode_fn(cfg, device=dev)(batch)
        g = g_cpu if dev == "cpu" else copy.deepcopy(g_cpu).to(dev)
        img = make_sample_fn(cfg, g)(noise, sent, words, mask)
        outs[dev] = {"words": words, "sent": sent, "images": img}
    for key, tol in SLICE_TOL.items():
        a, b = outs["cuda"][key].cpu(), outs["cpu"][key]
        err = (a - b).abs().max().item()
        log(f"[4] slice card vs CPU {key} {tuple(a.shape)}: max_abs_err {err:.3g} "
            f"(tolerance {tol:g})")
        if not err <= tol:
            raise AssertionError(f"slice {key}: card and CPU differ by {err} > {tol}")
    img = outs["cuda"]["images"]
    sat = (img.abs() > 0.99).float().mean().item()
    log(f"[4] images std {img.std().item():.3f}, saturated share {sat:.3f}")
    if sat > 0.5:
        raise AssertionError("perturbed G saturates tanh: the comparison would have no teeth")


SLICE_CFG = {  # the train slice of phase 4b
    "TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": 16, "HE_INIT": True, "RMIS_LOSS": True,
              "MAGP": True, "ENCODER_LOSS": {"SENT": True, "DISC": True, "B_GLOBAL": True,
                                             "WORD": True},
              "SMOOTH": {"GLOBAL": 0.0}},
    "IMG": {"SIZE": 64}, "TEXT": {"EMBEDDING_DIM": 32, "MAX_LENGTH": 7},
    "DISC": {"SPEC_NORM": True, "IMG_MATCH": True}}


def param_agreement(want_sds, got_sds, lr: float) -> tuple[float, float, float, int]:
    """How far the state dicts ``got_sds`` lie from ``want_sds`` (pairs of G
    and D): the share of parameter elements within ``TRAIN_TOL``'s fraction
    of ``lr``, the worst parameter and power-iteration vector errors, and
    the element count."""
    n_all = n_close = 0
    worst_uv = worst = 0.0
    for want, got in zip(want_sds, got_sds):
        for name, v in want.items():
            err = (got[name].cpu() - v.cpu()).abs()
            if name.endswith(("weight_u", "weight_v")):
                worst_uv = max(worst_uv, err.max().item())
                continue
            worst = max(worst, err.max().item())
            n_all += err.numel()
            n_close += int((err <= TRAIN_TOL["param_lr_frac"] * lr).sum())
    return n_close / n_all, worst, worst_uv, n_all


def check_train_against_cpu(cfg, label: str, mask_fn, want: dict[str, int]) -> None:
    """Phase 4b, 4d-4g: two fp32 train steps at batch 4 on the card and on
    the CPU from the same perturbed weights (with ``ENCODER_LOSS.VGG``, the
    same random VGG-19), the word masks from ``mask_fn``; the card's run
    launches ``want`` of the kernels it names (4b, 4d, 4g: the word scores
    through the damsm kernels; 4e, 4f: every count of the step, the 0 of
    the others)."""
    cpu = create_train_state(cfg, device="cpu", seed=3)
    g_sd, d_sd = perturbed_state_dict(cpu.g, 4), perturbed_state_dict(cpu.d, 5)
    cpu = create_train_state(cfg, device="cpu", g_state_dict=g_sd, d_state_dict=d_sd)
    card = create_train_state(cfg, device="cuda", g_state_dict=g_sd, d_state_dict=d_sd)
    step_cpu = make_train_step(cfg)
    step_card = make_train_step(cfg, word_block_elems=0)  # turns TF32 off
    vgg_cpu = vgg_card = None
    if cfg.TRAIN.ENCODER_LOSS.VGG:
        vgg_cpu = make_vgg(path="")
        vgg_card = copy.deepcopy(vgg_cpu).cuda()
    rng = np.random.RandomState(6)
    reset_counts()
    for k in range(2):
        batch = train_batch(rng, cfg, 4, mask_fn)
        noise = rng.randn(4, cfg.TRAIN.NOISE_DIM).astype(np.float32)
        m_cpu = step_cpu(cpu, batch, noise, vgg_cpu)
        m_card = step_card(card, batch, noise, vgg_card)
        if set(m_cpu) != set(m_card) or (vgg_cpu is not None) != ("vgg_loss" in m_card):
            raise AssertionError(f"{label}: metrics {sorted(m_card)} vs CPU {sorted(m_cpu)}")
        for key, v in m_cpu.items():
            a, b = float(m_card[key]), float(v)
            if not abs(a - b) <= TRAIN_TOL["metric"] * max(1.0, abs(b)):
                raise AssertionError(f"{label} step {k} {key}: card {a} vs CPU {b}")
    counts = read_counts()
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{label} on the card: launches {counts}, want {want}")
    lr = max(cfg.TRAIN.OPT.G_LR, cfg.TRAIN.OPT.D_LR)
    share, worst, worst_uv, n_all = param_agreement(
        (cpu.g.state_dict(), cpu.d.state_dict()), (card.g.state_dict(), card.d.state_dict()), lr)
    log(f"[4] {label} card vs CPU, 2 steps: metrics within {TRAIN_TOL['metric']:g}; "
        f"params: {share:.6f} of {n_all} within {TRAIN_TOL['param_lr_frac'] * lr:.2g}, worst "
        f"{worst:.3g} (bound {4 * lr:.2g}); u/v worst {worst_uv:.3g}; launches {counts}")
    if share < TRAIN_TOL["param_share"] or worst > 4 * lr or worst_uv > TRAIN_TOL["uv"]:
        raise AssertionError(f"{label}: card and CPU parameters differ beyond the tolerance")


def concept_cfg(name: str, size: int = 256, nch: int = 32):
    """``concept_in_df_gan.yml`` (read as YAML only) at ``size``/``nch`` with
    generator ``name``; no DAMSM weights are in the repository."""
    return cfg_from_dict({"IMG": {"SIZE": size}, "TRAIN": {"NCH": nch},
                          "TEXT": {"ENCODER_DIR": ""}, "GEN": {"ENCODER_NAME": name}},
                         base=cfg_from_file(str(CONCEPT_CFG)))


def check_concepts_against_cpu() -> None:
    """Phase 4c: the four concept generators, NCH=8, 64², batch 4, T = 15,
    fp32 with TF32 off, card vs CPU on the same perturbed weights; the card's
    word attentions go through the kernel."""
    rng = np.random.RandomState(9)
    cfg = concept_cfg(CONCEPT_GENS[0], 64, 8)
    T, E = cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM
    noise = rng.randn(4, cfg.TRAIN.NOISE_DIM).astype(np.float32)
    sent = rng.randn(4, E).astype(np.float32)
    words = rng.randn(4, T, E).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.array([1, T, 7, 4])[:, None]
    for i, name in enumerate(CONCEPT_GENS):
        cfg = concept_cfg(name, 64, 8)
        g_cpu = make_generator(cfg, device="cpu", seed=i)
        g_cpu.load_state_dict(perturbed_state_dict(g_cpu, seed=20 + i), strict=True)
        want = make_sample_fn(cfg, g_cpu)(noise, sent, words, mask)
        reset_counts()
        got = make_sample_fn(cfg, copy.deepcopy(g_cpu).cuda())(noise, sent, words, mask).cpu()
        counts = {k: v for k, v in read_counts().items() if v}
        err = (got - want).abs().max().item()
        sat = (want.abs() > 0.99).float().mean().item()
        log(f"[4] {name} card vs CPU {tuple(got.shape)}: max_abs_err {err:.3g} (tolerance "
            f"{SLICE_TOL['images']:g}), std {want.std().item():.3f}, saturated share "
            f"{sat:.3f}, launches {counts}")
        if not err <= SLICE_TOL["images"]:
            raise AssertionError(f"{name}: card and CPU differ by {err}")
        if sat > 0.5:
            raise AssertionError(f"{name}: perturbed G saturates tanh")
        want_attn = 6 if "ATTN" in name else 0  # 2 per attention block, 3 blocks at 64²
        if counts.get("cross_attention.forward", 0) != want_attn:
            raise AssertionError(f"{name} on the card: launches {counts}")


def serve(cfg, sd, dtype, name: str = "DF_GEN") -> dict:
    """Phase 5 for one generator and dtype: encode + sample at batch 128,
    full width; asserts the request's launches (``REQUEST_LAUNCHES``)."""
    rng = np.random.RandomState(2)
    batch = random_captions(rng, BATCH, cfg.TEXT.MAX_LENGTH, cfg.TEXT.VOCA_SIZE)
    noise = torch.from_numpy(rng.randn(BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32))
    encode = make_encode_fn(cfg, device="cuda")
    g = make_generator(cfg, dtype, "cuda")
    g.load_state_dict(sd, strict=True)
    sample = make_sample_fn(cfg, g)  # turns TF32 off

    def request():
        words, sent, mask = encode(batch)
        return sample(noise, sent, words, mask)

    for _ in range(2):  # warm-up: cuDNN plans, allocator
        request()
    torch.cuda.synchronize()
    label = f"{name} {DTYPE_NAME[dtype]}"
    reset_counts()  # the serving path's run: counts from here
    img = request()
    torch.cuda.synchronize()
    launches = read_counts()
    want = {k: REQUEST_LAUNCHES[name].get(k, 0) for k in COUNTS}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if tuple(img.shape) != (BATCH, 256, 256, 3) or img.dtype != torch.float32:
        raise AssertionError(f"{label}: images {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(img).all()) or img.abs().max().item() > 1.0:
        raise AssertionError(f"{label}: images not finite or outside [-1, 1]")
    words, sent, mask = encode(batch)
    torch.cuda.reset_peak_memory_stats()
    times_g, times_req = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(noise, sent, words, mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        times_req.append(time.perf_counter() - t1)
        times_g.append(t1 - t0)
    g_s, req_s = statistics.median(times_g), statistics.median(times_req)
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernels, busy_ms, wall_ms = device_kernels(request, expect=launch_patterns(launches))
    device_ms = sum(k["ms"] for k in kernels)
    if name in REQUEST_ATTN_KERNEL:  # the profiled request's attention launches, by name
        attn = [k["name"] for k in kernels if kernel_category(k["name"]) == "cross_attention"]
        want_attn = REQUEST_ATTN_KERNEL[name]
        if len(attn) != REQUEST_LAUNCHES[name]["cross_attention.forward"] or not all(
                want_attn in a for a in attn):
            raise AssertionError(f"{label}: attention kernels {attn}, want {want_attn}")
    res = {"generator": name, "dtype": DTYPE_NAME[dtype],
           "launches": {k: v for k, v in launches.items() if v},
           "g_ms": g_s * 1e3, "request_ms": req_s * 1e3,
           "img_per_s_g": BATCH / g_s, "img_per_s_request": BATCH / req_s,
           "peak_mem_gib": peak, "request_kernel_ms": device_ms, "request_busy_ms": busy_ms,
           "profiled_request_ms": wall_ms, "device_busy_share": busy_ms / wall_ms,
           "device_ms_by_category": by_category(kernels), "img": img}
    log(f"[5] serve {label} bs{BATCH} 256²: launches {res['launches']}, G forward "
        f"{res['g_ms']:.2f} ms ({res['img_per_s_g']:.1f} img/s), encode+G "
        f"{res['request_ms']:.2f} ms ({res['img_per_s_request']:.1f} img/s), peak memory "
        f"{peak:.2f} GiB (median of 5)")
    log(f"[5] {label} one request on the device: {device_ms:.2f} ms of kernels, busy "
        f"{busy_ms:.2f} of {wall_ms:.2f} ms (share {res['device_busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in res["device_ms_by_category"].items()))
    return res


def train(cfg, config_name: str, dtype, warmup: int, timed: int, mask_fn, mesh=None) -> dict:
    """Phase 6 (and 6f, with ``ENCODER_LOSS.VGG`` and a random-init VGG-19;
    6g(a), the data-parallel step of ``mesh``, a group of one) for one
    full-width config and dtype: ``warmup`` steps, one counted step (peak
    memory from here), ``timed`` steps, one profiled."""
    bs = cfg.TRAIN.BATCH_SIZE
    state = create_train_state(cfg, dtype, "cuda", seed=0)
    step = make_train_step(cfg, mesh=mesh)  # turns TF32 off
    vgg = make_vgg(dtype, "cuda", path="") if cfg.TRAIN.ENCODER_LOSS.VGG else None
    if vgg is not None:
        step = functools.partial(step, vgg=vgg)
    rng = np.random.RandomState(7)
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(rng, cfg, bs, mask_fn).items()}
    noises = [torch.from_numpy(rng.randn(bs, cfg.TRAIN.NOISE_DIM).astype(np.float32)).cuda()
              for _ in range(warmup + timed + 2)]
    label = f"{DTYPE_NAME[dtype]} {config_name}"
    for i in range(warmup):
        step(state, batch, noises[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the training path's run: one step, counts from here
    fa.DY_COPIES.launches = 0
    metrics = step(state, batch, noises[warmup])
    torch.cuda.synchronize()
    launches = read_counts()
    dy_copies = fa.DY_COPIES.launches
    if launches != STEP_LAUNCHES:
        raise AssertionError(f"{label} train step: launches {launches}, want {STEP_LAUNCHES}")
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v.float()).all())]
    if bad:
        raise AssertionError(f"{label} train step: non-finite {bad}")
    times = []
    for i in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, noises[warmup + 1 + i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v.float()).all())]
    if bad:
        raise AssertionError(f"{label} train step: non-finite {bad} after the timed steps")
    kernels, busy_ms, wall_ms = device_kernels(lambda: step(state, batch, noises[-1]),
                                               expect=launch_patterns(launches))
    device_ms = sum(k["ms"] for k in kernels)
    damsm = {}
    for k in kernels:
        if kernel_category(k["name"]) == "damsm_score":
            n, ms = damsm.get(k["name"], (0, 0.0))
            damsm[k["name"]] = (n + 1, ms + k["ms"])
    for what, prefix, which in (("forward", "damsm_fwd", "fwd"),
                                ("d_regions", "damsm_bwd_dr", "dr")):
        want = ds.kernel_name(which, REGIONS, cfg.TEXT.EMBEDDING_DIM, dtype)
        got = {name: v for name, v in damsm.items() if prefix in name}
        if [v[0] for name, v in got.items() if want in name] != [2] or len(got) != 1:
            raise AssertionError(f"{label} train step: {what} kernels {got}, want 2 launches "
                                 f"of {want}")
    # G's epilogue backward: the kernel and grid plan_bwd gives each of its
    # 14 inputs (torch allocates them 16-byte aligned), with the vectors in
    # the activation dtype, as the step's Affine MLPs hand them over
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want_bwd: dict[str, int] = {}
    want_grids = []
    for b, c, h, w in epilogue_shapes(cfg, bs):
        p = fa.plan_bwd(b, h * w, c, dtype, dtype, (0, 0, 0), sms)
        name = fa.bwd_kernel_name(p, dtype, dtype, 2)
        want_bwd[name] = want_bwd.get(name, 0) + 1
        want_grids.append((name, list(p.grid), p.threads))
    got_bwd = [k for k in kernels if "fused_affine_bwd" in k["name"]]
    got_grids = [(next((n for n in want_bwd if n in k["name"]), k["name"]), k["grid"],
                  k["block"] and k["block"][0]) for k in got_bwd]
    if sorted(map(str, got_grids)) != sorted(map(str, want_grids)):
        raise AssertionError(f"{label} train step: fused_affine backward kernels (name, grid, "
                             f"threads) {got_grids}, want {want_grids}")
    res = {"dtype": DTYPE_NAME[dtype], "config": config_name, "batch": bs, "launches": launches,
           "step_kernel_launches": len(kernels), "fused_affine_bwd_kernels": want_bwd,
           "fused_affine_dy_copies": dy_copies, "step_ms": step_s * 1e3,
           "step_ms_all": [t * 1e3 for t in times], "img_per_s": bs / step_s,
           "peak_mem_gib": peak, "step_kernel_ms": device_ms, "step_busy_ms": busy_ms,
           "profiled_step_ms": wall_ms, "device_busy_share": busy_ms / wall_ms,
           "device_ms_by_category": by_category(kernels),
           "top_kernels": top_kernels(kernels, 10),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    log(f"[6] train {label} bs{bs} {cfg.IMG.SIZE}²: step {res['step_ms']:.1f} ms "
        f"({res['img_per_s']:.1f} img/s, median of {timed}), peak memory {peak:.2f} GiB, "
        f"launches {launches}; the profiled step launches {len(kernels)} kernels, the "
        f"fused_affine backward {want_bwd} by the profiler's names and grids, with "
        f"{dy_copies} copies of dy in the counted step")
    log(f"[6] train {label} one step on the device: {device_ms:.1f} ms of kernels, busy "
        f"{busy_ms:.1f} of {wall_ms:.1f} ms (share {res['device_busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in res["device_ms_by_category"].items()))
    for g in res["top_kernels"]:
        log(f"[6] train {label} top: {g['ms']:.1f} ms, {g['launches']} launches on streams "
            f"{','.join(g['streams'])}: {g['kernel']} <- {g['op']} {g['dims']}")
    for name, (n, ms) in sorted(damsm.items(), key=lambda kv: -kv[1][1]):
        log(f"[6] train {label} damsm: {ms:.3f} ms, {n} launches: {name[:110]}")
    log(f"[6] train {label} last metrics: " + ", ".join(
        f"{k} {v:.4g}" for k, v in res["metrics"].items()))
    if vgg is not None:
        # the VGG's own device time at the step's shapes: the real images'
        # features without grad, the fake's with their backward to the input
        fake = torch.rand((bs, 3, cfg.IMG.SIZE, cfg.IMG.SIZE), device="cuda").mul(2).sub(1)
        fake = fake.contiguous(memory_format=torch.channels_last).requires_grad_()
        imgs = batch["imgs"].permute(0, 3, 1, 2).to(dtype).div(127.5).sub(1)

        def vgg_pass():
            with torch.no_grad():
                vgg(imgs)
            vgg(fake).sum().backward()

        vgg_pass()
        vk = device_kernels(vgg_pass)[0]
        res["vgg_kernel_ms"] = sum(k["ms"] for k in vk)
        res["vgg_share"] = res["vgg_kernel_ms"] / device_ms
        log(f"[6f] train {label}: the VGG's forward (real, no grad) and forward + input "
            f"backward (fake) take {res['vgg_kernel_ms']:.1f} ms of kernels, "
            f"{100 * res['vgg_share']:.1f}% of the step's {device_ms:.1f} ms")
        del fake, imgs
    del state, batch, vgg
    torch.cuda.empty_cache()
    return res


# phase 6b: the flagship_word config through Trainer.fit.  512 synthetic
# examples are 4 steps an epoch at batch 128 and a test split of 128 (the
# trainer's synthetic_len // 4: one FID batch); LOG_INTERVAL 4 draws one
# in-epoch grid an epoch (the YAML's 200 would draw none).
LOOP_SYNTHETIC_LEN = 512
LOOP_STEPS_PER_EPOCH = LOOP_SYNTHETIC_LEN // BATCH
LOOP_SAVE_EVERY = 3
LOOP_PROFILE = (1, 3)  # the trainer traces steps 2 and 3
LOOP_TRACE_LOSS = 64  # launches at the trace's start that may lose their kernel
LOOP_CLI = ["--cfg", str(CFG), "--synthetic", "--synthetic_len", "176", "--imsize", "256",
            "--max_steps", "2", "--log_type", "none", "--save_after", "0", "--no_eval_fid"]


def start_cli_train(root: str) -> tuple[subprocess.Popen, float]:
    """``python -m xmc_gan_tpu_torch.cli train`` as a user runs it
    (``LOOP_CLI``: df_gan_damsm.yml, batch 88, 2 steps) with the reference
    CLI's ``--gpu`` and ``--debug_nans``, started as a process of its own
    (``main`` runs it beside phase 3's checks, which time nothing); its
    start time.  ``finish_cli_train`` checks it."""
    proc = subprocess.Popen([sys.executable, "-m", "xmc_gan_tpu_torch.cli", "train", *LOOP_CLI,
                             "--gpu", "0", "--debug_nans", "--output_root",
                             os.path.join(root, "cli")], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def finish_cli_train(proc: subprocess.Popen, t0: float, card: str) -> dict:
    """Waits for ``start_cli_train``'s process and checks its exit code, its
    two console lines and its checkpoint save."""
    out, err = proc.communicate(timeout=600)
    res = {"cli_train_debug_nans_s": time.perf_counter() - t0}
    lines = [ln for ln in out.splitlines() if "Loss_D:" in ln]
    if proc.returncode != 0 or len(lines) != 2 or "Save models" not in out:
        raise AssertionError(f"[5e] cli train --gpu 0 --debug_nans exit {proc.returncode}, "
                             f"console lines {lines}\n{out[-3000:]}\n{err[-3000:]}")
    res["cli_train_console"] = lines
    log(f"[5e] cli train --synthetic --max_steps 2 --gpu 0 --debug_nans (beside phase 3) "
        f"{res['cli_train_debug_nans_s']:.1f} s from its start; {lines[-1].strip()} | {card}")
    return res


def loop_cfg():
    over = copy.deepcopy(TRAIN_OVERRIDES)
    over["CONFIG_NAME"] = "flagship_word"
    over["TRAIN"]["LOG_INTERVAL"] = LOOP_STEPS_PER_EPOCH
    return cfg_from_dict(over)


def loop_launches(steps: int, sample_batches: int) -> dict[str, int]:
    """A fit's launches: each step's, and 14 fused_affine forwards for each
    batch through G outside the steps (sample grids and FID batches)."""
    return {k: steps * n + sample_batches * REQUEST_LAUNCHES["DF_GEN"].get(k, 0)
            for k, n in STEP_LAUNCHES.items()}


def timed_fit(tr, **kw) -> tuple[dict, list, list]:
    """``tr.fit(**kw)`` with the host time at which each step was handed to
    the step function (and the global step it makes) and each FID eval's ms
    with the part of it in ``fid_from_stats`` (the host's ``sqrtm``)."""
    calls, evals = [], []
    step_fn, evaluate, fid_from_stats = tr.step_fn, tr.evaluate, fid_eval.fid_from_stats
    sqrtm_ms = []

    def timed_fid_from_stats(*stats):
        t0 = time.perf_counter()
        value = fid_from_stats(*stats)
        sqrtm_ms.append((time.perf_counter() - t0) * 1e3)
        return value

    def step(state, batch, noise):
        calls.append((time.perf_counter(), state.step + 1))
        return step_fn(state, batch, noise)

    def timed_evaluate(epoch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = evaluate(epoch)
        evals.append(((time.perf_counter() - t0) * 1e3, sqrtm_ms.pop()))
        return value

    tr.step_fn, tr.evaluate = step, timed_evaluate
    fid_eval.fid_from_stats = timed_fid_from_stats
    try:
        metrics = tr.fit(**kw)
        torch.cuda.synchronize()
    finally:
        tr.step_fn, tr.evaluate = step_fn, evaluate
        fid_eval.fid_from_stats = fid_from_stats
    return metrics, calls, evals


def clean_step_walls(calls: list, profiled: tuple[int, int]) -> list[float]:
    """ms between consecutive step hand-overs inside an epoch, where the
    earlier step is not an auto-save step and neither lies in the traced
    window: the loop's own step wall (loader, encoder, copies, the previous
    step's metrics read, the step's launches) with the card in steady state."""
    out = []
    for (t0, g0), (t1, g1) in zip(calls, calls[1:]):
        same_epoch = (g0 - 1) // LOOP_STEPS_PER_EPOCH == (g1 - 1) // LOOP_STEPS_PER_EPOCH
        traced = any(profiled[0] <= g <= profiled[1] + 1 for g in (g0, g1))
        if g1 == g0 + 1 and same_epoch and g0 % LOOP_SAVE_EVERY and not traced:
            out.append((t1 - t0) * 1e3)
    return out


def check_counts(label: str, want: dict[str, int]) -> dict[str, int]:
    got = read_counts()
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return got


def train_loop(card: str, bare_step_ms: float) -> dict:
    """Phase 6b: full-width training through ``Trainer.fit`` on the card."""
    cfg = loop_cfg()
    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        return _train_loop(card, cfg, root, bare_step_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _train_loop(card: str, cfg, root: str, bare_step_ms: float) -> dict:
    kw = dict(seed=100, output_root=root, log_type="none", synthetic=True,
              synthetic_len=LOOP_SYNTHETIC_LEN, save_after=0, save_every_steps=LOOP_SAVE_EVERY,
              eval_num_samples=LOOP_SYNTHETIC_LEN // 4, dtype=torch.bfloat16, device="cuda")
    label = f"[6b] loop bf16 flagship_word bs{BATCH} 256² | {card}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace_dir = os.path.join(root, "trace")
    tr = Trainer(cfg, profile_dir=trace_dir, profile_steps=LOOP_PROFILE, **kw)
    if tr.decode_route != "synthetic":
        raise AssertionError(f"{label}: decode route {tr.decode_route}, want synthetic")
    steps = 2 * LOOP_STEPS_PER_EPOCH
    reset_counts()  # the loop's run: two epochs, FID after the second
    metrics, calls, evals = timed_fit(
        tr, max_epochs=2, eval_fn=lambda t, epoch: t.evaluate(epoch) if epoch == 2 else None)
    # per epoch the fixed grid and one in-epoch grid; one FID batch
    launches = check_counts(f"{label} fit, 2 epochs", loop_launches(steps, 2 * 2 + 1))
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad or tr.state.step != steps:
        raise AssertionError(f"{label}: non-finite {bad} or step {tr.state.step} != {steps}")
    out = Path(tr.output_dir)
    files = ["img/sents.txt", "img/imgs.png", "img/fake_samples_epoch_001.png",
             "img/fake_samples_epoch_002.png", "log/log.txt",
             f"img/fake_samples_{LOOP_STEPS_PER_EPOCH:03d}.png"]
    missing = [f for f in files if not (out / f).is_file()]
    if missing or tr.ckpt.all_epochs() != [1, 2] or tr.auto_ckpt.all_epochs() != [3, 6]:
        raise AssertionError(f"{label}: missing {missing}; checkpoints {tr.ckpt.all_epochs()}, "
                             f"auto {tr.auto_ckpt.all_epochs()}")
    # the traced window: steps 2 and 3, nothing else through G
    trace = read_trace(os.path.join(trace_dir, "trace.json"))
    traced_steps = LOOP_PROFILE[1] - LOOP_PROFILE[0]
    want = {KERNEL_PATTERN[k]: traced_steps * n for k, n in STEP_LAUNCHES.items()}
    got = {pat: sum(bool(re.search(pat, n)) for n in trace["names"]) for pat in want}
    # a trace on this machine can lose the kernels of its first launches
    # (profiling._OPENERS); the trainer's cannot be taken again, so those
    # are allowed, and only those, with the port's kernels all there
    if got != want or any(i >= LOOP_TRACE_LOSS for i in trace["lost"]):
        raise AssertionError(f"{label}: traced steps' kernels by name {got}, want {want}; "
                             f"launches without their kernel at {trace['lost']} of "
                             f"{trace['launches']}")
    busy = trace["busy_ms"] / trace["span_ms"]
    walls = clean_step_walls(calls, LOOP_PROFILE)
    step_busy_ms = trace["busy_ms"] / traced_steps
    del tr
    torch.cuda.empty_cache()

    # resume: a fresh trainer on the same run, from the newest auto-checkpoint;
    # its epochs end without an FID (run 1 times one, so the phase stays short)
    tr = Trainer(cfg, eval_fid=False, **kw)
    if tr.resume_latest_auto() != 6 or tr._resume_skip != 2 or tr.state_epoch != 1:
        raise AssertionError(f"{label}: resumed at step {tr.state.step}, skip "
                             f"{tr._resume_skip}, epoch {tr.state_epoch}; want 6, 2, 1")
    reset_counts()  # the resumed run: the rest of epoch 2 and epoch 3
    metrics2, calls2, _ = timed_fit(tr, max_epochs=3)
    resumed_steps = 3 * LOOP_STEPS_PER_EPOCH - 6
    # per epoch: the fixed grid and one in-epoch grid
    launches2 = check_counts(f"{label} resumed fit", loop_launches(resumed_steps, 2 * 2))
    bad = [k for k, v in metrics2.items() if not math.isfinite(v)]
    if bad or tr.state.step != 3 * LOOP_STEPS_PER_EPOCH or tr.ckpt.all_epochs() != [1, 2, 3]:
        raise AssertionError(f"{label}: resumed run non-finite {bad}, step {tr.state.step}, "
                             f"checkpoints {tr.ckpt.all_epochs()}")
    walls += clean_step_walls(calls2, (0, -2))
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the loader alone: one epoch of batches, threaded as in fit
    tr.train_loader.set_epoch(99)
    t0 = time.perf_counter()
    n = sum(1 for _ in tr.train_loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / n
    # one checkpoint's save and restore, on a manager of its own
    mgr = CheckpointManager(os.path.join(root, "timing"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, tr.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    ckpt_bytes = os.path.getsize(mgr.path(1))
    t0 = time.perf_counter()
    mgr.restore(tr.state, 1)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    del tr
    torch.cuda.empty_cache()

    res = {"card": card, "config": "flagship_word", "dtype": "bf16", "batch": BATCH,
           "launches_fit": launches, "launches_resumed": launches2,
           "loop_step_ms": statistics.median(walls), "loop_step_ms_all": walls,
           "bare_step_ms": bare_step_ms, "loader_ms_per_batch": loader_ms,
           "decode_route": "synthetic", "native_decoder_available": native.available(),
           "device_busy_ms": trace["busy_ms"], "trace_span_ms": trace["span_ms"],
           "device_busy_share": busy, "step_busy_ms": step_busy_ms,
           "trace_launches": trace["launches"], "trace_lost": trace["lost"],
           "step_busy_share_unprofiled": step_busy_ms / statistics.median(walls),
           "ckpt_save_ms": save_ms, "ckpt_restore_ms": restore_ms,
           "ckpt_bytes": ckpt_bytes, "fid_eval_ms": [e for e, _ in evals],
           "fid_sqrtm_ms": [q for _, q in evals], "peak_mem_gib": peak,
           "metrics": metrics, "metrics_resumed": metrics2}
    log(f"{label}: 2 epochs of {LOOP_STEPS_PER_EPOCH} steps, launches {launches}; resumed at "
        f"step 6 (2 batches of epoch 2 skipped), {resumed_steps} steps, launches {launches2}; "
        f"files {files}, checkpoints [1, 2] and auto [3, 6] written")
    log(f"{label}: loop step {res['loop_step_ms']:.1f} ms (median of {len(walls)} steps "
        f"{', '.join(f'{w:.1f}' for w in walls)}) beside the bare step's {bare_step_ms:.1f} ms "
        f"(phase 6); loader {loader_ms:.1f} ms a batch (decode route synthetic; native "
        f"decoder available: {native.available()})")
    log(f"{label}: traced steps 2-3 of fit: device busy {trace['busy_ms']:.1f} of "
        f"{trace['span_ms']:.1f} ms (share {busy:.3f}, the profiler's host cost included), "
        f"the kernels by name {got}; {step_busy_ms:.1f} ms busy a step against the unprofiled "
        f"loop step: share {res['step_busy_share_unprofiled']:.3f}; of {trace['launches']} "
        f"launches, those at {trace['lost']} have no kernel in the trace")
    log(f"{label}: checkpoint save {save_ms:.1f} ms, restore {restore_ms:.1f} ms, "
        f"{ckpt_bytes} bytes; FID eval (random-init Inception, {LOOP_SYNTHETIC_LEN // 4} test "
        f"samples, building the extractor) {evals[0][0]:.1f} ms ({evals[0][1]:.1f} of it "
        f"fid_from_stats); peak memory {peak:.2f} GiB")
    return res


# phase 6c: concept_out_df_gan.yml through Trainer.fit, one epoch of this
# many steps at its batch of 88, a checkpoint after it
CONCEPT_LOOP_STEPS = 4
# phase 6d: ln_coco_256.yml through Trainer.fit in bf16, this many steps
LN_LOOP_STEPS = 3
# phase 5c: rows of the synthetic sbert_cache_test.npz (T = 200, D = 768, fp16)
SENT_CACHE_ROWS = 512


def step_walls(calls: list) -> list[float]:
    """ms between consecutive step hand-overs of one epoch after the first
    step (the first holds the card's first-run costs): the loop's step wall."""
    return [(t1 - t0) * 1e3 for (t0, _), (t1, _) in zip(calls[1:], calls[2:])]


def concept_loop(card: str, dtype) -> dict:
    """Phase 6c for one dtype: ``concept_out_df_gan.yml`` as published
    through ``Trainer.fit`` on the card."""
    root = tempfile.mkdtemp(prefix="chip_smoke_concept_")
    try:
        return _concept_loop(card, dtype, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _concept_loop(card: str, dtype, root: str) -> dict:
    cfg = concept_train_cfg()
    bs = cfg.TRAIN.BATCH_SIZE
    label = (f"[6c] concept loop {DTYPE_NAME[dtype]} {cfg.CONFIG_NAME} bs{bs} "
             f"{cfg.IMG.SIZE}² | {card}")
    per_step = concept_step_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, seed=100, output_root=root, log_type="none", synthetic=True,
                 synthetic_len=CONCEPT_LOOP_STEPS * bs, save_after=0, eval_fid=False,
                 dtype=dtype, device="cuda")
    reset_counts()  # the concept training path's run: one epoch and its grid
    metrics, calls, _ = timed_fit(tr, max_epochs=1)
    grid = len(modulation_shapes(cfg, 1))  # the epoch's fixed-noise grid: one G forward
    want = {k: CONCEPT_LOOP_STEPS * n + (grid if k == "fused_affine.forward" else 0)
            for k, n in per_step.items()}
    launches = check_counts(f"{label} fit, 1 epoch of {CONCEPT_LOOP_STEPS} steps", want)
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    out = Path(tr.output_dir)
    if bad or tr.state.step != CONCEPT_LOOP_STEPS or tr.ckpt.all_epochs() != [1] or not (
            out / "img" / "fake_samples_epoch_001.png").is_file():
        raise AssertionError(f"{label}: non-finite {bad}, step {tr.state.step}, checkpoints "
                             f"{tr.ckpt.all_epochs()}")
    walls = step_walls(calls)
    # the bare step on one of the loader's batches: counted, timed, profiled
    batch = tr._prep_batch(tr.train_loader.first_batch())
    noise = tr.step_noise(tr.global_step + 1)
    reset_counts()
    tr.step_fn(tr.state, batch, noise)
    torch.cuda.synchronize()
    step_launches = check_counts(f"{label} one step", per_step)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step_fn(tr.state, batch, noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    kernels, busy_ms, wall_ms = device_kernels(lambda: tr.step_fn(tr.state, batch, noise),
                                               expect=launch_patterns(step_launches))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want_bwd2 = sorted(fa.bwd2_kernel_name(fa.plan_bwd(b, h * w, c, dtype, dtype, (0,) * 5, sms),
                                           dtype, dtype)
                       for b, c, h, w in disc_modulation_shapes(cfg, bs))
    got_bwd2 = sorted(next((n for n in want_bwd2 if n in k["name"]), k["name"])
                      for k in kernels if "fused_affine_bwd2" in k["name"])
    if got_bwd2 != want_bwd2:
        raise AssertionError(f"{label}: double-backward kernels {got_bwd2}, want {want_bwd2}")
    mgr = CheckpointManager(os.path.join(root, "timing"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, tr.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    res = {"card": card, "config": "concept_out_df_gan", "dtype": DTYPE_NAME[dtype], "batch": bs,
           "launches_fit": launches, "launches_step": step_launches,
           "loop_step_ms": statistics.median(walls), "loop_step_ms_all": walls,
           "step_ms": statistics.median(times), "step_ms_all": times,
           "img_per_s": bs / statistics.median(times) * 1e3,
           "step_kernel_ms": sum(k["ms"] for k in kernels), "step_busy_ms": busy_ms,
           "profiled_step_ms": wall_ms, "device_busy_share": busy_ms / wall_ms,
           "device_ms_by_category": by_category(kernels), "top_kernels": top_kernels(kernels, 8),
           "double_backward_kernels": got_bwd2, "ckpt_save_ms": save_ms,
           "ckpt_bytes": os.path.getsize(mgr.path(1)),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "metrics": metrics}
    log(f"{label}: launches of the fit {launches}, of one step {step_launches}; loop step "
        f"{res['loop_step_ms']:.1f} ms (median of {', '.join(f'{w:.1f}' for w in walls)}), bare "
        f"step {res['step_ms']:.1f} ms ({res['img_per_s']:.1f} img/s, median of 3), peak "
        f"{res['peak_mem_gib']:.2f} GiB, checkpoint save {save_ms:.1f} ms "
        f"({res['ckpt_bytes']} bytes); double-backward kernels by name {got_bwd2}")
    log(f"{label} one step on the device: {res['step_kernel_ms']:.1f} ms of kernels, busy "
        f"{busy_ms:.1f} of {wall_ms:.1f} ms (share {res['device_busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in res["device_ms_by_category"].items()))
    for g in res["top_kernels"]:
        log(f"{label} top: {g['ms']:.1f} ms, {g['launches']} launches: {g['kernel']} <- "
            f"{g['op']} {g['dims']}")
    log(f"{label} last metrics: " + ", ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
    del tr, batch
    return res


def ln_loop(card: str, bare_step_ms: float) -> dict:
    """Phase 6d: ``ln_coco_256.yml`` as it stands (NCH 96, batch 256, bf16)
    through ``Trainer.fit`` on the SBERT synthetic table, ``LN_LOOP_STEPS``
    steps, no FID and no checkpoint (phase 6b covers those).  The YAML sets
    no ``LOG_INTERVAL`` (default 1: a grid after every step); here one
    in-epoch grid, after the last step, as phase 6b draws one an epoch."""
    root = tempfile.mkdtemp(prefix="chip_smoke_ln_")
    try:
        cfg = ln_cfg({"TRAIN": {"LOG_INTERVAL": LN_LOOP_STEPS}})
        bs = cfg.TRAIN.BATCH_SIZE
        label = f"[6d] LN-COCO loop bf16 bs{bs} 256² | {card}"
        tr = Trainer(cfg, seed=100, output_root=root, log_type="none", synthetic=True,
                     synthetic_len=LN_LOOP_STEPS * bs, save_after=10**9, eval_fid=False,
                     dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # the LN training path's run: the epoch and its grid
        metrics, calls, _ = timed_fit(tr, max_epochs=1)
        # the steps, the in-epoch grid and the epoch's fixed-noise grid
        want = {k: LN_LOOP_STEPS * n + 2 * REQUEST_LAUNCHES["DF_GEN"].get(k, 0)
                for k, n in STEP_LAUNCHES.items()}
        launches = check_counts(label, want)
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad or tr.state.step != LN_LOOP_STEPS:
            raise AssertionError(f"{label}: non-finite {bad} or step {tr.state.step}")
        walls = step_walls(calls)
        res = {"card": card, "config": "ln_coco_256", "dtype": "bf16", "batch": bs,
               "launches_fit": launches, "loop_step_ms": statistics.median(walls),
               "loop_step_ms_all": walls, "bare_step_ms": bare_step_ms,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "metrics": metrics}
        log(f"{label}: {LN_LOOP_STEPS} steps, launches {launches} (a step: damsm 2 + 2, "
            f"fused_affine 28 / 14; the two grids 14 forwards each); loop step "
            f"{res['loop_step_ms']:.1f} ms ({', '.join(f'{w:.1f}' for w in walls)}) beside the "
            f"bare LN step's {bare_step_ms:.1f} ms (phase 6); peak {res['peak_mem_gib']:.2f} GiB")
        del tr
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def attn_loop(card: str, name: str, dtype) -> dict:
    """Phase 6e for one word-attention generator and dtype:
    ``concept_in_df_gan.yml`` as published with ``GEN.ENCODER_NAME`` =
    ``name``, through ``Trainer.fit`` on the card."""
    root = tempfile.mkdtemp(prefix="chip_smoke_attn_")
    try:
        return _attn_loop(card, name, dtype, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _attn_loop(card: str, name: str, dtype, root: str) -> dict:
    cfg = concept_cfg(name, 64, 32)
    bs = cfg.TRAIN.BATCH_SIZE
    label = f"[6e] {name} loop {DTYPE_NAME[dtype]} bs{bs} {cfg.IMG.SIZE}² | {card}"
    per_step = attn_step_launches(cfg, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, seed=100, output_root=root, log_type="none", synthetic=True,
                 synthetic_len=ATTN_LOOP_STEPS * bs, save_after=10**9, eval_fid=False,
                 dtype=dtype, device="cuda")
    reset_counts()  # the word-attention training path's run: one epoch and its grid
    metrics, calls, _ = timed_fit(tr, max_epochs=1)
    grid = len(attention_shapes(cfg, 1, ATTN_GENS[name]))  # the epoch's grid: one G forward
    want = {k: ATTN_LOOP_STEPS * n + (grid if k == "cross_attention.forward" else 0)
            for k, n in per_step.items()}
    launches = check_counts(f"{label} fit, 1 epoch of {ATTN_LOOP_STEPS} steps", want)
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad or tr.state.step != ATTN_LOOP_STEPS:
        raise AssertionError(f"{label}: non-finite {bad}, step {tr.state.step}")
    walls = step_walls(calls)
    batch = tr._prep_batch(tr.train_loader.first_batch())
    noise = tr.step_noise(tr.global_step + 1)
    reset_counts()
    tr.step_fn(tr.state, batch, noise)
    torch.cuda.synchronize()
    step_launches = check_counts(f"{label} one step", per_step)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step_fn(tr.state, batch, noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    kernels, busy_ms, wall_ms = device_kernels(lambda: tr.step_fn(tr.state, batch, noise),
                                               expect=launch_patterns(step_launches))
    fwd = sorted({k["name"] for k in kernels if kernel_category(k["name"]) == "cross_attention"})
    bwd = sorted({k["name"] for k in kernels
                  if kernel_category(k["name"]) == "cross_attention backward"})
    want_bwd = ca.bwd_kernel_name(ca.plan_bwd(1, 1, 1, cfg.TEXT.MAX_LENGTH, 4, dtype), dtype)
    if not (fwd and all(REQUEST_ATTN_KERNEL[name] in n for n in fwd) and bwd
            and all(want_bwd in n for n in bwd)):
        raise AssertionError(f"{label}: attention kernels {fwd} / {bwd}, want "
                             f"{REQUEST_ATTN_KERNEL[name]} / {want_bwd}")
    step_ms = statistics.median(times)
    res = {"card": card, "config": f"concept_in_df_gan + {name}", "dtype": DTYPE_NAME[dtype],
           "batch": bs, "launches_fit": launches, "launches_step": step_launches,
           "loop_step_ms": statistics.median(walls), "loop_step_ms_all": walls,
           "step_ms": step_ms, "step_ms_all": times, "img_per_s": bs / step_ms * 1e3,
           "step_kernel_ms": sum(k["ms"] for k in kernels), "step_busy_ms": busy_ms,
           "profiled_step_ms": wall_ms, "device_busy_share": busy_ms / wall_ms,
           "device_ms_by_category": by_category(kernels), "top_kernels": top_kernels(kernels, 8),
           "attention_kernels": fwd + bwd,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "metrics": metrics}
    log(f"{label}: launches of the fit {launches}, of one step {step_launches}, by the "
        f"profiler's names {fwd + bwd}; loop step {res['loop_step_ms']:.1f} ms (median of "
        f"{', '.join(f'{w:.1f}' for w in walls)}), bare step {step_ms:.1f} ms "
        f"({res['img_per_s']:.1f} img/s, median of 3), peak {res['peak_mem_gib']:.2f} GiB")
    log(f"{label} one step on the device: {res['step_kernel_ms']:.1f} ms of kernels, busy "
        f"{busy_ms:.1f} of {wall_ms:.1f} ms (share {res['device_busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in res["device_ms_by_category"].items()))
    for g in res["top_kernels"]:
        log(f"{label} top: {g['ms']:.1f} ms, {g['launches']} launches: {g['kernel']} <- "
            f"{g['op']} {g['dims']}")
    log(f"{label} last metrics: " + ", ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
    del tr, batch
    return res


def serve_sent(card: str, dtypes) -> list[dict]:
    """Phase 5c: ``ln_coco_256.yml`` serving from its SBERT cache: 128
    captions' rows of a synthetic ``sbert_cache_test.npz`` (T = 200, D = 768,
    fp16, ``SENT_CACHE_ROWS`` rows) -> ``make_encode_fn`` -> ``make_sample_fn``
    -> 128 images at 256², per dtype, the perturbed NCH 96 G; the cache read
    (the host's gather of the fp16 rows, ``SbertCache.rows``), the encode
    (read, pinned copy, fp32 cast and pooling on the card) and the G forward
    timed apart."""
    from xmc_gan_tpu_torch.data.text_encode import SbertCache

    cfg = ln_cfg()
    rng = np.random.RandomState(12)
    T, D = cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM
    root = tempfile.mkdtemp(prefix="chip_smoke_sent_")
    out = []
    try:
        attn = (np.arange(T)[None, :] < rng.randint(1, T + 1, SENT_CACHE_ROWS)[:, None])
        np.savez(os.path.join(root, "sbert_cache_test.npz"),
                 token_embs=rng.randn(SENT_CACHE_ROWS, T, D).astype(np.float16),
                 attn_mask=attn.astype(np.uint8))
        batch = {"cap_idx": rng.choice(SENT_CACHE_ROWS, BATCH, replace=False),
                 "mode": ["test"] * BATCH}
        noise = torch.from_numpy(rng.randn(BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32))
        sd = perturbed_state_dict(make_generator(cfg, device="cpu"), seed=40)
        cache = SbertCache(root, "test")
        for dtype in dtypes:
            encode = make_encode_fn(cfg, device="cuda", data_dir=root)
            g = make_generator(cfg, dtype, "cuda")
            g.load_state_dict(sd, strict=True)
            sample = make_sample_fn(cfg, g)

            def request():
                words, sent, mask = encode(batch)
                return sample(noise, sent, words, mask)

            label = f"[5c] serve LN-COCO SENT {DTYPE_NAME[dtype]} bs{BATCH} 256² | {card}"
            for _ in range(2):
                request()
            torch.cuda.synchronize()
            reset_counts()  # the SENT serving path's run
            img = request()
            torch.cuda.synchronize()
            launches = check_counts(label, {k: REQUEST_LAUNCHES["DF_GEN"].get(k, 0)
                                            for k in COUNTS})
            if tuple(img.shape) != (BATCH, 256, 256, 3) or not bool(torch.isfinite(img).all()) \
                    or img.abs().max().item() > 1.0:
                raise AssertionError(f"{label}: images {tuple(img.shape)} not finite or outside "
                                     "[-1, 1]")
            words, sent, mask = encode(batch)
            if tuple(words.shape) != (BATCH, T, D) or not bool(torch.isfinite(sent).all()):
                raise AssertionError(f"{label}: words {tuple(words.shape)}")
            torch.cuda.reset_peak_memory_stats()
            t_read, t_enc, t_g, t_req = [], [], [], []
            for _ in range(5):
                t0 = time.perf_counter()
                cache.rows(batch["cap_idx"])
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                encode(batch)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                sample(noise, sent, words, mask)
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                request()
                torch.cuda.synchronize()
                t5 = time.perf_counter()
                t_read.append((t1 - t0) * 1e3)
                t_enc.append((t3 - t2) * 1e3)
                t_g.append((t4 - t3) * 1e3)
                t_req.append((t5 - t4) * 1e3)
            kernels, busy_ms, wall_ms = device_kernels(request, expect=launch_patterns(launches))
            med = statistics.median
            res = {"config": "ln_coco_256 (SENT from the cache)", "dtype": DTYPE_NAME[dtype],
                   "launches": {k: v for k, v in launches.items() if v},
                   "cache_read_ms": med(t_read), "encode_ms": med(t_enc), "g_ms": med(t_g),
                   "request_ms": med(t_req), "img_per_s_request": BATCH / med(t_req) * 1e3,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "request_kernel_ms": sum(k["ms"] for k in kernels),
                   "request_busy_ms": busy_ms, "profiled_request_ms": wall_ms,
                   "device_busy_share": busy_ms / wall_ms,
                   "device_ms_by_category": by_category(kernels)}
            log(f"{label}: launches {res['launches']}; cache read {res['cache_read_ms']:.2f} ms "
                f"(host gather of {BATCH} fp16 rows), encode {res['encode_ms']:.2f} ms "
                f"(read + pinned copy + pooling), G forward {res['g_ms']:.2f} ms, request "
                f"{res['request_ms']:.2f} ms ({res['img_per_s_request']:.1f} img/s), medians of "
                f"5; peak {res['peak_mem_gib']:.2f} GiB")
            log(f"{label} one request on the device: {res['request_kernel_ms']:.2f} ms of "
                f"kernels, busy {busy_ms:.2f} of {wall_ms:.2f} ms (share "
                f"{res['device_busy_share']:.3f}); " + ", ".join(
                    f"{k} {v:.2f} ms" for k, v in res["device_ms_by_category"].items()))
            out.append(res)
            del g, sample, encode, img, words, sent, mask
            torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 5e: SBERT encoding (data/text_encode.py: the port's byte-level
# BPE tokenizer and RoBERTa encoder) on a seeded checkpoint at the published
# stsb-roberta-base shape (models/roberta.RobertaConfig's defaults: vocab
# 50,265, hidden 768, 12 layers, 12 heads, FFN 3,072, 514 positions; the
# real weights are not in the repository), in a temporary HF hub cache
SBERT_CAPTIONS = {"train": 2048, "test": 512}
SBERT_LONG_EVERY = 16  # about one caption in 16 is longer than T = 200 tokens
SBERT_CHECK_ROWS = 4  # captions encoded on the card and on the CPU (one long)
SBERT_TOL = 1e-4  # card vs CPU, fp32 with TF32 off: LayerNorm outputs of O(1)
SBERT_COMMIT = "5e" * 20  # the snapshot's name under refs/main
SBERT_SEED = 21
SBERT_PSEUDO_WORDS = 600
SBERT_WORDS = (
    "in this image we can see a an the of and on with there is are it its this that "
    "picture front background top bottom left right side middle near behind person people "
    "man woman boy girl child dog cat bird horse car bus train truck plate food table chair "
    "kitchen stove window door wall floor grass tree trees sky cloud clouds water road "
    "building buildings white black red blue green yellow brown small big standing sitting "
    "walking holding wearing looking playing some few two three many other objects poles "
    "light lights board text logo bottle cup glass bowl vase flowers plant plants field "
    "snow rock rocks fence bench umbrella bag shirt hat jacket").split()
SBERT_EXTRAS = ("it's", "we'll", "they're", "café", "crème", "2", "42", "1000", "🙂", "(", ")",
                "-")
# frequent byte pairs merged before any word's own merges, so that the
# merge order matters
SBERT_PAIRS = ("t h", "i n", "e r", "a n", "Ġ t", "o n", "r e", "Ġ a", "e n", "a t",
               "Ġ s", "o r", "Ġ w", "e s", "Ġt h", "i s", "Ġ c", "a r")


def sbert_vocabulary(rng) -> tuple[list[str], list[tuple[str, str]], dict[str, int]]:
    """The captions' words (``SBERT_WORDS``, seeded pseudo-words, a few
    extras), a few thousand deterministic BPE merges (``SBERT_PAIRS``, then
    each word built left to right, with and without the leading space) and
    the 50,265-entry vocabulary (4 specials, the 256 byte symbols, the
    merges' results, unused fillers, ``<mask>`` last)."""
    from xmc_gan_tpu_torch.data.bpe import bytes_to_unicode
    from xmc_gan_tpu_torch.models.roberta import RobertaConfig

    cons, vows = "bcdfghjklmnprstvwz", "aeiou"
    pseudo = sorted({"".join(rng.choice(list(cons)) + rng.choice(list(vows))
                             for _ in range(rng.randint(2, 5))) for _ in range(SBERT_PSEUDO_WORDS)})
    words = [*SBERT_WORDS, *pseudo]
    b2u = bytes_to_unicode()
    merges = [tuple(p.split()) for p in SBERT_PAIRS]
    seen = set(merges)
    for w in words:
        for lead in ("", " "):
            chars = [b2u[b] for b in (lead + w).encode("utf-8")]
            cur = chars[0]
            for c in chars[1:]:
                if (cur, c) not in seen:
                    seen.add((cur, c))
                    merges.append((cur, c))
                cur += c
    n_vocab = RobertaConfig().vocab_size
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for tok in [*b2u.values(), *(a + b for a, b in merges)]:
        vocab.setdefault(tok, len(vocab))
    for i in range(n_vocab - 1 - len(vocab)):
        vocab[f"<unused{i}>"] = len(vocab)
    vocab["<mask>"] = n_vocab - 1
    return [*words, *SBERT_EXTRAS], merges, vocab


def ln_caption(rng, words: list[str]) -> str:
    """A Localized-Narratives-like caption: 8-40 words after a fixed opening,
    or 220-320 (about one in ``SBERT_LONG_EVERY``, longer than T = 200
    tokens), commas, a period."""
    n = rng.randint(220, 321) if rng.randint(SBERT_LONG_EVERY) == 0 else rng.randint(8, 41)
    toks = [words[i] for i in rng.randint(0, len(words), n)]
    for i in rng.choice(n, n // 12, replace=False):
        toks[i] += ","
    text = " ".join(toks)
    return "In this image we can see " + text + "."


def write_sbert_checkpoint(path: str, vocab: dict[str, int], merges, seed: int) -> int:
    """A seeded RoBERTa at the published shape (HF's initializer range 0.02;
    LayerNorm scales 1 ± 0.1), saved as ``save_roberta`` writes it; returns
    the bytes of ``pytorch_model.bin``."""
    from xmc_gan_tpu_torch.models.roberta import RobertaConfig, RobertaModel, save_roberta

    gen = torch.Generator().manual_seed(seed)
    model = RobertaModel(RobertaConfig())
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=gen)
            p.copy_(1 + 0.1 * draw if name.endswith("LayerNorm.weight") else 0.02 * draw)
    save_roberta(path, model, vocab, merges)
    return os.path.getsize(os.path.join(path, "pytorch_model.bin"))


def roberta_ops(batch: int, T: int) -> float:
    """The encoder's floating-point operations for ``batch`` captions of T
    positions (every position is computed): the four H x H and two H x FFN
    products a token a layer, and the T x T scores and their weighted sum."""
    from xmc_gan_tpu_torch.models.roberta import RobertaConfig

    c = RobertaConfig()
    h, f = c.hidden_size, c.intermediate_size
    per_layer = 2 * batch * T * (4 * h * h + 2 * h * f) + 4 * batch * T * T * h
    return c.num_hidden_layers * per_layer


def fp16_within_ulp(a: np.ndarray, b: np.ndarray) -> bool:
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    return bool((np.abs(a.astype(np.float32) - b.astype(np.float32)) <= ulp).all())


def sbert_encoding(card: str) -> dict:
    """Phase 5e: SBERT encoding on the card.  (a) ``build_sbert_cache``
    over a synthetic ``bert_captions.pickle`` (``SBERT_CAPTIONS``, LN-length,
    some longer than T = 200 tokens) through the hub cache, its caches read
    back; (b) the tokenizer (host, with and without its per-word cache) and
    the encoder (card) timed apart, the encoder's busy share and bound at
    the serving batch; (c) the card's fp32 embeddings against the port's CPU
    encode on ``SBERT_CHECK_ROWS`` captions (``SBERT_TOL``); (d) 128 new
    captions served through ``make_hf_sbert_encode`` -> ``SBERTEncoder`` ->
    the ``ln_coco_256.yml`` G at 256², fp32 and bf16, 14 ``fused_affine``
    forwards a request asserted; (e) ``cli sample`` and ``cli prep-ln
    --build_cache`` in this process, as a user runs them.  (``main`` runs
    ``cli train`` beside phase 3: ``start_cli_train``.)"""
    import pickle

    from PIL import Image

    from xmc_gan_tpu_torch import cli
    from xmc_gan_tpu_torch.data.text_encode import (SbertCache, build_sbert_cache,
                                                    make_hf_sbert_encode)
    from xmc_gan_tpu_torch.device import to_device
    from xmc_gan_tpu_torch.registry import get_text_encoder

    cfg = ln_cfg()
    T, D = cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM
    label = f"[5e] SBERT encoding (stsb-roberta-base shape, seeded) | {card}"
    rng = np.random.RandomState(SBERT_SEED)
    root = tempfile.mkdtemp(prefix="chip_smoke_sbert_")
    old_hub = os.environ.get("HF_HUB_CACHE")
    res: dict = {"card": card, "captions": dict(SBERT_CAPTIONS), "T": T}
    med = statistics.median
    try:
        t0 = time.perf_counter()
        words, merges, vocab = sbert_vocabulary(rng)
        repo = os.path.join(root, "hub", "models--sentence-transformers--stsb-roberta-base")
        os.makedirs(os.path.join(repo, "refs"))
        with open(os.path.join(repo, "refs", "main"), "w") as f:
            f.write(SBERT_COMMIT)
        res["checkpoint_bytes"] = write_sbert_checkpoint(
            os.path.join(repo, "snapshots", SBERT_COMMIT), vocab, merges, SBERT_SEED)
        res["merges"], res["write_s"] = len(merges), time.perf_counter() - t0
        os.environ["HF_HUB_CACHE"] = os.path.join(root, "hub")
        data = os.path.join(root, "ln")
        os.makedirs(data)
        sents = {m: [ln_caption(rng, words) for _ in range(n)] for m, n in SBERT_CAPTIONS.items()}
        with open(os.path.join(data, "bert_captions.pickle"), "wb") as f:
            pickle.dump((sents["train"], sents["test"]), f)

        # (a) the caches, as a user builds them
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        build_sbert_cache(data, cfg, device="cuda")
        res["build_s"] = time.perf_counter() - t0
        res["build_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        caches = {m: SbertCache(data, m) for m in SBERT_CAPTIONS}
        full_rows = {}
        for m, n in SBERT_CAPTIONS.items():
            tok, attn = caches[m].token_embs, caches[m].attn_mask
            if tok.shape != (n, T, D) or tok.dtype != np.float16 or attn.dtype != np.uint8 \
                    or not np.isfinite(tok).all():
                raise AssertionError(f"{label}: {m} cache {tok.shape} {tok.dtype} {attn.dtype}")
            lengths = attn.sum(1)
            if not (attn[np.arange(n), np.maximum(lengths - 1, 0)] == 1).all() \
                    or (attn[:, :2] != 1).any():
                raise AssertionError(f"{label}: {m} masks are not <s> ... </s> then padding")
            full_rows[m] = int((lengths == T).sum())
        if not all(full_rows.values()):
            raise AssertionError(f"{label}: no caption reached T = {T} ({full_rows})")
        res["truncated_rows"] = full_rows
        res["real_tokens_mean"] = float(np.mean([c.attn_mask.sum(1).mean()
                                                 for c in caches.values()]))
        log(f"{label}: checkpoint {res['checkpoint_bytes'] / 2**20:.1f} MiB with "
            f"{len(merges)} merges written in {res['write_s']:.2f} s; build_sbert_cache of "
            f"{sum(SBERT_CAPTIONS.values())} captions {res['build_s']:.2f} s (peak "
            f"{res['build_peak_mem_gib']:.2f} GiB), {res['real_tokens_mean']:.1f} real tokens "
            f"a caption on average, rows at T: {full_rows}")

        # (b) the tokenizer (host) and the encoder (card) apart, on a fresh
        # encode function: the tokenizer's per-word cache starts empty
        t0 = time.perf_counter()
        encode = make_hf_sbert_encode(cfg)
        res["load_s"] = time.perf_counter() - t0
        all_sents = sents["train"] + sents["test"]
        batches = [all_sents[i:i + 256] for i in range(0, len(all_sents), 256)]
        toks, cold, warm = [], [], []
        for b in batches:
            t0 = time.perf_counter()
            toks.append(encode.tokenize(b))
            cold.append(time.perf_counter() - t0)
        for b in batches:
            t0 = time.perf_counter()
            encode.tokenize(b)
            warm.append(time.perf_counter() - t0)
        fwd = []
        for ids, mask in toks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = encode.forward(ids, mask)
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
        first = encode.forward(*toks[0]).half().cpu().numpy()
        if not fp16_within_ulp(first, caches["train"].token_embs[:256]):
            raise AssertionError(f"{label}: the encoder's first batch is not the cache's rows")
        ids128, mask128 = toks[0][0][:BATCH], toks[0][1][:BATCH]
        fwd128 = [cuda_ms(lambda: encode.forward(ids128, mask128), 1) for _ in range(5)]
        kernels, busy_ms, wall_ms = device_kernels(lambda: encode.forward(ids128, mask128))
        ops = roberta_ops(BATCH, T)
        res.update({
            "tokenize_ms_per_caption_cold": 1e3 * sum(cold) / len(all_sents),
            "tokenize_ms_per_caption_warm": 1e3 * sum(warm) / len(all_sents),
            "tokenize_ms_256": {"cold": [1e3 * t for t in cold], "warm": [1e3 * t for t in warm]},
            "encoder_ms_256_wall": fwd, "encoder_ms_128": med(fwd128),
            "encoder_bound_ms_128": ops / FP32_OPS_PER_S * 1e3,
            "encoder_tflops_128": ops / med(fwd128) / 1e9,
            "encoder_kernel_ms_128": sum(k["ms"] for k in kernels),
            "encoder_busy_ms_128": busy_ms, "encoder_profiled_ms_128": wall_ms,
            "encoder_busy_share_128": busy_ms / wall_ms,
            "encoder_device_ms_by_category": by_category(kernels),
        })
        log(f"{label}: load {res['load_s']:.2f} s; tokenizer (host) "
            f"{res['tokenize_ms_per_caption_cold']:.3f} ms a caption with an empty word cache, "
            f"{res['tokenize_ms_per_caption_warm']:.3f} warm; encoder (card, fp32, TF32 off) "
            f"{med(fwd):.2f} ms a batch of 256 (wall), {res['encoder_ms_128']:.2f} ms for "
            f"{BATCH} captions (CUDA events, median of 5; bound {res['encoder_bound_ms_128']:.2f} "
            f"ms at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s: {res['encoder_tflops_128']:.1f} "
            f"TFLOP/s), busy {busy_ms:.2f} of {wall_ms:.2f} ms (share "
            f"{res['encoder_busy_share_128']:.3f}); " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in res["encoder_device_ms_by_category"].items()))
        del out, first, kernels
        torch.cuda.empty_cache()

        # (c) the card against the CPU
        long_rows = [s for s in sents["test"] if len(s.split()) > 200][:1]
        rows = long_rows + [s for s in sents["test"] if len(s.split()) <= 200][
            :SBERT_CHECK_ROWS - len(long_rows)]
        cpu = make_hf_sbert_encode(cfg, device="cpu")
        e_cpu, m_cpu = cpu(rows)
        e_card, m_card = encode(rows)
        err = float(np.abs(e_card - e_cpu).max())
        res.update({"card_vs_cpu_max_abs_err": err, "card_vs_cpu_tol": SBERT_TOL,
                    "card_vs_cpu_rows": len(rows)})
        if not (m_card == m_cpu).all() or not err <= SBERT_TOL:
            raise AssertionError(f"{label}: card vs CPU max abs err {err:.3g} (tol {SBERT_TOL}), "
                                 f"masks equal {(m_card == m_cpu).all()}")
        log(f"{label}: card vs CPU on {len(rows)} captions ({len(long_rows)} longer than T): "
            f"max abs err {err:.3g} (tol {SBERT_TOL}), masks equal")
        del cpu

        # (d) 128 new captions served
        new = [ln_caption(rng, words) for _ in range(BATCH)]
        enc = get_text_encoder("SBERT")(cfg)
        dev = torch.device("cuda")
        noise = torch.from_numpy(rng.randn(BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32))
        sd = perturbed_state_dict(make_generator(cfg, device="cpu"), seed=40)
        res["serving"] = []
        for dtype in (torch.float32, torch.bfloat16):
            g = make_generator(cfg, dtype, "cuda")
            g.load_state_dict(sd, strict=True)
            sample = make_sample_fn(cfg, g)

            def request():
                tok, attn = encode(new)
                w, s, m = enc(to_device(tok, dev), to_device(attn, dev))
                return sample(noise, s, w, m)

            lbl = f"[5e] serve new LN-COCO captions {DTYPE_NAME[dtype]} bs{BATCH} 256² | {card}"
            encode.tokenizer.cache.clear()
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            request()
            torch.cuda.synchronize()
            reset_counts()  # the new captions' serving path's run
            img = request()
            torch.cuda.synchronize()
            launches = check_counts(lbl, {k: REQUEST_LAUNCHES["DF_GEN"].get(k, 0)
                                          for k in COUNTS})
            if tuple(img.shape) != (BATCH, 256, 256, 3) or not bool(torch.isfinite(img).all()) \
                    or img.abs().max().item() > 1.0:
                raise AssertionError(f"{lbl}: images {tuple(img.shape)} not finite or outside "
                                     "[-1, 1]")
            tok, attn = encode(new)
            w, s, m = enc(to_device(tok, dev), to_device(attn, dev))
            torch.cuda.reset_peak_memory_stats()
            t_tok, t_enc, t_g, t_req = [], [], [], []
            for _ in range(5):
                t0 = time.perf_counter()
                ids, mask = encode.tokenize(new)
                t1 = time.perf_counter()
                encode.forward(ids, mask).cpu()
                t2 = time.perf_counter()
                sample(noise, s, w, m)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                request()
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                t_tok.append((t1 - t0) * 1e3)
                t_enc.append((t2 - t1) * 1e3)
                t_g.append((t3 - t2) * 1e3)
                t_req.append((t4 - t3) * 1e3)
            kernels, busy_ms, wall_ms = device_kernels(request, expect=launch_patterns(launches))
            r = {"config": "ln_coco_256 (SENT, new captions)", "dtype": DTYPE_NAME[dtype],
                 "launches": {k: v for k, v in launches.items() if v},
                 "first_request_ms": first_ms, "tokenize_ms": med(t_tok),
                 "encoder_ms": med(t_enc), "g_ms": med(t_g), "request_ms": med(t_req),
                 "img_per_s_request": BATCH / med(t_req) * 1e3,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "request_kernel_ms": sum(k["ms"] for k in kernels),
                 "request_busy_ms": busy_ms, "profiled_request_ms": wall_ms,
                 "device_busy_share": busy_ms / wall_ms,
                 "device_ms_by_category": by_category(kernels)}
            log(f"{lbl}: launches {r['launches']}; first request {first_ms:.1f} ms (a fresh G, an "
                f"empty word cache); tokenize {r['tokenize_ms']:.2f} ms (host), encoder + copy to "
                f"the host {r['encoder_ms']:.2f} ms, G forward {r['g_ms']:.2f} ms, request "
                f"{r['request_ms']:.2f} ms ({r['img_per_s_request']:.1f} img/s), medians of 5; "
                f"peak {r['peak_mem_gib']:.2f} GiB; busy {busy_ms:.2f} of {wall_ms:.2f} ms "
                f"(share {r['device_busy_share']:.3f}); " + ", ".join(
                    f"{k} {v:.2f} ms" for k, v in r["device_ms_by_category"].items()))
            res["serving"].append(r)
            del g, sample, img, w, s, m, kernels
            torch.cuda.empty_cache()
        del encode
        torch.cuda.empty_cache()

        # (e) the CLI's sample and prep-ln --build_cache, as a user runs them
        png = os.path.join(root, "sample.png")
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["sample", "--cfg", str(LN_CFG), "--data_dir", data, "--caption",
                           new[0], "--caption", new[1], "--n_per_caption", "2", "--out", png,
                           "--output_root", os.path.join(root, "none")])
        if rc != 0 or printed.getvalue().strip() != png:
            raise AssertionError(f"{label}: cli sample exit {rc}, printed {printed.getvalue()!r}")
        res["cli_sample_s"] = time.perf_counter() - t0
        with Image.open(png) as im:
            if min(im.size) < 2 * 256:
                raise AssertionError(f"{label}: cli sample wrote a {im.size} grid")
        n_prep = {"train": 256, "test": 64}
        jsonl = {}
        for m, n in n_prep.items():
            jsonl[m] = os.path.join(root, f"{m}.jsonl")
            with open(jsonl[m], "w") as f:
                f.writelines(json.dumps({"image_id": f"{m}{i}", "caption": c}) + "\n"
                             for i, c in enumerate(sents[m][:n]))
        prep = os.path.join(root, "prep")
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["prep-ln", "--data_dir", prep, "--train_jsonl", jsonl["train"],
                           "--test_jsonl", jsonl["test"], "--build_cache", "--cfg", str(LN_CFG)])
        if rc != 0 or printed.getvalue().strip() != str(n_prep):
            raise AssertionError(f"{label}: cli prep-ln --build_cache exit {rc}, printed "
                                 f"{printed.getvalue()!r}")
        res["cli_prep_ln_s"] = time.perf_counter() - t0
        for m, n in n_prep.items():
            got = SbertCache(prep, m)
            if not (got.attn_mask == caches[m].attn_mask[:n]).all() \
                    or not fp16_within_ulp(got.token_embs, caches[m].token_embs[:n]):
                raise AssertionError(f"{label}: prep-ln's {m} cache differs from "
                                     "build_sbert_cache's rows")
        log(f"{label}: cli sample (2 captions x 2) {res['cli_sample_s']:.1f} s; cli prep-ln "
            f"--build_cache ({n_prep}) {res['cli_prep_ln_s']:.1f} s, its caches within one fp16 "
            "ulp of build_sbert_cache's rows")

        return res
    finally:
        if old_hub is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = old_hub
        shutil.rmtree(root, ignore_errors=True)


# phase 5d: the exported samplers (utils/export.py), traced with a symbolic
# batch, loaded and served in a fresh process that imports only the export
# module (and the profiler reader), against make_sample_fn in this one.
# The same operators on the same inputs: bit-equal but for cuDNN's fp32
# algorithms, which need not be deterministic (two make_sample_fn runs on
# the same inputs differed by up to 6.8e-6 at 256² on an H100; its bf16
# runs were bit-equal).  Held to 1e-5 in fp32 (TF32 off on both
# sides), or to twice that rerun spread where the run's is larger, and to
# one bf16 ulp of the [-1, 1] output in bf16
EXPORT_GENS = ("DF_GEN", "CONCEPT_OUTATTN_GEN", "CONCEPT_INATTN_GEN")
EXPORT_BATCHES = (BATCH, 3)
EXPORT_TOL = {torch.float32: 1e-5, torch.bfloat16: BF16_ULP}
EXPORT_TIMEOUT_S = 300
# the port's modules a process that serves an artifact may hold: the export
# module, the operators it registers and their build, the profiler reader,
# and the packages above them
EXPORT_CHILD_MODULES = {"xmc_gan_tpu_torch", "xmc_gan_tpu_torch.ops", "xmc_gan_tpu_torch.utils",
                        "xmc_gan_tpu_torch.utils.export", "xmc_gan_tpu_torch.profiling",
                        "xmc_gan_tpu_torch.ops.cuda", "xmc_gan_tpu_torch.ops.cuda.build",
                        "xmc_gan_tpu_torch.ops.cuda.fused_affine",
                        "xmc_gan_tpu_torch.ops.cuda.cross_attention"}
# the fresh process of phase 5d: argv[1] names a JSON list of jobs
EXPORT_CHILD = r"""
import json, re, statistics, sys, time
import torch
from xmc_gan_tpu_torch.utils.export import load_sampler
from xmc_gan_tpu_torch.profiling import device_kernels

counts = {f"{m}.{c.lower()}": getattr(sys.modules[f"xmc_gan_tpu_torch.ops.cuda.{m}"], c)
          for m, cs in (("fused_affine", ("FORWARD", "BACKWARD", "DOUBLE_BACKWARD")),
                        ("cross_attention", ("FORWARD", "BACKWARD"))) for c in cs}
out = []
for job in json.load(open(sys.argv[1])):
    t0 = time.perf_counter()
    serve = load_sampler(job["artifact"])
    load_s = time.perf_counter() - t0
    d = torch.load(job["inputs"])
    params = {k: v.cuda() for k, v in d["params"].items()}
    reqs = {b: [t.cuda() for t in args] for b, args in d["requests"].items()}
    big = reqs[str(job["batch"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(params, *big)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    images, launches = {}, {}
    for b, args in reqs.items():
        torch.cuda.synchronize()
        for c in counts.values():
            c.launches = 0
        images[b] = serve(params, *args)
        torch.cuda.synchronize()
        launches[b] = {k: c.launches for k, c in counts.items()}
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(params, *big)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    kernels, busy_ms, wall_ms = device_kernels(lambda: serve(params, *big),
                                               expect={job["pattern"]: job["launches"]})
    torch.save(images, job["images"])
    out.append({"label": job["label"], "load_s": load_s, "first_request_ms": first_ms,
                "launches": launches, "request_ms": statistics.median(times),
                "kernels": sorted({k["name"] for k in kernels
                                   if re.search(job["pattern"], k["name"])}),
                "request_kernel_ms": sum(k["ms"] for k in kernels), "busy_ms": busy_ms,
                "profiled_request_ms": wall_ms})
    del params, reqs, big, images
    torch.cuda.empty_cache()
print(json.dumps({"results": out, "modules": sorted(m for m in sys.modules
                                                   if m.startswith(("xmc_gan_tpu", "jax")))}))
"""


def export_pattern(name: str) -> str:
    """The kernel an exported request of ``name`` launches, by the profiler's name."""
    return re.escape(REQUEST_ATTN_KERNEL[name]) if name in REQUEST_ATTN_KERNEL \
        else KERNEL_PATTERN["fused_affine.forward"]


def serve_exported(card: str, sds: dict) -> list[dict]:
    """Phase 5d: each of ``EXPORT_GENS`` (256², NCH 32, phase 5's perturbed
    weights ``sds``) exported with a symbolic batch in fp32 and bf16 and
    saved; the graph's operator nodes counted; then one fresh process loads
    every artifact and serves a 128-row and a 3-row request of each
    (``EXPORT_CHILD``: launches counted, kernels by name, median of 5),
    and this process holds its images to ``make_sample_fn``'s on the same
    weights and inputs (``EXPORT_TOL``) and times the two in turns."""
    from xmc_gan_tpu_torch.utils.export import (export_sampler, sampler_fn, sampler_ops,
                                                save_sampler, uses_words)

    root = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        jobs, refs, res = [], {}, {}
        for name in EXPORT_GENS:
            cfg = df_cfg() if name == "DF_GEN" else concept_cfg(name)
            rng = np.random.RandomState(21)
            caps = random_captions(rng, BATCH, cfg.TEXT.MAX_LENGTH, cfg.TEXT.VOCA_SIZE)
            noise = torch.from_numpy(rng.randn(BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32))
            words, sent, mask = make_encode_fn(cfg, device="cuda")(caps)
            args = [noise.cuda(), sent] + ([words, mask] if uses_words(cfg) else [])
            want = REQUEST_LAUNCHES[name]
            for dtype in (torch.float32, torch.bfloat16):
                label = f"{name} {DTYPE_NAME[dtype]}"
                t0 = time.perf_counter()
                ep, template = export_sampler(cfg, dtype=dtype, device="cuda")
                export_s = time.perf_counter() - t0
                if list(template) != list(sds[name]):
                    raise AssertionError(f"{label}: the template's keys are not G's state_dict's")
                nodes = sum(n.target in sampler_ops() for n in ep.graph.nodes)
                if nodes != sum(want.values()):
                    raise AssertionError(f"{label}: {nodes} operator nodes, want {want}")
                path = save_sampler(os.path.join(root, f"{name}_{DTYPE_NAME[dtype]}.pt2"), ep)
                g = make_generator(cfg, dtype, "cuda")
                g.load_state_dict(sds[name], strict=True)
                sample = make_sample_fn(cfg, g)
                refs[label] = {str(b): sample(*(a[:b] for a in args)) for b in EXPORT_BATCHES}
                here = sampler_fn(ep)  # the program as saved, unsaved: no load here
                params = {k: v.cuda() for k, v in sds[name].items()}
                for _ in range(2):
                    here(params, *args)
                # two eager runs apart (cuDNN's algorithms need not be
                # deterministic), and the artifact in this process
                again = (sample(*args) - refs[label][str(BATCH)]).abs().max().item()
                here_err = (here(params, *args) - refs[label][str(BATCH)]).abs().max().item()
                log(f"[5d] {label}: exported in {export_s:.2f} s, {nodes} operator nodes; in this "
                    f"process max abs diff from make_sample_fn: the artifact {here_err:.3g}, "
                    f"make_sample_fn again {again:.3g}")
                t_eager, t_export = [], []
                for _ in range(3):  # in turns
                    for fn, times in ((lambda: sample(*args), t_eager),
                                      (lambda: here(params, *args), t_export)):
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t1) * 1e3)
                res[label] = {"generator": name, "dtype": DTYPE_NAME[dtype], "export_s": export_s,
                              "artifact_mib": os.path.getsize(path) / 2**20,
                              "operator_nodes": nodes, "max_abs_diff_here": here_err,
                              "sample_fn_rerun_diff": again,
                              "sample_fn_ms": statistics.median(t_eager),
                              "exported_ms_here": statistics.median(t_export)}
                inputs = os.path.join(root, f"{name}_{DTYPE_NAME[dtype]}.in.pt")
                torch.save({"params": sds[name],
                            "requests": {str(b): [a[:b].cpu() for a in args]
                                         for b in EXPORT_BATCHES}}, inputs)
                jobs.append({"label": label, "artifact": path, "inputs": inputs,
                             "images": os.path.join(root, f"{name}_{DTYPE_NAME[dtype]}.out.pt"),
                             "batch": BATCH, "pattern": export_pattern(name),
                             "launches": sum(want.values())})
                del ep, g, sample, here, params
                torch.cuda.empty_cache()
        jobs_path = os.path.join(root, "jobs.json")
        with open(jobs_path, "w") as f:
            json.dump(jobs, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, jobs_path], cwd=REPO,
                              capture_output=True, text=True, timeout=EXPORT_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"[5d] the serving process failed ({proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-8000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        strays = sorted(set(child["modules"]) - EXPORT_CHILD_MODULES)
        if strays:
            raise AssertionError(f"[5d] the serving process imported {strays}")
        out = []
        for job, r in zip(jobs, child["results"]):
            label, dtype = job["label"], DTYPES_BY_NAME[job["label"].split()[-1]]
            name = label.split()[0]
            want = {k: REQUEST_LAUNCHES[name].get(k, 0) for k in r["launches"][str(BATCH)]}
            if any(n != want for n in r["launches"].values()):
                raise AssertionError(f"{label} exported: launches {r['launches']}, want {want}")
            if not all(REQUEST_ATTN_KERNEL.get(name, "fused_affine_") in k for k in r["kernels"]):
                raise AssertionError(f"{label} exported: kernels {r['kernels']}")
            images = torch.load(job["images"], map_location="cuda")
            errs = {}
            for b, img in images.items():
                if tuple(img.shape) != (int(b), 256, 256, 3) or img.dtype != torch.float32 \
                        or not bool(torch.isfinite(img).all()) or img.abs().max().item() > 1.0:
                    raise AssertionError(f"{label} exported, batch {b}: images "
                                         f"{tuple(img.shape)} {img.dtype} not finite or outside "
                                         "[-1, 1]")
                errs[b] = (img - refs[label][b]).abs().max().item()
                tol = max(EXPORT_TOL[dtype], 2 * res[label]["sample_fn_rerun_diff"])
                if errs[b] > tol:
                    raise AssertionError(f"{label} exported, batch {b}: max abs diff {errs[b]} "
                                         f"from make_sample_fn > {tol}")
            row = {**res[label], **{k: r[k] for k in ("load_s", "first_request_ms", "request_ms",
                                                      "kernels", "request_kernel_ms", "busy_ms",
                                                      "profiled_request_ms")},
                   "launches": {k: v for k, v in r["launches"][str(BATCH)].items() if v},
                   "max_abs_diff": errs}
            out.append(row)
            log(f"[5d] {label} exported bs{BATCH} 256²: export {row['export_s']:.2f} s, "
                f"{row['artifact_mib']:.2f} MiB, {row['operator_nodes']} operator nodes; fresh "
                f"process: load {row['load_s']:.2f} s, launches {row['launches']} "
                f"({', '.join(row['kernels'])}), request {row['request_ms']:.2f} ms (median of 5; "
                f"{row['request_kernel_ms']:.2f} ms of kernels); here in turns: exported "
                f"{row['exported_ms_here']:.2f} ms, make_sample_fn {row['sample_fn_ms']:.2f} ms; "
                f"max abs diff from make_sample_fn {errs} | {card}")
        log(f"[5d] the serving process took {child_s:.1f} s, imported "
            f"{[m for m in child['modules'] if m.startswith('xmc_gan_tpu_torch')]}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 6g: data parallelism.  Two ranks share the one card over gloo (NCCL
# refuses two ranks on one card); the flagship_word config's parity step at
# NCH 8, 64², a global batch of 8 (each rank's [4, 8] word-score row block
# forced onto the damsm kernels, as phase 4's small steps force them), then
# its full width at 2 x 128 rows
DP_WORLD = 2
DP_PARITY = {"TRAIN": {"NCH": 8, "BATCH_SIZE": 8}, "IMG": {"SIZE": 64}}
DP_PARITY_STEPS = 2
DP_TIMED = 2
DP_TIMEOUT_S = 420
DAMSM_COUNTS = ("damsm_score.forward", "damsm_score.d_regions", "damsm_score.d_words")


def dp_parity_cfg():
    return cfg_from_dict(DP_PARITY, base=cfg_from_dict(TRAIN_OVERRIDES))


def dp_parity_batches(cfg) -> list[tuple[dict, np.ndarray]]:
    """Phase 6g(b)'s global batches and noise, the same on every rank."""
    rng = np.random.RandomState(9)
    bs = cfg.TRAIN.BATCH_SIZE
    return [(train_batch(rng, cfg, bs, prefix_mask),
             rng.randn(bs, cfg.TRAIN.NOISE_DIM).astype(np.float32))
            for _ in range(DP_PARITY_STEPS)]


def dp_parity(mesh, out_dir: Path) -> dict:
    """A rank of phase 6g(b)'s parity run: fp32 (TF32 off), the word scores
    through the damsm kernels at any size; saves G and D after the steps."""
    cfg = dp_parity_cfg()
    state = create_train_state(cfg, torch.float32, mesh.device, seed=0)
    replicate(mesh, state)
    step = make_train_step(cfg, word_block_elems=0, mesh=mesh)
    metrics = []
    reset_counts()
    for batch, noise in dp_parity_batches(cfg):
        local = shard_batch(mesh, {**batch, "noise": noise})
        m = step(state, local, local.pop("noise"))
        metrics.append({k: float(v) for k, v in m.items()})
    torch.save({"g": {k: v.cpu() for k, v in state.g.state_dict().items()},
                "d": {k: v.cpu() for k, v in state.d.state_dict().items()}},
               out_dir / f"parity_{mesh.rank}.pt")
    return {"metrics": metrics, "launches": read_counts()}


def dp_full(mesh) -> dict:
    """A rank of phase 6g's full-width run: the flagship_word step in bf16,
    this rank's 128 rows of a global batch of ``128 * world``: one warm-up,
    one counted step, ``DP_TIMED`` timed (each synchronized)."""
    cfg = cfg_from_dict(TRAIN_OVERRIDES)
    bs, world = cfg.TRAIN.BATCH_SIZE, mesh.world
    state = create_train_state(cfg, torch.bfloat16, mesh.device, seed=0)
    replicate(mesh, state)
    step = make_train_step(cfg, mesh=mesh)
    rng = np.random.RandomState(7)
    batch = train_batch(rng, cfg, bs * world, prefix_mask)
    noises = [rng.randn(bs * world, cfg.TRAIN.NOISE_DIM).astype(np.float32)
              for _ in range(DP_TIMED + 2)]
    local = {k: torch.from_numpy(v).to(mesh.device) for k, v in shard_batch(mesh, batch).items()}
    noises = [torch.from_numpy(n[mesh.rows(bs)]).to(mesh.device) for n in noises]
    step(state, local, noises[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics = step(state, local, noises[1])
    torch.cuda.synchronize()
    launches = read_counts()
    times = []
    for noise in noises[2:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, local, noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    # what the gradient mean costs alone: one all_reduce_mean_ of D's and of
    # G's gradient sizes (a step runs D's twice, G's once)
    reduce_ms = {}
    for net, model in (("d", state.d), ("g", state.g)):
        grads = [torch.zeros_like(p) for p in model.parameters()]
        all_reduce_mean_(grads, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED):
            all_reduce_mean_(grads, mesh)
        torch.cuda.synchronize()
        reduce_ms[net] = (time.perf_counter() - t0) * 1e3 / DP_TIMED
        del grads
    T, R = cfg.TEXT.MAX_LENGTH, REGIONS
    return {"launches": launches, "step_ms": statistics.median(times), "step_ms_all": times,
            "grad_all_reduce_ms": reduce_ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "row_block": [bs, bs * world, T, R],
            "row_block_backend": word_scores_backend(bs, bs * world, T, R,
                                                     WORD_LOSS_BLOCK_ELEMS, mesh.device)}


def dp_rank_main(argv: list[str]) -> int:
    """``chip_smoke.py --dp-rank R --dp-world W --dp-dir DIR --dp-backend B
    --dp-device D [--dp-parity] [--dp-tp T]``: one rank of phase 6g (of 6h
    with ``--dp-tp`` > 1: the parity run or the full width), started by
    ``dp_ranks``; writes ``DIR/rank_R.json``."""
    import argparse

    p = argparse.ArgumentParser()
    for name, kind in (("rank", int), ("world", int), ("dir", str), ("backend", str),
                       ("device", str)):
        p.add_argument(f"--dp-{name}", type=kind, required=True)
    p.add_argument("--dp-parity", action="store_true")
    p.add_argument("--dp-tp", type=int, default=1)
    a = p.parse_args(argv)
    out_dir = Path(a.dp_dir)
    mesh = make_mesh(a.dp_world // a.dp_tp, a.dp_tp, device=a.dp_device, backend=a.dp_backend,
                     init_method=f"file://{out_dir / 'store'}", rank=a.dp_rank,
                     world_size=a.dp_world)
    try:
        res = {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device)}
        if a.dp_tp > 1:  # phase 6h: the parity ranks or the full-width ones
            if a.dp_parity:
                res["parity"] = tp_parity(mesh, out_dir)
            else:
                res["full"] = tp_full(mesh)
        else:
            if a.dp_parity:
                res["parity"] = dp_parity(mesh, out_dir)
                torch.cuda.empty_cache()
            res["full"] = dp_full(mesh)
        (out_dir / f"rank_{mesh.rank}.json").write_text(json.dumps(res))
    finally:
        shutdown()
    return 0


def dp_ranks(backend: str, devices: list[str], parity: bool, tp: int = 1) -> list[dict]:
    """Start phase 6g's ranks (6h's with ``tp`` > 1) as processes of this
    script, wait for them (killed after ``DP_TIMEOUT_S``), and return each
    rank's result."""
    phase = "6h" if tp > 1 else "6g"
    root = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_"))
    world = len(devices)
    procs = []
    for rank, dev in enumerate(devices):
        args = [sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(rank),
                "--dp-world", str(world), "--dp-dir", str(root), "--dp-backend", backend,
                "--dp-device", dev, "--dp-tp", str(tp)] + (["--dp-parity"] if parity else [])
        log_file = open(root / f"log_{rank}.txt", "w")
        procs.append((subprocess.Popen(args, cwd=REPO, stdout=log_file,
                                       stderr=subprocess.STDOUT), log_file))
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log_file in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log_file.close()
    failed = [r for r, (proc, _) in enumerate(procs) if proc.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n{(root / f'log_{r}.txt').read_text()[-3000:]}"
                          for r in range(world))
        raise AssertionError(f"[{phase}] {backend} ranks {failed} failed or hung:\n{tails}")
    res = [json.loads((root / f"rank_{r}.json").read_text()) for r in range(world)]
    if parity:
        for r in range(world):
            res[r]["parity"]["state"] = torch.load(root / f"parity_{r}.pt", weights_only=True)
    shutil.rmtree(root, ignore_errors=True)
    return res


def dp_check_full(label: str, ranks: list[dict], card: str) -> dict:
    """Phase 6g's full-width ranks: launches, finite losses, the row block on
    the kernels; logs each rank's step, the global images/s and memory."""
    want = STEP_LAUNCHES  # a rank step launches what one process's step does
    for r in ranks:
        full = r["full"]
        if full["launches"] != want:
            raise AssertionError(f"[6g] {label} rank {r['rank']}: launches {full['launches']}, "
                                 f"want {want}")
        if full["row_block_backend"] != "kernel":
            raise AssertionError(f"[6g] {label}: the row block {full['row_block']} is not on "
                                 "the damsm kernels")
        bad = [k for k, v in full["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"[6g] {label} rank {r['rank']}: non-finite {bad}")
    bs, b_global = ranks[0]["full"]["row_block"][:2]
    step_ms = max(r["full"]["step_ms"] for r in ranks)
    res = {"label": label, "backend": ranks[0]["backend"],
           "devices": [r["device"] for r in ranks], "global_batch": b_global,
           "rank_step_ms": [r["full"]["step_ms"] for r in ranks],
           "rank_step_ms_all": [r["full"]["step_ms_all"] for r in ranks],
           "img_per_s": b_global / (step_ms / 1e3),
           "peak_mem_gib": [r["full"]["peak_mem_gib"] for r in ranks],
           "grad_all_reduce_ms": ranks[0]["full"]["grad_all_reduce_ms"],
           "launches_rank_step": ranks[0]["full"]["launches"],
           "metrics": ranks[0]["full"]["metrics"]}
    log(f"[6g] {label}: flagship_word bf16 at a global batch of {b_global} ({bs} rows a rank), "
        f"rank step " + " / ".join(f"{ms:.1f}" for ms in res["rank_step_ms"])
        + f" ms (median of {DP_TIMED}), {res['img_per_s']:.1f} img/s global, peak "
        + " / ".join(f"{g:.2f}" for g in res["peak_mem_gib"]) + " GiB a rank; the gradient "
        f"mean alone {res['grad_all_reduce_ms']['d']:.1f} ms for D's, "
        f"{res['grad_all_reduce_ms']['g']:.1f} ms for G's (a step runs D's twice); a rank step "
        f"launches {res['launches_rank_step']}, the damsm forward and d_regions on the "
        f"[{bs}, {b_global}] row block (T = {ranks[0]['full']['row_block'][2]}, R = "
        f"{ranks[0]['full']['row_block'][3]}) | {card}")
    return res


def dp_check_parity(ranks: list[dict], card: str, tp: int = 1) -> dict:
    """Phase 6g(b)'s parity (6h(a)'s with ``tp`` > 1, the whole state each
    rank gathered): the ranks against one process on the card at the whole
    batch (metrics, parameters within phase 4's bounds), and the ranks'
    parameters bit-equal."""
    tag = "[6h]" if tp > 1 else "[6g]"
    cfg = dp_parity_cfg()
    state = create_train_state(cfg, torch.float32, "cuda", seed=0)
    step = make_train_step(cfg, word_block_elems=0)
    want = [{k: float(v) for k, v in step(state, batch, noise).items()}
            for batch, noise in dp_parity_batches(cfg)]
    a = ranks[0]["parity"]
    for r in ranks[1:]:
        b = r["parity"]
        if a["metrics"] != b["metrics"]:
            raise AssertionError(f"{tag} parity: the ranks' metrics differ")
        for net in ("g", "d"):
            for name, v in a["state"][net].items():
                if not torch.equal(v, b["state"][net][name]):
                    raise AssertionError(f"{tag} parity: the ranks' {net}.{name} differ")
    for k, (got, ref) in enumerate(zip(a["metrics"], want)):
        for key, v in ref.items():
            if not abs(got[key] - v) <= TRAIN_TOL["metric"] * max(1.0, abs(v)):
                raise AssertionError(f"{tag} parity step {k} {key}: {len(ranks)} ranks "
                                     f"{got[key]} vs one process {v}")
    lr = max(cfg.TRAIN.OPT.G_LR, cfg.TRAIN.OPT.D_LR)
    share, worst, worst_uv, n_all = param_agreement(
        (state.g.state_dict(), state.d.state_dict()), (a["state"]["g"], a["state"]["d"]), lr)
    want_launches = {k: DP_PARITY_STEPS * STEP_LAUNCHES[k] for k in DAMSM_COUNTS}
    for r in ranks:
        got = {k: r["parity"]["launches"][k] for k in want_launches}
        if got != want_launches:
            raise AssertionError(f"{tag} parity rank {r['rank']}: damsm launches {got}, want "
                                 f"{want_launches}")
    bs, dp = cfg.TRAIN.BATCH_SIZE, len(ranks) // tp
    block = (f"[{bs // dp}, {bs // tp}] column block" if tp > 1
             else f"[{bs // dp}, {bs}] row block")
    mesh = f"dp {dp} x tp {tp}, {a.get('split', [0, 0])} of G's / D's weights split, " \
        if tp > 1 else ""
    log(f"{tag} parity, {len(ranks)} gloo ranks ({mesh}on {ranks[0]['device']}) vs one process, "
        f"fp32 (TF32 off), NCH 8, 64², global batch {bs}, {DP_PARITY_STEPS} steps: metrics "
        f"within {TRAIN_TOL['metric']:g}; params {share:.6f} of {n_all} within "
        f"{TRAIN_TOL['param_lr_frac'] * lr:.2g}, worst {worst:.3g} (bound {4 * lr:.2g}); u/v "
        f"worst {worst_uv:.3g}; the ranks' parameters bit-equal; damsm launches a rank "
        f"{want_launches} on the {block} | {card}")
    if share < TRAIN_TOL["param_share"] or worst > 4 * lr or worst_uv > TRAIN_TOL["uv"]:
        raise AssertionError(f"{tag} parity: {len(ranks)} ranks and one process differ beyond "
                             "the tolerance")
    if tp > 1 and not all(a["split"]):
        raise AssertionError(f"{tag} parity: nothing split in G or D ({a['split']})")
    del state
    torch.cuda.empty_cache()
    return {"param_share": share, "param_worst": worst, "uv_worst": worst_uv,
            "launches_rank_2_steps": a["launches"]}


def dp_phase(card: str, bare_step_ms: float) -> dict:
    """Phase 6g: (a) the data-parallel step at full width on a one-rank NCCL
    group in this process, beside phase 6's step; (b) two ranks on this card
    over gloo: parity, then full width at a global batch of 256; (c) where
    the machine has two cards or more, two NCCL ranks, one card each."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl1_"))
    mesh = make_mesh(1, device="cuda:0", backend="nccl", init_method=f"file://{root / 'store'}",
                     rank=0, world_size=1)
    try:
        one = train(cfg_from_dict(TRAIN_OVERRIDES), "flagship_word DP (NCCL, world 1)",
                    torch.bfloat16, 2, 5, prefix_mask, mesh=mesh)
    finally:
        shutdown()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[6g] (a) one-rank NCCL group: the data-parallel flagship_word bf16 step "
        f"{one['step_ms']:.1f} ms beside phase 6's {bare_step_ms:.1f} ms | {card}")
    torch.cuda.empty_cache()
    res = {"nccl_world_1": one}
    ranks = dp_ranks("gloo", ["cuda:0"] * DP_WORLD, parity=True)
    res["parity"] = dp_check_parity(ranks, card)
    res["gloo_one_card"] = dp_check_full("(b) 2 gloo ranks on one card", ranks, card)
    if torch.cuda.device_count() >= DP_WORLD:
        ranks = dp_ranks("nccl", [f"cuda:{i}" for i in range(DP_WORLD)], parity=False)
        res["nccl_cards"] = dp_check_full(f"(c) 2 NCCL ranks on {DP_WORLD} cards", ranks, card)
    ran = "(a), (b) and (c)" if "nccl_cards" in res else (
        f"(a) and (b); (c) needs {DP_WORLD} cards, the machine has {torch.cuda.device_count()}")
    log(f"[6g] ran {ran}")
    return res


# phase 6h: tensor parallelism.  (a) four gloo ranks share the card as dp 2 x
# tp 2 for phase 6g's parity step with the weights split at the JAX tests'
# threshold (2^12); (b) two gloo ranks as dp 1 x tp 2 run the LN-COCO model
# (ln_coco_256.yml: DF_GEN/DF_DISC, NCH 96, 256², SBERT words D = 768, T =
# 200) in bf16 at a global batch of TP_BATCH, reduced from 256 so that two
# ranks with their whole activations fit in 80 GB, at the JAX rule's
# threshold (2^16); (c) two NCCL ranks, one card each, where there are two
TP = 2
TP_PARITY_MIN = 1 << 12
TP_BATCH = 64


@contextlib.contextmanager
def timed_collectives(out: dict):
    """Host time of every ``all_gather`` / ``all_reduce`` / ``broadcast``
    while the block runs, into ``out`` by name (ms, calls): each call
    synchronizes the card first, so the time is the collective's alone
    (gloo stages a CUDA tensor through the host)."""
    import torch.distributed as dist

    saved = {n: getattr(dist, n) for n in ("all_gather", "all_reduce", "broadcast")}

    def wrap(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + (time.perf_counter() - t0) * 1e3, n + 1)
            return res
        return timed

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def state_bytes(state) -> dict[str, int]:
    """This process's parameter and Adam-moment bytes (G and D)."""
    params = sum(p.numel() * p.element_size() for net in (state.g, state.d)
                 for p in net.parameters())
    moments = sum(v.numel() * v.element_size() for opt in (state.g_opt, state.d_opt)
                  for s in opt.state.values() for k, v in s.items()
                  if k in ("exp_avg", "exp_avg_sq"))
    return {"params": params, "moments": moments}


def tp_parity(mesh, out_dir: Path) -> dict:
    """A rank of phase 6h(a): phase 6g's parity step (fp32, TF32 off, the
    word scores through the damsm kernels) with the state split over the
    model group at ``TP_PARITY_MIN``; saves the whole state it gathers."""
    cfg = dp_parity_cfg()
    state = create_train_state(cfg, torch.float32, mesh.device, seed=0)
    replicate(mesh, state)
    shard_state(state, mesh, TP_PARITY_MIN)
    step = make_train_step(cfg, word_block_elems=0, mesh=mesh)
    metrics = []
    reset_counts()
    for batch, noise in dp_parity_batches(cfg):
        local = shard_batch(mesh, {**batch, "noise": noise})
        m = step(state, local, local.pop("noise"))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = read_counts()
    whole = gather_state(state)
    torch.save({"g": whole["g"], "d": whole["d"]}, out_dir / f"parity_{mesh.rank}.pt")
    return {"metrics": metrics, "launches": launches,
            "split": [len(sharded_tensors(n)) for n in (state.g, state.d)]}


def tp_full(mesh) -> dict:
    """A rank of phase 6h(b): the LN-COCO bf16 step on this rank's rows of a
    global batch of ``TP_BATCH`` (all of them at dp = 1), its large weights
    split over the model group: one step (tens of seconds of gloo), timed,
    counted (launches, peak memory) and with each collective's own time
    (``timed_collectives``)."""
    cfg = ln_cfg({"TRAIN": {"BATCH_SIZE": TP_BATCH}})
    state = create_train_state(cfg, torch.bfloat16, mesh.device, seed=0)
    replicate(mesh, state)
    shard_state(state, mesh)
    step = make_train_step(cfg, mesh=mesh)
    rng = np.random.RandomState(7)
    batch = train_batch(rng, cfg, TP_BATCH, ln_mask)
    noise = rng.randn(TP_BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32)
    local = {k: torch.from_numpy(v).to(mesh.device) for k, v in shard_batch(mesh, batch).items()}
    bs = TP_BATCH // mesh.dp
    noise = torch.from_numpy(noise[mesh.rows(bs)]).to(mesh.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    coll: dict = {}
    t0 = time.perf_counter()
    with timed_collectives(coll):
        metrics = step(state, local, noise)
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    T, D = cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM
    cols = TP_BATCH // mesh.tp
    return {"launches": launches, "step_ms": step_ms, "collectives": coll,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "bytes": state_bytes(state),
            "split": [len(sharded_tensors(n)) for n in (state.g, state.d)],
            "metrics": {k: float(v) for k, v in metrics.items()},
            "col_block": [bs, cols, T, REGIONS, D],
            "col_block_backend": word_scores_backend(bs, cols, T, REGIONS,
                                                     WORD_LOSS_BLOCK_ELEMS, mesh.device),
            "col_block_route": ds.route("fwd", REGIONS, D, torch.bfloat16)}


def tp_one_process(card: str) -> dict:
    """Phase 6h(b)'s yardstick: the same LN-COCO bf16 step in one process at
    the same global batch: its first step (as a rank's) and two more, each
    timed; its peak memory and its parameter and moment bytes."""
    cfg = ln_cfg({"TRAIN": {"BATCH_SIZE": TP_BATCH}})
    state = create_train_state(cfg, torch.bfloat16, "cuda", seed=0)
    step = make_train_step(cfg)
    rng = np.random.RandomState(7)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_batch(rng, cfg, TP_BATCH, ln_mask).items()}
    noises = [torch.from_numpy(rng.randn(TP_BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32)).cuda()
              for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for noise in noises:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res = {"first_step_ms": times[0], "step_ms": statistics.median(times[1:]),
           "step_ms_all": times,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "bytes": state_bytes(state)}
    del state, batch
    torch.cuda.empty_cache()
    return res


def tp_check_full(label: str, ranks: list[dict], one: dict, card: str) -> dict:
    """Phase 6h(b)'s ranks: launches (a rank step's are one process's), the
    column block on the damsm kernels (tensor cores), finite losses; logs
    each rank's step, collectives, memory and bytes beside one process's."""
    want = {**STEP_LAUNCHES}
    for r in ranks:
        full = r["full"]
        if full["launches"] != want:
            raise AssertionError(f"[6h] {label} rank {r['rank']}: launches {full['launches']}, "
                                 f"want {want}")
        if full["col_block_backend"] != "kernel" or full["col_block_route"] != ds.TENSOR_CORES:
            raise AssertionError(f"[6h] {label}: the column block {full['col_block']} is on "
                                 f"{full['col_block_backend']} / {full['col_block_route']}")
        bad = [k for k, v in full["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"[6h] {label} rank {r['rank']}: non-finite {bad}")
        if not all(full["split"]):
            raise AssertionError(f"[6h] {label} rank {r['rank']}: split {full['split']}")
    f0 = ranks[0]["full"]
    coll_ms = [sum(ms for ms, _ in r["full"]["collectives"].values()) for r in ranks]
    res = {"label": label, "backend": ranks[0]["backend"],
           "devices": [r["device"] for r in ranks], "global_batch": TP_BATCH, "tp": TP,
           "rank_step_ms": [r["full"]["step_ms"] for r in ranks],
           "rank_collective_ms": coll_ms,
           "collectives": [r["full"]["collectives"] for r in ranks],
           "peak_mem_gib": [r["full"]["peak_mem_gib"] for r in ranks],
           "bytes": [r["full"]["bytes"] for r in ranks], "split": f0["split"],
           "launches_rank_step": f0["launches"], "col_block": f0["col_block"],
           "metrics": f0["metrics"], "one_process": one}
    b = f0["bytes"]
    log(f"[6h] {label}: LN-COCO bf16, global batch {TP_BATCH}, tp {TP} ({f0['split'][0]} of "
        f"G's and {f0['split'][1]} of D's weights split): a rank's first step "
        + " / ".join(f"{ms:.1f}" for ms in res["rank_step_ms"])
        + f" ms beside one process's {one['first_step_ms']:.1f} (its next two: median "
        f"{one['step_ms']:.1f} ms), with " + " / ".join(f"{ms:.1f}" for ms in coll_ms)
        + " ms of it in the "
        f"collectives ({', '.join(f'{k} {ms:.1f} ms x{n}' for k, (ms, n) in f0['collectives'].items())}"
        f" on rank 0); peak " + " / ".join(f"{g:.2f}" for g in res["peak_mem_gib"])
        + f" GiB a rank beside one process's {one['peak_mem_gib']:.2f}; parameters "
        f"{b['params'] / 2**20:.1f} MiB and Adam moments {b['moments'] / 2**20:.1f} MiB a rank "
        f"beside {one['bytes']['params'] / 2**20:.1f} / {one['bytes']['moments'] / 2**20:.1f} "
        f"MiB; a rank step launches {f0['launches']}, the damsm forward and d_regions on the "
        f"[{f0['col_block'][0]}, {f0['col_block'][1]}] column block (T = {f0['col_block'][2]}, "
        f"R = {f0['col_block'][3]}, D = {f0['col_block'][4]}) on the tensor cores | {card}")
    log(f"[6h] {label} rank 0 metrics: " + ", ".join(f"{k} {v:.4g}"
                                                     for k, v in f0["metrics"].items()))
    return res


def tp_phase(card: str) -> dict:
    """Phase 6h: (a) dp 2 x tp 2 parity against one process; (b) dp 1 x tp 2
    at the LN-COCO model's full width beside one process at the same batch;
    (c) two NCCL ranks, one card each, where the machine has two cards."""
    res = {}
    ranks = dp_ranks("gloo", ["cuda:0"] * 4, parity=True, tp=TP)
    res["parity"] = dp_check_parity(ranks, card, tp=TP)
    ranks = dp_ranks("gloo", ["cuda:0"] * TP, parity=False, tp=TP)
    torch.cuda.empty_cache()
    one = tp_one_process(card)
    res["gloo_one_card"] = tp_check_full(f"(b) {TP} gloo ranks on one card", ranks, one, card)
    if torch.cuda.device_count() >= TP:
        ranks = dp_ranks("nccl", [f"cuda:{i}" for i in range(TP)], parity=False, tp=TP)
        res["nccl_cards"] = tp_check_full(f"(c) {TP} NCCL ranks on {TP} cards", ranks, one,
                                          card)
    ran = "(a), (b) and (c)" if "nccl_cards" in res else (
        f"(a) and (b); (c) needs {TP} cards, the machine has {torch.cuda.device_count()}")
    log(f"[6h] ran {ran}")
    return res


def launch_patterns(launches: dict[str, int]) -> dict[str, int]:
    """A counted run's launches as ``device_kernels``' ``expect``: the
    kernels by name that a whole trace of the same run holds."""
    return {KERNEL_PATTERN[k]: n for k, n in launches.items()}


def df_cfg():
    """``df_gan_damsm.yml`` at 256², full width (no DAMSM weights in the repository)."""
    return cfg_from_dict({"IMG": {"SIZE": 256}, "TEXT": {"ENCODER_DIR": ""}},
                         base=cfg_from_file(str(CFG)))


def own_kernel_times() -> dict[str, float]:
    """Phase 7's ``kernel_ms``: the profiler's device time of the kernels
    alone (without the host's time between launches that ``cuda_ms``
    holds) in one call of a row's launches: the ``fused_affine`` double
    form's backward (14, the vectors in x's dtype), the single form's
    backward and double backward at the concept train step's inputs (40 and
    4, ``concept_rows``), and each attention request's 10, on inputs drawn as
    phase 7 draws them; each trace whole (``device_kernels``)."""

    def own(fn, pattern: str, launches: int) -> float:
        fn()
        return sum(k["ms"] for k in device_kernels(fn, expect={pattern: launches})[0]
                   if re.search(pattern, k["name"]))

    in_cfg = concept_cfg("CONCEPT_INATTN_GEN")
    attn = {"in": [s[:5] for s in attention_shapes(in_cfg, BATCH, "in")],
            "out": [s[:5] for s in attention_shapes(in_cfg, BATCH, "out")]}
    shapes = epilogue_shapes(df_cfg(), BATCH)
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ins = [epilogue_inputs(s, dtype, gen) for s in shapes]
        dys = [torch.randn(s, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last) for s in shapes]
        calls = [(x, tuple(t.to(dtype) for t in m), dy) for (x, m), dy in zip(ins, dys)]
        out[f"fused_affine.double_modulate_lrelu.backward[{DTYPE_NAME[dtype]}]"] = own(
            lambda: [fa._launch_bwd(x, m, dy, 0.2) for x, m, dy in calls],
            KERNEL_PATTERN["fused_affine.backward"], len(calls))
        del ins, dys, calls
        torch.cuda.empty_cache()
        bwd, bwd2 = concept_calls(dtype, gen)
        out[f"fused_affine.modulate_lrelu.backward[{DTYPE_NAME[dtype]}]"] = own(
            lambda: [fa._launch_bwd(x, m, dy, 0.2) for x, m, dy in bwd],
            KERNEL_PATTERN["fused_affine.backward"], len(bwd))
        out[f"fused_affine.modulate_lrelu.double_backward[{DTYPE_NAME[dtype]}]"] = own(
            lambda: [fa._launch_bwd2(*ins2, 0.2) for ins2 in bwd2],
            KERNEL_PATTERN["fused_affine.double_backward"], len(bwd2))
        del bwd, bwd2
        torch.cuda.empty_cache()
        for which, strided in (("in", "planes"), ("out", False)):
            calls = [attention_inputs((*sh, strided), dtype, gen, False) for sh in attn[which]]
            out[f"cross_attention.{which}[{DTYPE_NAME[dtype]}]"] = own(
                lambda: [ca._launch(q, k, v, mask, 1.0) for q, k, v, mask in calls],
                KERNEL_PATTERN["cross_attention.forward"], len(calls))
            calls = attention_bwd_calls(which, dtype, gen)
            out[f"cross_attention.backward.{which}[{DTYPE_NAME[dtype]}]"] = own(
                lambda: [ca._launch_bwd(q, k, k, m, g, 1.0) for q, k, m, g in calls],
                KERNEL_PATTERN["cross_attention.backward"], len(calls))
            del calls
            torch.cuda.empty_cache()
    one = torch.zeros(1, device="cuda")
    out["empty_kernel"] = own(lambda: [one.fill_(1.0) for _ in range(EMPTY_LAUNCHES)],
                              r"(?i)fill", EMPTY_LAUNCHES) / EMPTY_LAUNCHES
    return out


# phase 7: launches of a one-element fill, whose mean device time stands for
# an empty kernel's (the launch floor beside the latency-bound Out rows)
EMPTY_LAUNCHES = 100


def attn_train_shapes(which: str) -> list[tuple[int, int, int, int, int]]:
    """(B, G, N, T, D) of the attention launches of one G pass of the 64²
    word-attention train step (``concept_in_df_gan.yml``, batch 88)."""
    cfg = concept_cfg("CONCEPT_INATTN_GEN", 64, 32)
    return [sh[:5] for sh in attention_shapes(cfg, cfg.TRAIN.BATCH_SIZE, which)]


def attention_bwd_calls(which: str, dtype, gen) -> list[tuple]:
    """(q, k, mask, dO) of the 6 backward launches of one 64² step's G
    update, as the step hands them over on the card: In, the queries as
    planes, the keys [B, G, D, T], dO dense (the sampler's mean); Out, dO a
    slice of the [B, 16, gc + 4] condition's gradient (gc = NOISE_DIM + NEF
    = 356)."""
    calls = []
    for sh in attn_train_shapes(which):
        q, k, _, mask = attention_inputs((*sh, "planes" if which == "in" else False), dtype,
                                         gen, False)
        if which == "in":
            g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        else:
            g = torch.randn((*q.shape[:-1], 356 + q.shape[-1]), generator=gen,
                            device="cuda").to(dtype)[..., 356:]
        calls.append((q, k, mask, g))
    return calls


def epilogue_rows(shapes, errs, launches, own_ms) -> list[dict]:
    """Phase 7, fused_affine double form: the 14 launches of one G forward
    (or backward) per dtype: kernel vs plain vs bound (the single form:
    ``modulation_rows``, ``concept_rows``)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        ins = [epilogue_inputs(s, dtype, gen) for s in shapes]
        dys = [torch.randn(s, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last) for s in shapes]
        es = torch.empty((), dtype=dtype).element_size()
        for nmod in (2,):
            form = "double_modulate_lrelu"
            mods = [tuple(m[: 2 * nmod]) for _, m in ins]
            xs = [x for x, _ in ins]
            vec_bytes = [2 * nmod * s[0] * s[1] * 4 for s in shapes]
            n = [math.prod(s) for s in shapes]
            fwd = {  # x read, out written, the fp32 [B, C] vectors read
                "bytes": [2 * k * es + v for k, v in zip(n, vec_bytes)],
                "ops": [4 * nmod * k for k in n],  # per modulation: mul, add, compare, select
                "kern": lambda: [fa._launch(x, m, 0.2) for x, m in zip(xs, mods)],
                "ref": lambda: [fa._ref(x, m, 0.2) for x, m in zip(xs, mods)],
                "name": f"fused_affine.{form}", "err": errs[dtype][f"fwd{nmod}"],
                "launches": launches[dtype]["fused_affine.forward"],
                "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:71"}
            # the backward gets the vectors in x's dtype, as G's Affine MLPs hand
            # them over in the train step
            bmods = [tuple(t.to(dtype) for t in m) for m in mods]
            bwd = {  # x and dy read, dx written, the vectors read and their sums written
                "bytes": [3 * k * es + 2 * v * es // 4 for k, v in zip(n, vec_bytes)],
                "ops": [10 * nmod * k for k in n],
                "kern": lambda: [fa._launch_bwd(x, m, dy, 0.2)
                                 for x, m, dy in zip(xs, bmods, dys)],
                "ref": lambda: [fa.fused_affine_bwd_ref(x, m, dy, 0.2)
                                for x, m, dy in zip(xs, bmods, dys)],
                "vectors": DTYPE_NAME[dtype],
                "name": f"fused_affine.{form}.backward", "err": errs[dtype][f"bwd{nmod}"],
                "launches": launches[dtype]["fused_affine.backward"],
                "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:71 (the Pallas kernel has "
                            "no backward; this is its gradient)"}
            for spec in (fwd, bwd):
                byte_ms = sum(spec["bytes"]) / HBM_BYTES_PER_S * 1e3
                op_ms = sum(spec["ops"]) / FP32_OPS_PER_S * 1e3
                ms, plain_ms = cuda_ms(spec["kern"], 10), cuda_ms(spec["ref"], 3)
                bound = max(byte_ms, op_ms)
                rows.append({
                    "name": f"{spec['name']}[{DTYPE_NAME[dtype]}]", "route": "cuda",
                    "source": "xmc_gan_tpu_torch/csrc/fused_affine.cu",
                    "replaces": spec["replaces"], "launches": spec["launches"],
                    "max_abs_err": spec["err"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                    "library_ms": None, "roofline_share": bound / ms,
                    "shapes": f"the 14 epilogue inputs of one 256² NCH=32 G pass at batch {BATCH}",
                })
                own = ""
                if "vectors" in spec:
                    rows[-1]["kernel_ms"] = own_ms[rows[-1]["name"]]
                    rows[-1]["vectors"] = spec["vectors"]
                    own = (f", of it {rows[-1]['kernel_ms']:.3f} ms in the kernel "
                           f"({100 * bound / rows[-1]['kernel_ms']:.1f}%; {spec['vectors']} "
                           f"vectors)")
                log(f"[7] {rows[-1]['name']}: 14 launches {ms:.3f} ms (bound {bound:.3f} ms, "
                    f"{100 * bound / ms:.1f}%){own}, plain {plain_ms:.3f} ms")
        del ins, dys
        torch.cuda.empty_cache()
    return rows


def concept_calls(dtype, gen) -> tuple[list, list]:
    """Inputs of the single form's backward at the 40 launches of one
    ``concept_out_df_gan.yml`` step (batch 88; one input a distinct shape)
    and of its double backward at the 4, the vectors in x's dtype as the
    concept G and D hand them over."""
    cfg = concept_train_cfg()
    bs = cfg.TRAIN.BATCH_SIZE
    shapes = concept_step_bwd_shapes(cfg, bs)
    ins = {s: epilogue_inputs(s, dtype, gen) for s in sorted(set(shapes))}
    dys = {s: torch.randn(s, generator=gen, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last) for s in ins}
    bwd = [(ins[s][0], tuple(t.to(dtype) for t in ins[s][1][:2]), dys[s]) for s in shapes]
    bwd2 = [bwd2_inputs(s, dtype, gen) for s in disc_modulation_shapes(cfg, bs)]
    return bwd, bwd2


def concept_rows(errs, launches, own_ms) -> list[dict]:
    """Phase 7, the single form's backward and its double backward at the
    launches of one ``concept_out_df_gan.yml`` train step (phase 6c's
    counted step), per dtype: kernel (and the kernels alone) vs plain vs
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.empty((), dtype=dtype).element_size()
        bwd, bwd2 = concept_calls(dtype, gen)
        specs = [
            {"name": "fused_affine.modulate_lrelu.backward", "calls": bwd,
             # x and dy read, dx written; gamma, beta read and their sums written
             "bytes": [3 * x.numel() * es + 4 * m[0].numel() * es for x, m, _ in bwd],
             "ops": [10 * x.numel() for x, _, _ in bwd],
             "kern": lambda: [fa._launch_bwd(x, m, dy, 0.2) for x, m, dy in bwd],
             "ref": lambda: [fa.fused_affine_bwd_ref(x, m, dy, 0.2) for x, m, dy in bwd],
             "err": errs[dtype]["bwd1"], "launches": launches[dtype]["fused_affine.backward"],
             "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:59 (the Pallas kernel has no "
                         "backward; this is its gradient)",
             "shapes": "the 40 single-form backward inputs of one concept_out_df_gan.yml step "
                       "(batch 88, 64²): D's four 5 times, G's twenty"},
            {"name": "fused_affine.modulate_lrelu.double_backward", "calls": bwd2,
             # x, dy and gx read, g_dy and g_x written; four vectors read, g_gamma written
             "bytes": [5 * c[0].numel() * es + 5 * c[1].numel() * es for c in bwd2],
             "ops": [12 * c[0].numel() for c in bwd2],
             "kern": lambda: [fa._launch_bwd2(*c, 0.2) for c in bwd2],
             "ref": lambda: [fa.fused_affine_bwd2_ref(*c, 0.2) for c in bwd2],
             "err": errs[dtype]["bwd2"],
             "launches": launches[dtype]["fused_affine.double_backward"],
             "replaces": "none: no Pallas kernel (JAX autodiffs its plain epilogue, "
                         "xmc_gan_tpu/ops/fused.py:25, under MAGP); the second derivative of "
                         "xmc_gan_tpu/ops/pallas/fused_affine.py:59",
             "shapes": "the 4 CONCEPT_NETD epilogue inputs of one concept_out_df_gan.yml step "
                       "(batch 88, 128 channels, 32² to 4²)"},
        ]
        for spec in specs:
            byte_ms = sum(spec["bytes"]) / HBM_BYTES_PER_S * 1e3
            op_ms = sum(spec["ops"]) / FP32_OPS_PER_S * 1e3
            ms, plain_ms = cuda_ms(spec["kern"], 10), cuda_ms(spec["ref"], 3)
            bound = max(byte_ms, op_ms)
            name = f"{spec['name']}[{DTYPE_NAME[dtype]}]"
            rows.append({
                "name": name, "route": "cuda", "source": "xmc_gan_tpu_torch/csrc/fused_affine.cu",
                "replaces": spec["replaces"], "launches": spec["launches"],
                "max_abs_err": spec["err"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": None,
                "roofline_share": bound / ms, "kernel_ms": own_ms[name],
                "vectors": DTYPE_NAME[dtype], "shapes": spec["shapes"]})
            log(f"[7] {name}: {len(spec['calls'])} launches {ms:.3f} ms (bound {bound:.3f} ms, "
                f"{100 * bound / ms:.1f}%), of it {own_ms[name]:.3f} ms in the kernel "
                f"({100 * bound / own_ms[name]:.1f}%), plain {plain_ms:.3f} ms; "
                f"{spec['launches']} launches a concept step")
        del bwd, bwd2
        torch.cuda.empty_cache()
    return rows


def epilogue_ln_row(shapes, errs, launches) -> dict:
    """Phase 7, fused_affine backward (double form) at the 14 epilogue
    inputs of the LN-COCO bf16 step (``shapes``, batch 256), the vectors in
    bf16 as that step hands them over: each distinct shape's launch and its
    plain version timed alone (a few GiB each) and summed over the step's
    launches."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    dtype, es = torch.bfloat16, 2
    ms = plain_ms = nbytes = ops = 0.0
    for shape in sorted(set(shapes)):
        n, k = shapes.count(shape), math.prod(shape)
        x, mods = epilogue_inputs(shape, dtype, gen)
        m = tuple(t.to(dtype) for t in mods)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last)
        ms += n * cuda_ms(lambda: fa._launch_bwd(x, m, dy, 0.2), 10)
        plain_ms += n * cuda_ms(lambda: fa.fused_affine_bwd_ref(x, m, dy, 0.2), 1)
        # x and dy read, dx written, the vectors read and their sums written
        nbytes += n * (3 * k * es + 2 * 4 * shape[0] * shape[1] * es)
        ops += n * 20 * k
        del x, mods, m, dy
        torch.cuda.empty_cache()
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    bound = max(byte_ms, op_ms)
    row = {"name": "fused_affine.double_modulate_lrelu.backward[bf16, LN]", "route": "cuda",
           "source": "xmc_gan_tpu_torch/csrc/fused_affine.cu",
           "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:71 (the Pallas kernel has no "
                       "backward; this is its gradient)",
           "launches": launches, "max_abs_err": errs[dtype]["bwd2"], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": None,
           "roofline_share": bound / ms, "vectors": "bf16",
           "shapes": f"the 14 epilogue inputs of one 256² NCH=96 LN-COCO G pass at batch "
                     f"{shapes[0][0]}, each distinct shape timed alone"}
    log(f"[7] {row['name']}: 14 launches {ms:.3f} ms (bound {bound:.3f} ms, "
        f"{100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms")
    return row


def modulation_rows(shapes, errs, launches) -> list[dict]:
    """Phase 7, fused_affine single form (``modulate_lrelu``): the 28
    launches of one 256² concept-DF request at batch 128, per dtype."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        ins = {s: epilogue_inputs(s, dtype, gen) for s in sorted(set(shapes))}
        calls = [(ins[s][0], tuple(ins[s][1][:2])) for s in shapes]
        es = torch.empty((), dtype=dtype).element_size()
        n = [math.prod(s) for s in shapes]
        # x read, out written, the two fp32 [B, C] vectors read
        byte_ms = sum(2 * k * es + 2 * s[0] * s[1] * 4 for k, s in zip(n, shapes)) \
            / HBM_BYTES_PER_S * 1e3
        op_ms = sum(4 * k for k in n) / FP32_OPS_PER_S * 1e3

        def kern():
            for x, m in calls:
                fa._launch(x, m, 0.2)

        def ref():
            for x, m in calls:
                fa._ref(x, m, 0.2)

        ms, plain_ms = cuda_ms(kern, 5), cuda_ms(ref, 2)
        bound = max(byte_ms, op_ms)
        rows.append({
            "name": f"fused_affine.modulate_lrelu[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "xmc_gan_tpu_torch/csrc/fused_affine.cu",
            "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:59",
            "launches": launches[dtype], "max_abs_err": errs[dtype], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": None,
            "roofline_share": bound / ms,
            "shapes": f"the {len(shapes)} modulate_lrelu inputs of one 256² NCH=32 concept-DF "
                      f"G pass at batch {BATCH}",
        })
        log(f"[7] {rows[-1]['name']}: {len(shapes)} launches {ms:.3f} ms (bound {bound:.3f} ms, "
            f"{100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms")
        del ins, calls
        torch.cuda.empty_cache()
    return rows


def attention_rows(in_shapes, out_shapes, errs, launches, own_ms) -> list[dict]:
    """Phase 7, cross_attention: the 10 launches of one 256² INATTN request
    and of one OUTATTN request (batch 128), per dtype, the In queries as
    planes as the sampler hands them over on the card: kernel vs plain vs
    ``scaled_dot_product_attention`` (a yardstick on the same inputs: it
    computes the same function except on fully padded rows, and is used
    nowhere in the port) vs bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.empty((), dtype=dtype).element_size()
        for which, shapes in (("in", in_shapes), ("out", out_shapes)):
            strided = "planes" if which == "in" else False
            ins = {s: attention_inputs((*s, strided), dtype, gen, False)
                   for s in sorted(set(shapes))}
            calls = [ins[s] for s in shapes]
            planned = sorted({ca.kernel_name(ca.plan_for(q, k), dtype, s[4])
                              for s, (q, k, _, _) in zip(shapes, calls)})
            nbytes = ops = 0
            for (b, g, n, t, d), (q, k, v, mask) in zip(shapes, calls):
                words = int((~mask).sum()) * g  # real (row, word) pairs of this launch
                kv = 1 if v is k else 2  # the In path passes the keys as the values
                nbytes += 2 * b * g * n * d * es + kv * b * g * t * d * es + b * t
                # per (query, real word): dot (2D), weighted sum (2D), max, exp, sum
                ops += words * n * (4 * d + 3)
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            op_ms = ops / FP32_OPS_PER_S * 1e3

            def kern():
                for q, k, v, mask in calls:
                    ca._launch(q, k, v, mask, 1.0)

            def ref():
                for q, k, v, mask in calls:
                    ca.masked_cross_attention_ref(q, k, v, mask, 1.0)

            def sdpa():
                for q, k, v, mask in calls:
                    keep = ~mask.reshape(mask.shape[0], *([1] * (q.dim() - 2)), mask.shape[1])
                    torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                                     scale=1.0)

            ms, plain_ms, library_ms = cuda_ms(kern, 5), cuda_ms(ref, 2), cuda_ms(sdpa, 2)
            bound = max(byte_ms, op_ms)
            gen_name = "CONCEPT_INATTN_GEN" if which == "in" else "CONCEPT_OUTATTN_GEN"
            kernel_ms = own_ms[f"cross_attention.{which}[{DTYPE_NAME[dtype]}]"]
            rows.append({
                "name": f"cross_attention.{which}[{DTYPE_NAME[dtype]}]", "route": "cuda",
                "kernel": " ".join(planned),
                "source": "xmc_gan_tpu_torch/csrc/cross_attention.cu",
                "replaces": "xmc_gan_tpu/ops/pallas/cross_attention.py:95 (pallas_call :131)",
                "launches": launches[gen_name][dtype], "max_abs_err": errs[dtype], "ms": ms,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "library_ms": library_ms, "roofline_share": bound / ms,
                "shapes": f"the {len(shapes)} launches of one 256² NCH=32 {gen_name} request at "
                          f"batch {BATCH}: (B, G, N, T, D) {sorted(set(shapes))}"
                          + (", the queries as planes [B, G, D, N] and the keys [B, G, D, T], "
                             "as the sampler hands them over on the card" if strided else ""),
            })
            log(f"[7] {rows[-1]['name']} ({rows[-1]['kernel']}): {len(shapes)} launches "
                f"{ms:.3f} ms, of it {kernel_ms:.3f} ms in the kernels (bound {bound:.4g} ms by "
                f"{rows[-1]['bound_by']}, {100 * bound / ms:.2f}%), plain "
                f"{plain_ms:.3f} ms, scaled_dot_product_attention {library_ms:.3f} ms")
            del ins, calls
            torch.cuda.empty_cache()
    return rows


def attention_bwd_rows(errs, launches, own_ms) -> list[dict]:
    """Phase 7, the cross_attention backward (``attn_bwd_warp``, the kernel
    ``plan_bwd`` names at every shape of the step): the 6 In and the 6 Out
    launches of one 64² word-attention step's G update (batch 88), per
    dtype: kernel vs plain vs SDPA's forward and backward (a yardstick on the
    same inputs, every row with a real word; used nowhere in the port) vs
    bound.  Bytes: q and dO read, dq written, k (passed as v) read once, dk
    and dv written, the mask; operations: per (query, real word) the score
    (2D), dP (2D), dS (3), dq, dk and dv (2D each), the exponential and P."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.empty((), dtype=dtype).element_size()
        for which in ("in", "out"):
            shapes = attn_train_shapes(which)
            calls = attention_bwd_calls(which, dtype, gen)
            nbytes = ops = 0
            for (b, g, n, t, d), (_, _, mask, _) in zip(shapes, calls):
                words = int((~mask).sum()) * g
                nbytes += 3 * b * g * n * d * es + 3 * b * g * t * d * es + b * t
                ops += words * n * (10 * d + 5)
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            op_ms = ops / FP32_OPS_PER_S * 1e3
            planned = sorted({ca.bwd_kernel_name(ca.plan_bwd(*sh, dtype), dtype)
                              for sh in shapes})

            def kern():
                for q, k, m, g in calls:
                    ca._launch_bwd(q, k, k, m, g, 1.0)

            def ref():
                for q, k, m, g in calls:
                    ca.masked_cross_attention_bwd_ref(q, k, k, m, g, 1.0)

            leaves = [(q.detach().requires_grad_(), k.detach().requires_grad_(), m, g)
                      for q, k, m, g in calls]

            def sdpa():
                for q, k, m, g in leaves:
                    keep = ~m.reshape(m.shape[0], *([1] * (q.dim() - 2)), m.shape[1])
                    torch.nn.functional.scaled_dot_product_attention(
                        q, k, k, attn_mask=keep, scale=1.0).backward(g)

            ms, plain_ms, library_ms = cuda_ms(kern, 5), cuda_ms(ref, 2), cuda_ms(sdpa, 2)
            bound = max(byte_ms, op_ms)
            gen_name = "CONCEPT_INATTN_GEN" if which == "in" else "CONCEPT_OUTATTN_GEN"
            name = f"cross_attention.backward.{which}[{DTYPE_NAME[dtype]}]"
            kernel_ms = own_ms[name]
            rows.append({
                "name": name, "route": "cuda", "kernel": " ".join(planned),
                "source": "xmc_gan_tpu_torch/csrc/cross_attention.cu",
                "replaces": "xmc_gan_tpu/ops/pallas/cross_attention.py:95 (pallas_call :131; "
                            "the Pallas kernel has no backward: JAX differentiates its einsum "
                            "chain, models/concept_gan.py:167-179, :299-306)",
                "launches": launches[gen_name][dtype], "max_abs_err": errs[dtype], "ms": ms,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "library_ms": library_ms, "roofline_share": bound / ms,
                "shapes": f"the {len(shapes)} backward launches of one 64² NCH=32 {gen_name} "
                          f"train step at batch 88: (B, G, N, T, D) {sorted(set(shapes))}"
                          + (", the queries as planes, dO dense" if which == "in"
                             else ", dO a slice of the condition's gradient"),
                "library": "scaled_dot_product_attention forward + backward",
            })
            if which == "out":
                rows[-1]["empty_kernel_ms"] = own_ms["empty_kernel"] * len(shapes)
            log(f"[7] {name} ({rows[-1]['kernel']}): {len(shapes)} launches {ms:.3f} ms, of it "
                f"{kernel_ms:.3f} ms in the kernels (bound {bound:.4g} ms by "
                f"{rows[-1]['bound_by']}, {100 * bound / ms:.2f}%), plain {plain_ms:.3f} ms, "
                f"SDPA forward + backward {library_ms:.3f} ms"
                + (f"; {len(shapes)} empty kernels {rows[-1]['empty_kernel_ms']:.4f} ms"
                   if which == "out" else ""))
            del calls, leaves
            torch.cuda.empty_cache()
    return rows


def damsm_rows(errs, launches, dp_launches, row_errs) -> list[dict]:
    """Phase 7, damsm_score: each kernel once at the flagship shape; beside
    it the launches of one data-parallel rank step (``dp_launches``, phase
    6g: bf16 at full width, fp32 the parity step) and the row blocks' errors
    (``row_errs``, phase 3)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    r, w, mask, up = damsm_inputs(DAMSM_FLAGSHIP, gen, False)
    b, bc, R, T, D = DAMSM_FLAGSHIP
    words = int((~mask).sum())  # the products of padded words are not needed
    rows = []
    for cd in (None, torch.bfloat16):
        es = 2 if cd == torch.bfloat16 else 4
        rate = BF16_OPS_PER_S if cd == torch.bfloat16 else FP32_OPS_PER_S
        ins_bytes = (b * R * D + bc * T * D) * es + bc * T + b * bc * 4
        specs = (
            ("forward", 2, ins_bytes, lambda: ds._launch_fwd(r, w, mask, 4.0, 5.0, cd),
             lambda: ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, cd), "314"),
            ("d_regions", 5, ins_bytes + b * R * D * 4,
             lambda: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, cd),
             lambda: ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, cd), "343"),
            ("d_words", 4, ins_bytes + bc * T * D * 4,
             lambda: ds._launch_bwd("dw", r, w, mask, up, 4.0, 5.0, cd),
             lambda: ds._plain_vjp("dw", r, w, mask, up, 4.0, 5.0, cd), "362"),
        )
        for name, dots, nbytes, kern, ref, line in specs:
            which = {"forward": "fwd", "d_regions": "dr", "d_words": "dw"}[name]
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            op_ms = 2 * R * D * dots * b * words / rate * 1e3
            ms, plain_ms = cuda_ms(kern, 5), cuda_ms(ref, 2)
            bound = max(byte_ms, op_ms)
            rows.append({
                "name": f"damsm_score.{name}[{CD_NAME[cd]}]", "route": "cuda",
                "source": "xmc_gan_tpu_torch/csrc/damsm_score.cu",
                "replaces": f"xmc_gan_tpu/ops/pallas/damsm_score.py:{line}",
                "launches": launches[cd][f"damsm_score.{name}"],
                "launches_dp_rank_step": dp_launches[cd][f"damsm_score.{name}"],
                "max_abs_err": errs[cd][name],
                "max_abs_err_row_block": row_errs[cd].get(name),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "library_ms": None, "roofline_share": bound / ms,
                "shapes": f"B=Bc={b}, R={R}, T={T} ({words} real words), D={D}, compute "
                          f"{CD_NAME[cd]}, {route_label(which, R, D, cd)}",
            })
            log(f"[7] {rows[-1]['name']}: {ms:.3f} ms (bound {bound:.3f} ms by "
                f"{rows[-1]['bound_by']}, {100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms; "
                f"{rows[-1]['shapes']}")
    del r, w, mask, up
    torch.cuda.empty_cache()
    return rows


def damsm_ln_rows(errs, launches, launches_in) -> list[dict]:
    """Phase 7, damsm_score at the word shape of each dtype's LN-COCO step
    (``LN_STEP_SHAPES``): each kernel's launch on the sub-captions of real
    words (``LN_WIDTH`` slots) that ``damsm_scores`` hands it
    (``split_captions``), with
    the cotangent the combine hands the backward (2 timed launches), against
    the plain version on the whole captions (caption blocks of
    ``LN_PLAIN_BLOCK``).  Bytes and operations of the function on the whole
    captions, real words only.  ``launches`` per dtype come from the run
    that ``launches_in`` names, that step's."""
    rows = []
    for cd, shape in LN_STEP_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(14)
        r, w, mask, up = ln_damsm_inputs(shape, gen)
        b, bc, R, T, D = shape
        words = int((~mask).sum())
        width = ds.sub_caption_width(R, T, D, cd)
        w_sub, m_sub = ds.split_captions(w, mask, width)
        s = ds._launch_fwd(r, w_sub, m_sub, 4.0, 5.0, cd).view(b, bc, -1).requires_grad_()
        (g_sub,) = torch.autograd.grad(ds.combine_sub_scores(s, 5.0), s, up)
        g_sub = g_sub.reshape(b, -1).contiguous()
        es = 2 if cd == torch.bfloat16 else 4
        rate = BF16_OPS_PER_S if cd == torch.bfloat16 else FP32_OPS_PER_S
        ins_bytes = (b * R * D + bc * T * D) * es + bc * T + b * bc * 4
        specs = (
            ("forward", 2, ins_bytes, lambda: ds._launch_fwd(r, w_sub, m_sub, 4.0, 5.0, cd),
             lambda: ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, cd, LN_PLAIN_BLOCK), "314"),
            ("d_regions", 5, ins_bytes + b * R * D * 4,
             lambda: ds._launch_bwd("dr", r, w_sub, m_sub, g_sub, 4.0, 5.0, cd),
             lambda: ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, cd, LN_PLAIN_BLOCK), "343"),
            ("d_words", 4, ins_bytes + bc * T * D * 4,
             lambda: ds._launch_bwd("dw", r, w_sub, m_sub, g_sub, 4.0, 5.0, cd),
             lambda: ds._plain_vjp("dw", r, w, mask, up, 4.0, 5.0, cd, LN_PLAIN_BLOCK), "362"),
        )
        for name, dots, nbytes, kern, ref, line in specs:
            which = {"forward": "fwd", "d_regions": "dr", "d_words": "dw"}[name]
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            op_ms = 2 * R * D * dots * b * words / rate * 1e3
            ms, plain_ms = cuda_ms(kern, 2), cuda_ms(ref, 2)
            bound = max(byte_ms, op_ms)
            rows.append({
                "name": f"damsm_score.{name}[{CD_NAME[cd]}, LN]", "route": "cuda",
                "source": "xmc_gan_tpu_torch/csrc/damsm_score.cu",
                "replaces": f"xmc_gan_tpu/ops/pallas/damsm_score.py:{line}",
                "launches": launches[cd][f"damsm_score.{name}"], "launches_in": launches_in[cd],
                "max_abs_err": errs[shape, cd][name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "library_ms": None, "roofline_share": bound / ms,
                "shapes": f"B=Bc={b}, R={R}, T={T} as {w_sub.shape[0] // bc} "
                          f"sub-captions of {w_sub.shape[1]} slots ({words} real words), D={D}, "
                          f"compute {CD_NAME[cd]}, {route_label(which, R, D, cd)}",
            })
            log(f"[7] {rows[-1]['name']}: {ms:.3f} ms (bound {bound:.3f} ms by "
                f"{rows[-1]['bound_by']}, {100 * bound / ms:.2f}%), plain {plain_ms:.3f} ms; "
                f"{rows[-1]['shapes']}")
        del r, w, mask, up, w_sub, m_sub, s, g_sub
        torch.cuda.empty_cache()
    return rows


# seconds by phase (``phase``), printed before the ``kernels`` line
PHASE_SECONDS: dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str):
    """Adds the wall seconds of the block to ``PHASE_SECONDS[name]`` and
    prints them."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + dt
        log(f"[t] phase {name}: {dt:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    with phase("1 card"):
        card = card_check()
    with phase("2 build"):
        build_kernels()
    cli_root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cli_train = start_cli_train(cli_root)
    try:
        with phase("3 kernels vs plain"):
            cfg = df_cfg()
            shapes = epilogue_shapes(cfg, BATCH)
            in_cfg = concept_cfg("CONCEPT_INATTN_GEN")
            attn_in = attention_shapes(in_cfg, BATCH, "in")
            attn_out = attention_shapes(in_cfg, BATCH, "out")
            mod_shapes = modulation_shapes(concept_cfg("CONCEPT_IN_DF_GEN"), BATCH)
            ln = ln_cfg()
            fa_errs = check_epilogue(shapes, epilogue_shapes(ln, ln.TRAIN.BATCH_SIZE),
                                     epilogue_shapes(ln, LN_FP32_BATCH))
            mod_errs = check_modulation(sorted(set(mod_shapes)))
            bwd2_errs = check_double_backward(concept_train_cfg())
            ds_errs = check_damsm()
            row_errs = check_damsm_row_blocks()
            col_errs = check_damsm_col_blocks()
            ln_errs = check_damsm_ln()
            check_damsm_streamed()
            ca_errs = check_attention(attn_in)
            ca_bwd_errs = check_attention_bwd(attn_train_shapes("in"), attn_train_shapes("out"))
            torch.cuda.empty_cache()
        with phase("5e cli train, the rest of it after phase 3"):
            cli_res = finish_cli_train(*cli_train, card)
    finally:
        if cli_train[0].poll() is None:  # phase 3 failed: stop the process
            cli_train[0].kill()
            cli_train[0].wait()
        shutil.rmtree(cli_root, ignore_errors=True)
    with phase("7 own kernel times"):
        own_ms = own_kernel_times()
    log("[7] the kernels' own device ms (profiler, run after phase 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in own_ms.items()))
    torch.cuda.empty_cache()

    with phase("4 card vs CPU"):
        g_cpu = make_generator(cfg, device="cpu")
        sd = perturbed_state_dict(g_cpu, seed=0)
        g_cpu.load_state_dict(sd, strict=True)
        check_slice_against_cpu(cfg, g_cpu)
        del g_cpu
        damsm_two_steps = {"damsm_score.forward": 4, "damsm_score.d_regions": 4}
        check_train_against_cpu(cfg_from_dict(SLICE_CFG), "train slice", prefix_mask,
                                damsm_two_steps)
        check_concepts_against_cpu()
        check_train_against_cpu(
            ln_cfg({"IMG": {"SIZE": 64}, "TRAIN": {"NCH": 8, "BATCH_SIZE": 4}}),
            "LN-COCO step (fp32, NCH=8, 64², batch 4, T=200, D=768), 2 steps", ln_mask,
            damsm_two_steps)
        small_concept = concept_train_cfg({"TRAIN": {"NCH": 8, "BATCH_SIZE": 4}})
        check_train_against_cpu(
            small_concept, "concept_out_df_gan step (fp32, NCH=8, 64², batch 4), 2 steps",
            prefix_mask, {k: 2 * n for k, n in concept_step_launches(small_concept).items()})
        for name in ATTN_GENS:
            wcfg = concept_cfg(name, 64, 8)
            per = attn_step_launches(wcfg, name)
            check_train_against_cpu(wcfg, f"{name} step (fp32, NCH=8, 64², batch 4), 2 steps",
                                    prefix_mask, {k: 2 * n for k, n in per.items()})
        check_train_against_cpu(cfg_from_dict({"TRAIN": {"ENCODER_LOSS": {"VGG": True}}},
                                              base=cfg_from_dict(SLICE_CFG)),
                                "train slice with ENCODER_LOSS.VGG (random VGG-19)", prefix_mask,
                                damsm_two_steps)

    with phase("5 serving"):
        runs = {dtype: serve(cfg, sd, dtype) for dtype in (torch.float32, torch.bfloat16)}
        diff = (runs[torch.float32].pop("img") - runs[torch.bfloat16].pop("img")).abs()
        log(f"[5] bf16 vs fp32 images: max abs diff {diff.max().item():.4f}, "
            f"mean {diff.mean().item():.5f}")
        del diff
        torch.cuda.empty_cache()
        concept_runs, sds = {}, {"DF_GEN": sd}
        for i, name in enumerate(CONCEPT_GENS):
            ccfg = concept_cfg(name)
            c_sd = sds[name] = perturbed_state_dict(make_generator(ccfg, device="cpu"),
                                                    seed=30 + i)
            concept_runs[name] = {dtype: serve(ccfg, c_sd, dtype, name)
                                  for dtype in (torch.float32, torch.bfloat16)}
            diff = (concept_runs[name][torch.float32].pop("img")
                    - concept_runs[name][torch.bfloat16].pop("img")).abs()
            log(f"[5] {name} bf16 vs fp32 images: max abs diff {diff.max().item():.4f}, "
                f"mean {diff.mean().item():.5f}")
            del diff
            torch.cuda.empty_cache()
    with phase("5c SENT serving"):
        sent_runs = serve_sent(card, (torch.float32, torch.bfloat16))
    with phase("5d exported"):
        exported = serve_exported(card, sds)
    with phase("5e SBERT"):
        sbert = {**sbert_encoding(card), **cli_res}

    flagship = cfg_from_dict(TRAIN_OVERRIDES)
    with phase("6 training steps"):
        trains = {torch.bfloat16: train(flagship, "flagship_word", torch.bfloat16, 2, 5,
                                        prefix_mask),
                  torch.float32: train(flagship, "flagship_word", torch.float32, 1, 2,
                                       prefix_mask)}
        # the LN steps take seconds: their counted step is their warm-up
        ln_train = train(ln_cfg(), "LN-COCO", torch.bfloat16, 0, 2, ln_mask)
        ln_train32 = train(ln_cfg({"TRAIN": {"BATCH_SIZE": LN_FP32_BATCH}}), "LN-COCO",
                           torch.float32, 0, 1, ln_mask)
    with phase("6b flagship loop"):
        loop = train_loop(card, trains[torch.bfloat16]["step_ms"])
    with phase("6c concept loops"):
        concept_loops = {dtype: concept_loop(card, dtype)
                         for dtype in (torch.bfloat16, torch.float32)}
    with phase("6d LN loop"):
        ln_fit = ln_loop(card, ln_train["step_ms"])
    with phase("6e attention loops"):
        attn_loops = {name: {dtype: attn_loop(card, name, dtype)
                             for dtype in (torch.bfloat16, torch.float32)} for name in ATTN_GENS}
    with phase("6f VGG"):
        vgg_train = train(cfg_from_dict({"TRAIN": {"ENCODER_LOSS": {"VGG": True}}},
                                        base=flagship),
                          "flagship_word + VGG", torch.bfloat16, 2, 3, prefix_mask)
    log(f"[6f] flagship_word bf16 step with the VGG loss {vgg_train['step_ms']:.1f} ms beside "
        f"phase 6's {trains[torch.bfloat16]['step_ms']:.1f} ms without it; the VGG "
        f"{100 * vgg_train['vgg_share']:.1f}% of the step's device time | {card}")
    with phase("6g data parallel"):
        dp = dp_phase(card, trains[torch.bfloat16]["step_ms"])
    with phase("6h tensor parallel"):
        tp = tp_phase(card)
    t7 = time.perf_counter()
    step_launches = {dtype: r["launches"] for dtype, r in trains.items()}
    req = {name: {dtype: r["launches"] for dtype, r in rs.items()}
           for name, rs in concept_runs.items()}
    kernels = epilogue_rows(shapes, fa_errs, step_launches, own_ms)
    kernels += concept_rows(bwd2_errs, {d: r["launches_step"] for d, r in concept_loops.items()},
                            own_ms)
    kernels += modulation_rows(
        mod_shapes, mod_errs,
        {d: req["CONCEPT_IN_DF_GEN"][d]["fused_affine.forward"] for d in req["CONCEPT_IN_DF_GEN"]})
    kernels.append(epilogue_ln_row(epilogue_shapes(ln, ln.TRAIN.BATCH_SIZE), fa_errs,
                                   ln_train["launches"]["fused_affine.backward"]))
    parity_step = {k: n // DP_PARITY_STEPS
                   for k, n in dp["parity"]["launches_rank_2_steps"].items()}
    kernels += damsm_rows(ds_errs, {None: step_launches[torch.float32],
                                    torch.bfloat16: step_launches[torch.bfloat16]},
                          {None: parity_step,
                           torch.bfloat16: dp["gloo_one_card"]["launches_rank_step"]}, row_errs)
    kernels += damsm_ln_rows(ln_errs, {None: ln_train32["launches"],
                                       torch.bfloat16: ln_train["launches"]},
                             {None: "phase 6: one full-width LN-COCO fp32 step at batch "
                                    f"{LN_FP32_BATCH}",
                              torch.bfloat16: "phase 6: one full-width LN-COCO bf16 step"})
    # the tensor-parallel rank step's launches (phase 6h(b), the [64, 32]
    # column block) and the column blocks' errors (phase 3) beside the LN rows
    for row in kernels:
        if row["name"] in ("damsm_score.forward[bf16, LN]", "damsm_score.d_regions[bf16, LN]"):
            which = row["name"].split("[")[0]
            row["launches_tp_rank_step"] = tp["gloo_one_card"]["launches_rank_step"][which]
            row["max_abs_err_col_block"] = col_errs[
                (TP_BATCH, TP_BATCH // TP, "bf16")][which.split(".")[1]]
    kernels += attention_bwd_rows(
        ca_bwd_errs, {name: {d: r["launches_step"]["cross_attention.backward"]
                             for d, r in attn_loops[name].items()} for name in ATTN_GENS},
        own_ms)
    kernels += attention_rows(
        [s[:5] for s in attn_in], [s[:5] for s in attn_out], ca_errs,
        {name: {d: r["cross_attention.forward"] for d, r in req[name].items()}
         for name in ("CONCEPT_INATTN_GEN", "CONCEPT_OUTATTN_GEN")}, own_ms)
    # the exported requests' launches (phase 5d) beside the eager path's
    for r in exported:
        which = {"DF_GEN": "fused_affine.double_modulate_lrelu", "CONCEPT_INATTN_GEN":
                 "cross_attention.in", "CONCEPT_OUTATTN_GEN": "cross_attention.out"}[r["generator"]]
        row = next(k for k in kernels if k["name"] == f"{which}[{r['dtype']}]")
        row["launches_exported"] = sum(r["launches"].values())
    # the new SENT captions' requests (phase 5e)
    for r in sbert["serving"]:
        row = next(k for k in kernels
                   if k["name"] == f"fused_affine.double_modulate_lrelu[{r['dtype']}]")
        row["launches_new_sent_captions"] = sum(r["launches"].values())
    log(json.dumps({"card": card, "serving": list(runs.values()),
                    "concept_serving": [r for rs in concept_runs.values() for r in rs.values()],
                    "sent_serving": sent_runs, "exported_serving": exported,
                    "sbert_encoding": sbert,
                    "training": [*trains.values(), ln_train, ln_train32],
                    "training_loop": loop, "concept_training_loop": list(concept_loops.values()),
                    "ln_training_loop": ln_fit,
                    "attention_training_loop": [r for rs in attn_loops.values()
                                                for r in rs.values()],
                    "vgg_training": vgg_train, "data_parallel": dp,
                    "tensor_parallel": tp}))
    PHASE_SECONDS["7 kernel rows"] = time.perf_counter() - t7
    log("[t] seconds by phase | " + card + " | " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dp_rank_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
