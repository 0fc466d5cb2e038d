#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then non-zero):

1. Card check: CUDA must be available; prints the card's name and power limit.
2. Build: compiles both CUDA sources (``xmc_gan_tpu_torch/csrc``), one
   ``nvcc`` each, started together, and prints the build time.
3. Each kernel against its plain PyTorch version on the card: the
   ``fused_affine`` forward and backward (both forms, fp32 and bf16) at the
   14 epilogue shapes of the 256², NCH=32, batch-128 generator plus a ragged
   one; the ``damsm_score`` forward, d_regions and d_words at the flagship
   word-loss shape (B = Bc = 128, R = 256, T = 20, D = 256) and at a ragged
   one (R = 50, T = 7, D = 48, one all-padded caption), compute dtype fp32
   and bf16.
4. The serving slice (DAMSM encoder + NetG at 256², NCH=32, batch 4) and the
   train slice (NCH=8, 64², batch 4, WORD + SPEC_NORM + MAGP, two steps) on
   the card against the CPU, fp32 with TF32 off, on the same seeded,
   perturbed weights and numpy inputs; the card's word scores go through the
   damsm kernels (``word_block_elems=0``).
5. Full-width serving: random caption ids (batch 128, T=20, mixed lengths)
   -> ``make_encode_fn`` -> ``make_sample_fn``, fp32 and bf16; checks the
   kernel launch count of that run (14 per G forward), that the images are
   finite and in [-1, 1], and prints images/s, peak memory, and where one
   request's device time goes (``torch.profiler``, by kernel category).
6. Full-width training: the ``flagship_word`` step (DF-GAN G + D at 256²,
   NCH=32, batch 128, RMIS, MAGP, sentence/image/word-region InfoNCE) from
   ``create_train_state`` + ``make_train_step``, bf16 activations (2 warm-up
   and 10 timed steps) and fp32 with TF32 off (1 warm-up, 3 timed); checks
   each kernel's launches in one step (fused_affine 28 forward / 14
   backward, damsm 2 forward / 2 d_regions / 0 d_words) and that the losses
   are finite; prints images/s (median), peak memory and one step's device
   time by kernel category.
7. Kernel times against their bounds (CUDA events over repeated launches),
   as one ``{"kernels": [...]}`` line.
8. Last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  The weights are random (from
fixed seeds): no trained checkpoint is in the repository.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.models.df_gan import epilogue_shapes
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.train import (
    create_train_state,
    make_generator,
    make_sample_fn,
    make_train_step,
)
from xmc_gan_tpu_torch.trainer import make_encode_fn

REPO = Path(__file__).resolve().parent
CFG = REPO / "xmc_gan_tpu" / "cfg" / "df_gan_damsm.yml"  # the YAML schema file only
BATCH = 128  # serving and training batch (docs/SERVING.md; the flagship step)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
BF16_ULP = 2.0 ** -7
COUNTS = {"fused_affine.forward": fa.FORWARD, "fused_affine.backward": fa.BACKWARD,
          "damsm_score.forward": ds.FORWARD, "damsm_score.d_regions": ds.D_REGIONS,
          "damsm_score.d_words": ds.D_WORDS}
# launches of one flagship_word train step
STEP_LAUNCHES = {"fused_affine.forward": 28, "fused_affine.backward": 14,
                 "damsm_score.forward": 2, "damsm_score.d_regions": 2,
                 "damsm_score.d_words": 0}
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
# damsm kernels vs plain.  fp32: the same math in another summation order:
# scores to 1e-5 (the all-padded caption's -2e29 by the relative part), the
# gradients to 1e-5 of their largest magnitude.  bf16: both round the
# products' operands to bf16, but the attention weights a and the cotangents
# come from fp32 values computed in another order, so an operand can round
# to the neighbouring bf16 value: scores to 2^-12 absolute, gradients to one
# bf16 ulp (2^-7) of their largest magnitude.
DAMSM_TOL = {None: {"score": 1e-5, "grad_scale": 1e-5},
             torch.bfloat16: {"score": 2.0 ** -12, "grad_scale": BF16_ULP}}
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
    """One nvcc per source, all started together."""
    errors: list[BaseException] = []

    def load(lib):
        try:
            lib.load()
        except BaseException as e:  # re-raised below, after every build has ended
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=(lib,)) for lib in (fa.KERNEL, ds.KERNEL)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    dt = time.perf_counter() - t0
    log(f"[2] built {fa.KERNEL.source} and {ds.KERNEL.source} in {dt:.2f} s")
    return dt


def perturbed_state_dict(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Every parameter replaced by a seeded value that keeps activations
    O(1) with non-zero gates (a fresh model's zero gates would hide the
    residual branches): weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2),
    affine outputs gamma ~ 1 +- 0.1 and beta ~ 0 +- 0.1, gates ~ U(0.5,
    1.5).  Spectral-norm vectors (``weight_u``/``weight_v``) are kept."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(("weight_u", "weight_v")):
            out[name] = t.clone()
            continue
        if name.endswith(".gamma"):
            v = rng.uniform(0.5, 1.5, shape)
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


def train_batch(rng, batch: int, size: int, emb: int, T: int) -> dict:
    """uint8 images, sentence/word embeddings and a word mask (True =
    padded; every caption keeps at least one word), as numpy arrays."""
    lens = rng.randint(1, T + 1, batch)
    return {
        "imgs": rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
        "sent_embs": rng.randn(batch, emb).astype(np.float32),
        "words_embs": rng.randn(batch, T, emb).astype(np.float32),
        "mask": np.arange(T)[None, :] >= lens[:, None],
    }


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events), after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn) -> tuple[list[dict], float, float]:
    """The CUDA kernels that one call of ``fn`` runs, from a ``torch.profiler``
    (CUPTI) trace of it taken after one warm-up call: ``[{"name", "ms",
    "stream", "op", "dims"}]`` in launch order (``op`` and ``dims``: the
    PyTorch op that launched the kernel and its input shapes), the device's
    busy ms (the union of the kernels' intervals: cuDNN runs some kernels on
    side streams, so their sum can exceed it), and the call's wall ms under
    the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = {e["args"].get("External id"): e for e in events if e.get("cat") == "cpu_op"}
    launch_op = {e["args"].get("correlation"): ops.get(e["args"].get("External id"))
                 for e in events if e.get("cat") == "cuda_runtime"}
    kernels, spans = [], []
    for e in sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"]):
        op = launch_op.get(e["args"].get("correlation")) or {}
        kernels.append({"name": e["name"], "ms": e["dur"] / 1e3, "stream": e["args"].get("stream"),
                        "op": op.get("name"), "dims": op.get("args", {}).get("Input Dims")})
        spans.append((e["ts"], e["ts"] + e["dur"]))
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time on this machine")
    busy_us, end = 0.0, -math.inf
    for start, stop in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return kernels, busy_us / 1e3, wall_ms


def kernel_category(name: str) -> str:
    n = name.lower()
    if "damsm" in n or "sum_splits" in n:
        return "damsm_score"
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


def damsm_inputs(shape, gen, allpad: bool):
    b, bc, R, T, D = shape
    r = torch.nn.functional.normalize(torch.randn(b, R, D, generator=gen, device="cuda"), dim=-1)
    w = torch.nn.functional.normalize(torch.randn(bc, T, D, generator=gen, device="cuda"), dim=-1)
    lens = torch.randint(1, T + 1, (bc,), generator=gen, device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    if allpad:
        mask[1] = True
    up = torch.randn(b, bc, generator=gen, device="cuda")
    return r, w, mask, up


def check_epilogue(shapes) -> dict:
    """Phase 3, fused_affine: forward and backward, both forms, both dtypes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ragged = (3, 13, 7, 9)  # C not a multiple of the vector width, H*W odd
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = KERNEL_TOL[dtype]
        worst = {"fwd1": 0.0, "fwd2": 0.0, "bwd1": 0.0, "bwd2": 0.0}
        for shape in [*shapes, ragged]:
            x, mods = epilogue_inputs(shape, dtype, gen)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
                memory_format=torch.channels_last)
            for nmod, kern, ref in ((1, fa.modulate_lrelu_kernel, fa.modulate_lrelu_ref),
                                    (2, fa.double_modulate_lrelu_kernel,
                                     fa.double_modulate_lrelu_ref)):
                m = tuple(mods[: 2 * nmod])
                got = kern(x, *m).float()
                want = ref(x, *m).float()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
                worst[f"fwd{nmod}"] = max(worst[f"fwd{nmod}"], (got - want).abs().max().item())
                got_b = fa._launch_bwd(x, m, dy, 0.2)
                want_b = fa.fused_affine_bwd_ref(x, m, dy, 0.2)
                torch.cuda.synchronize()
                torch.testing.assert_close(got_b[0].float(), want_b[0].float(),
                                           rtol=BWD_TOL["dx_rtol"] if dtype == torch.float32
                                           else BF16_ULP, atol=BWD_TOL["dx_atol"])
                for g_, w_ in zip(got_b[1:], want_b[1:]):
                    torch.testing.assert_close(
                        g_, w_, rtol=BWD_TOL["sum_rtol"],
                        atol=BWD_TOL["sum_scale"] * w_.abs().max().item())
                worst[f"bwd{nmod}"] = max(worst[f"bwd{nmod}"], max(
                    (g_.float() - w_.float()).abs().max().item() for g_, w_ in zip(got_b, want_b)))
            del x, mods, dy, got, want, got_b, want_b
        errs[dtype] = worst
        log(f"[3] fused_affine {DTYPE_NAME[dtype]}: max_abs_err forward 1-mod {worst['fwd1']:.3g}, "
            f"2-mod {worst['fwd2']:.3g}; backward 1-mod {worst['bwd1']:.3g}, 2-mod "
            f"{worst['bwd2']:.3g} over {len(shapes)} path shapes + ragged {ragged} (forward "
            f"tolerance rtol {rtol:g} atol {atol:g}; backward: {BWD_TOL})")
    return errs


def check_damsm() -> dict:
    """Phase 3, damsm_score: forward, d_regions, d_words against the plain
    version and its autograd, at the flagship and a ragged shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for cd in (None, torch.bfloat16):
        tol = DAMSM_TOL[cd]
        worst = {"forward": 0.0, "d_regions": 0.0, "d_words": 0.0}
        for shape, allpad in ((DAMSM_FLAGSHIP, False), (DAMSM_RAGGED, True)):
            r, w, mask, up = damsm_inputs(shape, gen, allpad)
            got = ds._launch_fwd(r, w, mask, 4.0, 5.0, cd)
            want = ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, cd)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=tol["score"])
            if allpad and not bool(torch.isfinite(got).all()):
                raise AssertionError("all-padded caption gave a non-finite score")
            worst["forward"] = max(worst["forward"], (got - want).abs().max().item())
            for which, key in (("dr", "d_regions"), ("dw", "d_words")):
                got_g = ds._launch_bwd(which, r, w, mask, up, 4.0, 5.0, cd)
                want_g = ds._plain_vjp(which, r, w, mask, up, 4.0, 5.0, cd)
                torch.cuda.synchronize()
                torch.testing.assert_close(got_g, want_g, rtol=0,
                                           atol=tol["grad_scale"] * want_g.abs().max().item())
                worst[key] = max(worst[key], (got_g - want_g).abs().max().item())
            del r, w, mask, up, got, want, got_g, want_g
        errs[cd] = worst
        log(f"[3] damsm_score compute {CD_NAME[cd]}: max_abs_err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + f" at {DAMSM_FLAGSHIP} and ragged "
            f"{DAMSM_RAGGED} with an all-padded caption (tolerance {tol})")
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


def check_train_against_cpu() -> None:
    """Phase 4b: two fp32 train steps (NCH=8, 64², batch 4, WORD + SPEC_NORM
    + MAGP) on the card and on the CPU from the same perturbed weights."""
    cfg = cfg_from_dict({
        "TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": 16, "HE_INIT": True, "RMIS_LOSS": True,
                  "MAGP": True, "ENCODER_LOSS": {"SENT": True, "DISC": True, "B_GLOBAL": True,
                                                 "WORD": True},
                  "SMOOTH": {"GLOBAL": 0.0}},
        "IMG": {"SIZE": 64}, "TEXT": {"EMBEDDING_DIM": 32, "MAX_LENGTH": 7},
        "DISC": {"SPEC_NORM": True, "IMG_MATCH": True}})
    cpu = create_train_state(cfg, device="cpu", seed=3)
    g_sd, d_sd = perturbed_state_dict(cpu.g, 4), perturbed_state_dict(cpu.d, 5)
    cpu = create_train_state(cfg, device="cpu", g_state_dict=g_sd, d_state_dict=d_sd)
    card = create_train_state(cfg, device="cuda", g_state_dict=g_sd, d_state_dict=d_sd)
    step_cpu = make_train_step(cfg)
    step_card = make_train_step(cfg, word_block_elems=0)  # turns TF32 off
    rng = np.random.RandomState(6)
    reset_counts()
    for k in range(2):
        batch = train_batch(rng, 4, 64, 32, 7)
        noise = rng.randn(4, 16).astype(np.float32)
        m_cpu, m_card = step_cpu(cpu, batch, noise), step_card(card, batch, noise)
        for key, v in m_cpu.items():
            a, b = float(m_card[key]), float(v)
            if not abs(a - b) <= TRAIN_TOL["metric"] * max(1.0, abs(b)):
                raise AssertionError(f"train slice step {k} {key}: card {a} vs CPU {b}")
    counts = read_counts()
    if counts["damsm_score.forward"] != 4 or counts["damsm_score.d_regions"] != 4:
        raise AssertionError(f"train slice on the card did not go through the damsm kernels: "
                             f"{counts}")
    lr = max(cfg.TRAIN.OPT.G_LR, cfg.TRAIN.OPT.D_LR)
    n_all = n_close = 0
    worst_uv = worst = 0.0
    for net_cpu, net_card in ((cpu.g, card.g), (cpu.d, card.d)):
        sd_card = net_card.state_dict()
        for name, v in net_cpu.state_dict().items():
            err = (sd_card[name].cpu() - v).abs()
            if name.endswith(("weight_u", "weight_v")):
                worst_uv = max(worst_uv, err.max().item())
                continue
            worst = max(worst, err.max().item())
            n_all += err.numel()
            n_close += int((err <= TRAIN_TOL["param_lr_frac"] * lr).sum())
    share = n_close / n_all
    log(f"[4] train slice card vs CPU, 2 steps: metrics within {TRAIN_TOL['metric']:g}; "
        f"params: {share:.6f} of {n_all} within {TRAIN_TOL['param_lr_frac'] * lr:.2g}, worst "
        f"{worst:.3g} (bound {4 * lr:.2g}); u/v worst {worst_uv:.3g}; damsm launches {counts}")
    if share < TRAIN_TOL["param_share"] or worst > 4 * lr or worst_uv > TRAIN_TOL["uv"]:
        raise AssertionError("train slice: card and CPU parameters differ beyond the tolerance")


def serve(cfg, sd, dtype) -> dict:
    """Phase 5 for one dtype: encode + sample at batch 128, full width."""
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
    label = DTYPE_NAME[dtype]
    reset_counts()  # the serving path's run: counts from here
    img = request()
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["fused_affine.forward"] != 14 or sum(launches.values()) != 14:
        raise AssertionError(f"{label}: launches {launches}, want 14 fused_affine forward "
                             "(2 per GBlock x 7 at 256²) and nothing else")
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
    kernels, busy_ms, wall_ms = device_kernels(request)
    device_ms = sum(k["ms"] for k in kernels)
    res = {"dtype": label, "launches": launches["fused_affine.forward"],
           "g_ms": g_s * 1e3, "request_ms": req_s * 1e3,
           "img_per_s_g": BATCH / g_s, "img_per_s_request": BATCH / req_s,
           "peak_mem_gib": peak, "request_kernel_ms": device_ms, "request_busy_ms": busy_ms,
           "profiled_request_ms": wall_ms, "device_busy_share": busy_ms / wall_ms,
           "device_ms_by_category": by_category(kernels), "img": img}
    log(f"[5] serve {label} bs{BATCH} 256²: launches {launches['fused_affine.forward']}, G forward "
        f"{res['g_ms']:.2f} ms ({res['img_per_s_g']:.1f} img/s), encode+G "
        f"{res['request_ms']:.2f} ms ({res['img_per_s_request']:.1f} img/s), peak memory "
        f"{peak:.2f} GiB (median of 5)")
    log(f"[5] {label} one request on the device: {device_ms:.2f} ms of kernels, busy "
        f"{busy_ms:.2f} of {wall_ms:.2f} ms (share {res['device_busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in res["device_ms_by_category"].items()))
    return res


def train(dtype, warmup: int, timed: int) -> dict:
    """Phase 6 for one dtype: the full-width flagship_word train step."""
    cfg = cfg_from_dict(TRAIN_OVERRIDES)
    state = create_train_state(cfg, dtype, "cuda", seed=0)
    step = make_train_step(cfg)  # turns TF32 off
    rng = np.random.RandomState(7)
    batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
        rng, BATCH, cfg.IMG.SIZE, cfg.TEXT.EMBEDDING_DIM, cfg.TEXT.MAX_LENGTH).items()}
    noises = [torch.from_numpy(rng.randn(BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32)).cuda()
              for _ in range(warmup + timed + 2)]
    label = DTYPE_NAME[dtype]
    for i in range(warmup):
        step(state, batch, noises[i])
    torch.cuda.synchronize()
    reset_counts()  # the training path's run: one step, counts from here
    metrics = step(state, batch, noises[warmup])
    torch.cuda.synchronize()
    launches = read_counts()
    if launches != STEP_LAUNCHES:
        raise AssertionError(f"{label} train step: launches {launches}, want {STEP_LAUNCHES}")
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v.float()).all())]
    if bad:
        raise AssertionError(f"{label} train step: non-finite {bad}")
    torch.cuda.reset_peak_memory_stats()
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
    kernels, busy_ms, wall_ms = device_kernels(lambda: step(state, batch, noises[-1]))
    device_ms = sum(k["ms"] for k in kernels)
    res = {"dtype": label, "launches": launches, "step_ms": step_s * 1e3,
           "step_ms_all": [t * 1e3 for t in times], "img_per_s": BATCH / step_s,
           "peak_mem_gib": peak, "step_kernel_ms": device_ms, "step_busy_ms": busy_ms,
           "profiled_step_ms": wall_ms, "device_busy_share": busy_ms / wall_ms,
           "device_ms_by_category": by_category(kernels),
           "top_kernels": top_kernels(kernels, 10),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    log(f"[6] train {label} flagship_word bs{BATCH} 256²: step {res['step_ms']:.1f} ms "
        f"({res['img_per_s']:.1f} img/s, median of {timed}), peak memory {peak:.2f} GiB, "
        f"launches {launches}")
    log(f"[6] train {label} one step on the device: {device_ms:.1f} ms of kernels, busy "
        f"{busy_ms:.1f} of {wall_ms:.1f} ms (share {res['device_busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in res["device_ms_by_category"].items()))
    for g in res["top_kernels"]:
        log(f"[6] train {label} top: {g['ms']:.1f} ms, {g['launches']} launches on streams "
            f"{','.join(g['streams'])}: {g['kernel']} <- {g['op']} {g['dims']}")
    log(f"[6] train {label} last metrics: " + ", ".join(
        f"{k} {v:.4g}" for k, v in res["metrics"].items()))
    del state, batch
    torch.cuda.empty_cache()
    return res


def epilogue_rows(shapes, errs, launches) -> list[dict]:
    """Phase 7, fused_affine: the 14 launches of one G forward (or backward)
    per form and dtype: kernel vs plain vs bound."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        ins = [epilogue_inputs(s, dtype, gen) for s in shapes]
        dys = [torch.randn(s, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last) for s in shapes]
        es = torch.empty((), dtype=dtype).element_size()
        for nmod in (2, 1):
            form = "double_modulate_lrelu" if nmod == 2 else "modulate_lrelu"
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
                "launches": launches[dtype]["fused_affine.forward"] if nmod == 2 else 0,
                "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:"
                            + ("71" if nmod == 2 else "59")}
            bwd = {  # x and dy read, dx written, the vectors read and their sums written
                "bytes": [3 * k * es + 2 * v for k, v in zip(n, vec_bytes)],
                "ops": [10 * nmod * k for k in n],
                "kern": lambda: [fa._launch_bwd(x, m, dy, 0.2)
                                 for x, m, dy in zip(xs, mods, dys)],
                "ref": lambda: [fa.fused_affine_bwd_ref(x, m, dy, 0.2)
                                for x, m, dy in zip(xs, mods, dys)],
                "name": f"fused_affine.{form}.backward", "err": errs[dtype][f"bwd{nmod}"],
                "launches": launches[dtype]["fused_affine.backward"] if nmod == 2 else 0,
                "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:"
                            + ("71" if nmod == 2 else "59")
                            + " (the Pallas kernel has no backward; this is its gradient)"}
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
                log(f"[7] {rows[-1]['name']}: 14 launches {ms:.3f} ms (bound {bound:.3f} ms, "
                    f"{100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms")
        del ins, dys
        torch.cuda.empty_cache()
    return rows


def damsm_rows(errs, launches) -> list[dict]:
    """Phase 7, damsm_score: each kernel once at the flagship shape."""
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
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            op_ms = 2 * R * D * dots * b * words / rate * 1e3
            ms, plain_ms = cuda_ms(kern, 5), cuda_ms(ref, 2)
            bound = max(byte_ms, op_ms)
            rows.append({
                "name": f"damsm_score.{name}[{CD_NAME[cd]}]", "route": "cuda",
                "source": "xmc_gan_tpu_torch/csrc/damsm_score.cu",
                "replaces": f"xmc_gan_tpu/ops/pallas/damsm_score.py:{line}",
                "launches": launches[cd][f"damsm_score.{name}"],
                "max_abs_err": errs[cd][name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "library_ms": None, "roofline_share": bound / ms,
                "shapes": f"B=Bc={b}, R={R}, T={T} ({words} real words), D={D}, compute "
                          f"{CD_NAME[cd]}",
            })
            log(f"[7] {rows[-1]['name']}: {ms:.3f} ms (bound {bound:.3f} ms by "
                f"{rows[-1]['bound_by']}, {100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms")
    del r, w, mask, up
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    t_start = time.perf_counter()
    card = card_check()
    build_kernels()
    # df_gan_damsm.yml at 256², full width; no DAMSM weights in the repository
    cfg = cfg_from_dict({"IMG": {"SIZE": 256}, "TEXT": {"ENCODER_DIR": ""}},
                        base=cfg_from_file(str(CFG)))
    shapes = epilogue_shapes(cfg, BATCH)
    fa_errs = check_epilogue(shapes)
    ds_errs = check_damsm()

    g_cpu = make_generator(cfg, device="cpu")
    sd = perturbed_state_dict(g_cpu, seed=0)
    g_cpu.load_state_dict(sd, strict=True)
    check_slice_against_cpu(cfg, g_cpu)
    del g_cpu
    check_train_against_cpu()

    runs = {dtype: serve(cfg, sd, dtype) for dtype in (torch.float32, torch.bfloat16)}
    diff = (runs[torch.float32].pop("img") - runs[torch.bfloat16].pop("img")).abs()
    log(f"[5] bf16 vs fp32 images: max abs diff {diff.max().item():.4f}, "
        f"mean {diff.mean().item():.5f}")
    del diff
    torch.cuda.empty_cache()

    trains = {torch.bfloat16: train(torch.bfloat16, warmup=2, timed=10),
              torch.float32: train(torch.float32, warmup=1, timed=3)}
    step_launches = {dtype: r["launches"] for dtype, r in trains.items()}
    kernels = epilogue_rows(shapes, fa_errs, step_launches)
    kernels += damsm_rows(ds_errs, {None: step_launches[torch.float32],
                                    torch.bfloat16: step_launches[torch.bfloat16]})
    log(json.dumps({"card": card, "serving": list(runs.values()),
                    "training": list(trains.values())}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
