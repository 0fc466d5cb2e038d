#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then non-zero):

1. Card check: CUDA must be available; prints the card's name and power limit.
2. Build: compiles the path's CUDA source (``xmc_gan_tpu_torch/csrc``) with
   ``nvcc`` and prints the build time.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   the 256², NCH=32, batch-128 generator gives it, plus one ragged shape.
4. The slice (DAMSM encoder + NetG at 256², NCH=32, batch 4, fp32 with TF32
   off) on the card against the same slice on the CPU, on the same seeded,
   perturbed weights and numpy inputs.
5. Full-width serving: random caption ids (batch 128, T=20, mixed lengths)
   -> ``make_encode_fn`` -> ``make_sample_fn``, fp32 and bf16 (then fp32
   with TF32 turned on after the sampler is built, for comparison); checks the kernel launch count of that run
   (14 per G forward), that the images are finite and in [-1, 1], and prints
   images/s (median of 7 synchronised requests), peak memory, and where one
   request's device time goes (``torch.profiler``, by kernel category).
6. Kernel times against their bounds (CUDA events over repeated launches,
   and each launch's device time from the profiler), as one
   ``{"kernels": [...]}`` line.
7. Last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  The weights are random (from
fixed seeds): no trained checkpoint is in the repository.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.models.df_gan import epilogue_shapes
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
from xmc_gan_tpu_torch.trainer import make_encode_fn

REPO = Path(__file__).resolve().parent
CFG = REPO / "xmc_gan_tpu" / "cfg" / "df_gan_damsm.yml"  # the YAML schema file only
BATCH = 128  # serving batch (docs/SERVING.md)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_ULP = 2.0 ** -7
# Kernel vs plain (rtol, atol).  fp32: the kernel contracts each g*y+b into
# one FMA, the plain version rounds the product first; with N(0, 1) inputs the
# chain's terms reach ~1e2, so one fp32 rounding of them is up to ~1e-5
# absolute.  bf16: the same values rounded once on store, so one bf16 ulp,
# plus that fp32 difference where the result is near zero.
KERNEL_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (BF16_ULP, 2e-5)}
# card vs CPU, fp32 with TF32 off: summation order of cuDNN vs CPU kernels
SLICE_TOL = {"words": 1e-4, "sent": 1e-4, "images": 2e-3}
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def build_kernel() -> float:
    t0 = time.perf_counter()
    fa.KERNEL.load()
    dt = time.perf_counter() - t0
    log(f"[2] built {fa.KERNEL.source} in {dt:.2f} s")
    return dt


def perturbed_state_dict(g: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Every G parameter replaced by a seeded value that keeps activations
    O(1) with non-zero gates (a fresh G's zero gates would hide the
    epilogue): weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), affine
    outputs gamma ~ 1 +- 0.1 and beta ~ 0 +- 0.1, gates ~ U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in g.state_dict().items():
        shape = tuple(t.shape)
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


def device_kernels(fn) -> list[tuple[str, float]]:
    """(name, device ms) of every CUDA kernel that one call of ``fn`` runs, in
    launch order, from ``torch.profiler`` (CUPTI), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(ev.name, ev.device_time_total / 1e3) for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time on this machine")
    return kernels


def kernel_category(name: str) -> str:
    n = name.lower()
    if "fused_affine" in n:
        return "fused_affine"
    if "upsample" in n:
        return "upsample"
    if any(k in n for k in ("xmma", "gemm", "conv", "cutlass", "cudnn", "dgrad", "fprop",
                            "wgrad", "winograd", "implicit", "fft", "complex")):
        return "conv/matmul (cuDNN, cuBLAS)"
    if any(k in n for k in ("nchw", "nhwc", "transpose")):
        return "layout transforms"
    if "lstm" in n or "rnn" in n:
        return "text encoder RNN"
    return "other (elementwise, casts, copies)"


def epilogue_inputs(shape, dtype, gen):
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    mods = [torch.randn(b, c, generator=gen, device="cuda") for _ in range(4)]
    return x, mods


def check_kernels(shapes) -> dict:
    """Phase 3: both forms, both dtypes, every path shape plus a ragged one."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ragged = (3, 13, 7, 9)  # C not a multiple of the vector width, H*W odd
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = KERNEL_TOL[dtype]
        worst = {1: 0.0, 2: 0.0}
        for shape in [*shapes, ragged]:
            x, mods = epilogue_inputs(shape, dtype, gen)
            for nmod, kern, ref in ((1, fa.modulate_lrelu_kernel, fa.modulate_lrelu_ref),
                                    (2, fa.double_modulate_lrelu_kernel,
                                     fa.double_modulate_lrelu_ref)):
                got = kern(x, *mods[: 2 * nmod]).float()
                want = ref(x, *mods[: 2 * nmod]).float()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
                worst[nmod] = max(worst[nmod], (got - want).abs().max().item())
            del x, mods, got, want
        errs[dtype] = worst
        log(f"[3] fused_affine {DTYPE_NAME[dtype]}: max_abs_err 1-mod {worst[1]:.3g}, "
            f"2-mod {worst[2]:.3g} over {len(shapes)} path shapes + ragged {ragged} "
            f"(tolerance rtol {rtol:g} atol {atol:g})")
    return errs


def check_slice_against_cpu(cfg, g_cpu) -> None:
    """Phase 4: encoder + NetG at 256², NCH=32, batch 4, fp32, TF32 off."""
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


def serve(cfg, sd, dtype, tf32: bool, count_launches: bool) -> dict:
    """Phase 5 for one dtype: encode + sample at batch 128, full width."""
    rng = np.random.RandomState(2)
    batch = random_captions(rng, BATCH, cfg.TEXT.MAX_LENGTH, cfg.TEXT.VOCA_SIZE)
    noise = torch.from_numpy(rng.randn(BATCH, cfg.TRAIN.NOISE_DIM).astype(np.float32))
    encode = make_encode_fn(cfg, device="cuda")
    g = make_generator(cfg, dtype, "cuda")
    g.load_state_dict(sd, strict=True)
    sample = make_sample_fn(cfg, g)  # turns TF32 off
    # the comparison run turns it back on after the sampler is built
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32

    def request():
        words, sent, mask = encode(batch)
        return sample(noise, sent, words, mask)

    for _ in range(2):  # warm-up: cuDNN plans, allocator
        request()
    torch.cuda.synchronize()
    label = DTYPE_NAME[dtype] + ("+tf32" if tf32 else "")
    launches = None
    if count_launches:
        fa.KERNEL.launches = 0  # the main path's run: counts from here
        img = request()
        torch.cuda.synchronize()
        launches = fa.KERNEL.launches
        if launches != 14:
            raise AssertionError(f"{label}: {launches} fused_affine launches, want 14 "
                                 "(2 per GBlock x 7 at 256²)")
    else:
        img = request()
        torch.cuda.synchronize()
    if tuple(img.shape) != (BATCH, 256, 256, 3) or img.dtype != torch.float32:
        raise AssertionError(f"{label}: images {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(img).all()) or img.abs().max().item() > 1.0:
        raise AssertionError(f"{label}: images not finite or outside [-1, 1]")
    words, sent, mask = encode(batch)
    torch.cuda.reset_peak_memory_stats()
    times_g, times_req = [], []
    for _ in range(7):
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
    # where the time goes: device time of one request by kernel category
    times: dict[str, float] = {}
    by_cat: dict[str, float] = {}
    for name, ms in device_kernels(request):
        times[name] = times.get(name, 0.0) + ms
        by_cat[kernel_category(name)] = by_cat.get(kernel_category(name), 0.0) + ms
    device_ms = sum(times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    res = {"dtype": label, "launches": launches, "g_ms": g_s * 1e3, "request_ms": req_s * 1e3,
           "img_per_s_g": BATCH / g_s, "img_per_s_request": BATCH / req_s,
           "peak_mem_gib": peak, "request_device_ms": device_ms,
           "device_busy_share": device_ms / (req_s * 1e3),
           "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
           "top_kernels_ms": [[name[:100], ms] for name, ms in top], "img": img}
    log(f"[5] serve {label} bs{BATCH} 256²: launches {launches}, G forward "
        f"{res['g_ms']:.2f} ms ({res['img_per_s_g']:.1f} img/s), encode+G "
        f"{res['request_ms']:.2f} ms ({res['img_per_s_request']:.1f} img/s), peak memory "
        f"{peak:.2f} GiB (median of 7)")
    log(f"[5] {label} one request on the device: {device_ms:.2f} ms of kernels, busy share "
        f"{res['device_busy_share']:.3f}; " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in res["device_ms_by_category"].items()))
    return res


def time_kernels(shapes, errs, launches) -> list[dict]:
    """Phase 6: the 14 launches of one G forward, kernel vs plain vs bound."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        ins = [epilogue_inputs(s, dtype, gen) for s in shapes]
        elsize = torch.empty((), dtype=dtype).element_size()
        numels = [math.prod(s) for s in shapes]
        # bytes: x read once, out written once, the four fp32 [B, C] vectors read once
        byte_ms = [(2 * n * elsize + 4 * s[0] * s[1] * 4) / HBM_BYTES_PER_S * 1e3
                   for n, s in zip(numels, shapes)]
        op_ms = [8 * n / FP32_OPS_PER_S * 1e3 for n in numels]  # 2 FMA + 2 select
        big = max(range(len(shapes)), key=lambda i: numels[i])
        kern = lambda xs: [fa.double_modulate_lrelu_kernel(x, *m) for x, m in xs]
        ref = lambda xs: [fa.double_modulate_lrelu_ref(x, *m) for x, m in xs]
        ms, plain_ms = cuda_ms(lambda: kern(ins), 10), cuda_ms(lambda: ref(ins), 5)
        per_launch = [ms for name, ms in device_kernels(lambda: kern(ins))
                      if "fused_affine" in name]
        if len(per_launch) != len(shapes):
            raise AssertionError(f"profiled {len(per_launch)} fused_affine kernels, "
                                 f"launched {len(shapes)}")
        device_ms = sum(per_launch)
        ms_big = cuda_ms(lambda: kern([ins[big]]), 20)
        plain_big = cuda_ms(lambda: ref([ins[big]]), 10)
        bound = sum(max(b, o) for b, o in zip(byte_ms, op_ms))
        bound_big = max(byte_ms[big], op_ms[big])
        rows.append({
            "name": f"fused_affine.double_modulate_lrelu[{DTYPE_NAME[dtype]}]",
            "route": "cuda",
            "source": "xmc_gan_tpu_torch/csrc/fused_affine.cu",
            "replaces": "xmc_gan_tpu/ops/pallas/fused_affine.py:71",
            "launches": launches[dtype],
            "max_abs_err": errs[dtype][2],
            "ms": ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if sum(byte_ms) >= sum(op_ms) else "operations",
            "library_ms": None,
            "launches_per_forward": len(shapes),
            "shapes": f"the 14 epilogue inputs of one 256² NCH=32 G forward at batch {BATCH}",
            "ms_largest": ms_big,
            "plain_ms_largest": plain_big,
            "bound_ms_largest": bound_big,
            "largest_shape": list(shapes[big]),
            "roofline_share": bound / ms,
            "per_launch": [{"shape": list(sh), "device_ms": d, "bound_ms": max(b_, o_)}
                           for sh, d, b_, o_ in zip(shapes, per_launch, byte_ms, op_ms)],
        })
        log(f"[6] fused_affine {DTYPE_NAME[dtype]}: 14 launches {ms:.3f} ms, kernels alone "
            f"{device_ms:.3f} ms (bound {bound:.3f} ms, {100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms; largest "
            f"{tuple(shapes[big])} {ms_big:.3f} ms (bound {bound_big:.3f}), plain "
            f"{plain_big:.3f} ms")
        log(f"[6] fused_affine {DTYPE_NAME[dtype]} per launch (shape: device ms / bound ms): "
            + ", ".join(f"{'x'.join(map(str, sh))}: {d:.4f}/{max(b_, o_):.4f}"
                        for sh, d, b_, o_ in zip(shapes, per_launch, byte_ms, op_ms)))
        del ins
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    card = card_check()
    build_kernel()
    # df_gan_damsm.yml at 256², full width; no DAMSM weights in the repository
    cfg = cfg_from_dict({"IMG": {"SIZE": 256}, "TEXT": {"ENCODER_DIR": ""}},
                        base=cfg_from_file(str(CFG)))
    shapes = epilogue_shapes(cfg, BATCH)
    errs = check_kernels(shapes)

    g_cpu = make_generator(cfg, device="cpu")
    sd = perturbed_state_dict(g_cpu, seed=0)
    g_cpu.load_state_dict(sd, strict=True)
    check_slice_against_cpu(cfg, g_cpu)
    del g_cpu

    runs = {dtype: serve(cfg, sd, dtype, tf32=False, count_launches=True)
            for dtype in (torch.float32, torch.bfloat16)}
    diff = (runs[torch.float32].pop("img") - runs[torch.bfloat16].pop("img")).abs()
    log(f"[5] bf16 vs fp32 images: max abs diff {diff.max().item():.4f}, "
        f"mean {diff.mean().item():.5f}")
    del diff
    tf32 = serve(cfg, sd, torch.float32, tf32=True, count_launches=False)
    tf32.pop("img")
    torch.cuda.empty_cache()

    kernels = time_kernels(shapes, errs, {d: r["launches"] for d, r in runs.items()})
    log(json.dumps({"card": card, "serving": [runs[torch.float32], runs[torch.bfloat16], tf32]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
