"""Where the bf16 tensor-core damsm kernels spend their cycles, phase by phase, on the card.

    python -m xmc_gan_tpu_torch.damsm_phases

Builds ``csrc/damsm_score.cu`` with ``-DXMC_DAMSM_PHASES`` (the tensor-core
d_regions and forward kernels then add each block's ``clock64()`` cycles
between its barriers into per-phase counters), runs one launch of each
kernel of that build through its wrapper, at the wrapper's own plan, at the
flagship word-loss shape (B = Bc = 128, R = 256 regions, T = 20 words, D =
256) and prints the card, each launch's time (CUDA events) and its cycles
per pass of each phase, summed over blocks.  Phases both kernels have: pack
(warp 0 packs the pass's real words), words (their load), sim + softmax
(products W R^T, softmax, a to shared memory), c + rel (a R, norms, rel),
regions (the block's one load, per pass; the forward's also writes the
all-padded captions' scores).  d_regions then: d rel, d_c, d a + d_sim (d_c
R^T, the softmax backward), then the d_r accumulation as thread 0's own
warp sees it: d_r products (a^T d_c + d_sim^T W, as issued) and d_r
read-modify-write (the staging, the wait for the slice's earlier sums and
for the products' results, the stores), and d_r barrier (the wait for the
block's other warps).  The forward then: scores (each caption's logsumexp
and the wait for the block's other warps).  The counters cost time of their
own (an extra barrier a pass), so a launch is slower than the plain
build's.  Needs a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary

# csrc/damsm_score.cu: the TC_PHASE slots (TC_NPHASE of them; [PASSES] counts passes)
NPHASE, PASSES = 13, 10
PHASES = {0: "pack", 1: "words", 2: "sim + softmax", 3: "c + rel", 4: "d rel", 5: "d_c",
          6: "d a + d_sim", 7: "d_r products", 8: "d_r read-modify-write", 9: "regions",
          11: "d_r barrier", 12: "scores"}
# each kernel's phases, in the order a pass runs them
KERNEL_PHASES = {"d_regions": (0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 9),
                 "forward": (0, 1, 2, 3, 12, 9)}


def phase_library() -> CudaLibrary:
    """``damsm_score.cu`` built with the phase counters, with their two C functions."""
    return CudaLibrary("damsm_score.cu", {
        **ds.KERNEL.signatures,
        "xmc_damsm_phases_read": (ctypes.c_int, [ctypes.c_void_p]),
        "xmc_damsm_phases_reset": (ctypes.c_int, []),
    }, flags=("-DXMC_DAMSM_PHASES",))


def read_phases(lib: CudaLibrary) -> list[int]:
    """The counters (cycles per phase, summed over blocks; [PASSES]: passes)."""
    cycles = (ctypes.c_ulonglong * NPHASE)()
    if lib.load().xmc_damsm_phases_read(ctypes.addressof(cycles)) != 0:
        raise RuntimeError("damsm_phases: reading the counters failed")
    return list(cycles)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("damsm_phases: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = phase_library()
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, bc, R, T, D = 128, 128, 256, 20, 256
    norm = torch.nn.functional.normalize
    r = norm(torch.randn(b, R, D, generator=gen, device="cuda"), dim=-1)
    w = norm(torch.randn(bc, T, D, generator=gen, device="cuda"), dim=-1)
    lens = torch.randint(1, T + 1, (bc,), generator=gen, device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    up = torch.randn(b, bc, generator=gen, device="cuda")
    launches = {
        "d_regions": lambda: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16,
                                            library=lib),
        "forward": lambda: ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16, library=lib),
    }
    print(card)
    for kernel, launch in launches.items():
        launch()
        torch.cuda.synchronize()
        lib.load().xmc_damsm_phases_reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        cycles = read_phases(lib)
        passes = max(1, cycles[PASSES])
        print(f"bf16 {kernel}, B={b}, Bc={bc}, R={R}, T={T} ({int((~mask).sum())} real words), "
              f"D={D}: {start.elapsed_time(end):.3f} ms with counters, {cycles[PASSES]} passes "
              f"({cycles[PASSES] / b:.1f} per image)")
        total = sum(cycles[k] for k in KERNEL_PHASES[kernel])
        for k in KERNEL_PHASES[kernel]:
            print(f"  {PHASES[k]:22s} {cycles[k] / passes:9.0f} cycles/pass "
                  f"({100 * cycles[k] / total:4.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
