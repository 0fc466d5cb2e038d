"""Where the damsm d_regions and forward kernels spend their cycles, phase by phase, on the card.

    python -m xmc_gan_tpu_torch.damsm_phases

Builds ``csrc/damsm_score.cu`` with ``-DXMC_DAMSM_PHASES`` (the bf16
tensor-core d_regions and forward kernels and the fp32 d_regions and forward
with packed words then add each block's ``clock64()`` cycles between its
barriers into per-phase counters), runs one launch of each kernel of that
build through its wrapper, at the wrapper's own plan, at the flagship
word-loss shape (B = Bc = 128, R = 256 regions, T = 20 words, D = 256), and
of the streamed bf16
d_regions and forward and the wide fp32 d_regions and forward at the LN-COCO
word shape (B = Bc = 256, R = 256, T = 200 as the sub-captions of the
packed real words that ``damsm_scores`` hands them, 32 slots in bf16 and 16
in fp32, D = 768), and prints
the card, each
launch's time (CUDA events) and its cycles per pass of each phase, summed
over blocks.  Phases both bf16 flagship kernels have: pack
(warp 0 packs the pass's real words), words (their load), sim + softmax
(products W R^T, softmax, a to shared memory), c + rel (a R, norms, rel),
regions (the block's one load, per pass; the forward's also writes the
all-padded captions' scores).  d_regions then: d rel, d_c, d a + d_sim (d_c
R^T, the softmax backward), then the d_r accumulation as thread 0's own
warp sees it: d_r products (a^T d_c + d_sim^T W, as issued) and d_r
read-modify-write (the staging, the wait for the slice's earlier sums and
for the products' results, the stores), and d_r barrier (the wait for the
block's other warps).  The forward then: scores (each caption's logsumexp
and the wait for the block's other warps).  The streamed d_regions
(D > 256) has pack, words, d rel and the three d_r phases, and instead of
the others: region waits (the waits for its streamed region chunks,
``cp.async`` and the barrier after it, over its three sweeps), the sim, c
and d a products (each with the issue of the next chunk's loads), softmax,
norm + rel and d_c (the two reductions over all of D) and d_sim.  The
streamed forward has pack, words, the region waits, the sim and c products,
softmax, norm + rel and scores.  The fp32 d_regions (packed words, regions
streamed in 32-row and 32-column chunks) has the streamed bf16 d_regions'
phases, the fp32 forward (the same passes and chain to rel) the streamed
bf16 forward's.  The wide fp32 forward (D > 256) has the fp32 forward's
phases: its c products are the sweep over the row chunks of each
256-feature group, and norm + rel the two reductions that end it.  The
wide fp32 d_regions has the fp32 d_regions' but d_c (norm): its d a
products are one sweep that takes the context again a group at a time,
its d_c over the group and its d a (column chunks), and it adds words
again, the loads of a group's words before that group's d_r products.
The counters cost time of their own (an
extra barrier a pass), so a launch is slower than the plain build's.  Needs
a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.ops.cuda.build import CudaLibrary

# csrc/damsm_score.cu: the TC_PHASE slots (TC_NPHASE of them; [PASSES] counts passes)
NPHASE, PASSES = 22, 10
PHASES = {0: "pack", 1: "words", 2: "sim + softmax", 3: "c + rel", 4: "d rel", 5: "d_c",
          6: "d a + d_sim", 7: "d_r products", 8: "d_r read-modify-write", 9: "regions",
          11: "d_r barrier", 12: "scores", 13: "region waits", 14: "sim products",
          15: "softmax", 16: "c products", 17: "norm + rel", 18: "d_c (norm)",
          19: "d a products", 20: "d_sim", 21: "words again"}
# each kernel's phases, in the order a pass runs them
KERNEL_PHASES = {"d_regions": (0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 9),
                 "d_regions, streamed": (0, 1, 14, 15, 16, 17, 4, 18, 19, 20, 13, 7, 8, 11),
                 "d_regions, fp32": (0, 1, 14, 15, 16, 17, 4, 18, 19, 20, 13, 7, 8, 11),
                 "forward": (0, 1, 2, 3, 12, 9),
                 "forward, streamed": (0, 1, 14, 15, 16, 17, 12, 13),
                 "forward, fp32": (0, 1, 14, 15, 16, 17, 12, 13),
                 "d_regions, fp32 wide": (0, 1, 14, 15, 16, 17, 4, 19, 20, 21, 13, 7, 8, 11),
                 "forward, fp32 wide": (0, 1, 14, 15, 16, 17, 12, 13)}


def phase_library() -> CudaLibrary:
    """``damsm_score.cu`` built with the phase counters, with their two C functions."""
    return CudaLibrary("damsm_score.cu", {
        **{k: v for lib in ds.LIBRARIES for k, v in lib.signatures.items()},
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
    norm = torch.nn.functional.normalize
    b, bc, R, T, D = 128, 128, 256, 20, 256
    r = norm(torch.randn(b, R, D, generator=gen, device="cuda"), dim=-1)
    w = norm(torch.randn(bc, T, D, generator=gen, device="cuda"), dim=-1)
    lens = torch.randint(1, T + 1, (bc,), generator=gen, device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    up = torch.randn(b, bc, generator=gen, device="cuda")
    # the LN-COCO word shape: about half the 200 slots real, scattered; the
    # sub-captions of the packed real words, each with its caption's cotangent
    ln_b, ln_t, ln_d = 256, 200, 768
    ln_r = norm(torch.randn(ln_b, R, ln_d, generator=gen, device="cuda"), dim=-1)
    ln_w = norm(torch.randn(ln_b, ln_t, ln_d, generator=gen, device="cuda"), dim=-1)
    ln_mask = torch.rand(ln_b, ln_t, generator=gen, device="cuda") > 0.5
    ln_up = torch.randn(ln_b, ln_b, generator=gen, device="cuda")
    # each dtype's own width (``sub_caption_width``: 32 slots in bf16, 16 in fp32)
    subs = {}
    for cd in (torch.bfloat16, None):
        ws, ms = ds.split_captions(ln_w, ln_mask, ds.sub_caption_width(R, ln_t, ln_d, cd))
        subs[cd] = ws, ms, ln_up.repeat_interleave(ws.shape[0] // ln_b, dim=1)
    w_sub, m_sub, g_sub = subs[torch.bfloat16]
    w32, m32, g32 = subs[None]
    launches = {
        "d_regions, fp32": (lambda: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, None,
                                                   library=lib), b, mask, f"T={T}", D),
        "d_regions": (lambda: ds._launch_bwd("dr", r, w, mask, up, 4.0, 5.0, torch.bfloat16,
                                             library=lib), b, mask, f"T={T}", D),
        "d_regions, streamed": (lambda: ds._launch_bwd("dr", ln_r, w_sub, m_sub, g_sub, 4.0, 5.0,
                                                       torch.bfloat16, library=lib), ln_b,
                                ln_mask, f"T={ln_t} as {tuple(w_sub.shape[:2])} sub-captions",
                                ln_d),
        "forward, fp32": (lambda: ds._launch_fwd(r, w, mask, 4.0, 5.0, None, library=lib), b,
                          mask, f"T={T}", D),
        "forward": (lambda: ds._launch_fwd(r, w, mask, 4.0, 5.0, torch.bfloat16, library=lib), b,
                    mask, f"T={T}", D),
        "forward, streamed": (lambda: ds._launch_fwd(ln_r, w_sub, m_sub, 4.0, 5.0, torch.bfloat16,
                                                     library=lib), ln_b, ln_mask,
                              f"T={ln_t} as {tuple(w_sub.shape[:2])} sub-captions", ln_d),
        "d_regions, fp32 wide": (lambda: ds._launch_bwd("dr", ln_r, w32, m32, g32, 4.0, 5.0,
                                                        None, library=lib), ln_b, ln_mask,
                                 f"T={ln_t} as {tuple(w32.shape[:2])} sub-captions", ln_d),
        "forward, fp32 wide": (lambda: ds._launch_fwd(ln_r, w32, m32, 4.0, 5.0, None,
                                                      library=lib), ln_b, ln_mask,
                               f"T={ln_t} as {tuple(w32.shape[:2])} sub-captions", ln_d),
    }
    print(card)
    for kernel, (launch, nb, words, t_desc, d) in launches.items():
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
        dtype = "" if "fp32" in kernel else "bf16 "
        print(f"{dtype}{kernel}, B=Bc={nb}, R={R}, {t_desc} ({int((~words).sum())} real words), "
              f"D={d}: {start.elapsed_time(end):.3f} ms with counters, {cycles[PASSES]} passes "
              f"({cycles[PASSES] / nb:.1f} per image)")
        total = sum(cycles[k] for k in KERNEL_PHASES[kernel])
        for k in KERNEL_PHASES[kernel]:
            print(f"  {PHASES[k]:22s} {cycles[k] / passes:9.0f} cycles/pass "
                  f"({100 * cycles[k] / total:4.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
