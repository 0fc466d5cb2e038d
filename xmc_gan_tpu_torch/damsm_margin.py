"""The bf16 damsm forward's distance from the exact scores of its rounding model, by draw.

``python -m xmc_gan_tpu_torch.damsm_margin [--shape B Bc R T D] [--seeds N]``
draws N seeded inputs at the shape (normalized random regions and words,
caption lengths uniform in 1..T, caption 1 all padded: seed by seed the
draws of the card tests' ``_damsm_inputs``), launches the bf16 forward (the
kernel that ``damsm_score.route`` picks) and prints, for every draw
where a distance exceeds the bf16 score tolerance of the checks (2^-12),
and then as the worst over all draws, the largest distance over the
captions with a real word between: the kernel and the plain version summed
in fp32 (``damsm_scores_ref``); the kernel and the plain version summed in
fp64 around the same rounding points (on fp64 operands), which the checks
hold it against; and the two plain versions.  Both the kernel and the fp32
plain version round a and c_hat to bf16 from fp32 sums in their own order,
so a value next to a bf16 rounding midpoint can round to either neighbour:
a distance from the fp64 sums comes from such flips.  Default shape (132,
7, 64, 7, 40), a tile edge of the resident-region kernel at narrow D.
Needs a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds

SCORE_TOL = 2.0 ** -12  # the bf16 score tolerance of chip_smoke.py and the card tests


def draw(shape: tuple[int, ...], seed: int):
    b, bc, R, T, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    norm = torch.nn.functional.normalize
    r = norm(torch.randn(b, R, D, generator=gen, device="cuda"), dim=-1)
    w = norm(torch.randn(bc, T, D, generator=gen, device="cuda"), dim=-1)
    lens = torch.randint(1, T + 1, (bc,), generator=gen, device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    mask[1] = True
    return r, w, mask


def distances(r, w, mask) -> tuple[float, float, float]:
    """(kernel - fp32 plain, kernel - fp64 plain, fp32 plain - fp64 plain),
    the largest over the captions with a real word."""
    bf = torch.bfloat16
    got = ds._launch_fwd(r, w, mask, 4.0, 5.0, bf).double()
    p32 = ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, bf).double()
    p64 = ds.damsm_scores_ref(r.double(), w.double(), mask, 4.0, 5.0, bf)
    real = ~mask.all(1)
    pairs = ((got, p32), (got, p64), (p32, p64))
    return tuple((x - y)[:, real].abs().max().item() for x, y in pairs)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", type=int, nargs=5, default=[132, 7, 64, 7, 40],
                        metavar=("B", "Bc", "R", "T", "D"))
    parser.add_argument("--seeds", type=int, default=64)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("damsm_margin: needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    shape = tuple(args.shape)
    print(card)
    print(f"bf16 forward at {shape} ({ds.kernel_name('fwd', shape[2], shape[4], torch.bfloat16)}"
          f"...), seeds 0..{args.seeds - 1}; distances kernel-fp32 plain, kernel-fp64 plain, "
          f"fp32 plain-fp64 plain (tolerance {SCORE_TOL:.3g})")
    worst, over = [0.0, 0.0, 0.0], [0, 0, 0]
    for seed in range(args.seeds):
        d = distances(*draw(shape, seed))
        worst = [max(a, x) for a, x in zip(worst, d)]
        over = [n + (x > SCORE_TOL) for n, x in zip(over, d)]
        if max(d) > SCORE_TOL:
            print(f"seed {seed}: {d[0]:.3g}, {d[1]:.3g}, {d[2]:.3g}")
    print(f"worst of {args.seeds}: {worst[0]:.3g}, {worst[1]:.3g}, {worst[2]:.3g}; draws over the "
          f"tolerance: {over[0]}, {over[1]}, {over[2]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
