"""The damsm forward, d_regions and d_words on the card, one tree or several in turns.

    python -m xmc_gan_tpu_torch.damsm_turns [--trees DIR ...] [--rounds R] [--iters N]
                                            [--sets NAME ...] [--sass] [--out FILE]

Each tree is a checkout of this repository (default: this one).  All trees
build their ``csrc/damsm_score.cu`` at once (one ``nvcc`` each); then, for
each, a child process whose working directory and first import path is the
tree times that tree's wrappers (``ops.cuda.damsm_score._launch_fwd`` and
``_launch_bwd``, the calls ``damsm_scores`` makes; the d_words, which no
step launches, as a caller that differentiates the words reaches it), in
fp32 and bf16
(``--sets``: "LN fp32", "LN bf16", "flagship fp32", "flagship bf16";
default all four), on inputs drawn anew for each set from one seed:

  * "LN": the LN-COCO word shape (B = Bc = 256, R = 256, T = 200, D = 768),
    drawn as ``chip_smoke.py`` draws it (about half the slots real, the
    padding scattered, caption 1 all padded, caption 2 with 4 words), each
    caption's real words as the sub-captions that ``damsm_scores`` hands
    the kernels (each tree's own ``sub_caption_width``: 32 slots in bf16
    where the d_words runs on the tensor cores, else 16), the backward
    kernels with the cotangent its combine hands them;
  * "flagship": the flagship word loss (B = Bc = 128, R = 256, T = 20,
    D = 256, captions of 1 to 20 words), whose fp32 kernels the wide ones
    share device functions with.

For each it reports ``ms`` (CUDA events around ``--iters`` wrapper calls,
as ``chip_smoke.py`` phase 7 times them), ``kernel_ms`` (the profiler's
device time of the damsm kernels of one call, the median of ``--iters``
calls, each after a 256 MB write that evicts the 50 MB L2), the kernels'
names, ``bound_ms`` (2, 5 or 4 products of 2 R D operations per real word
and image over 67 TFLOP/s fp32, 989 bf16) and ``plain_ms`` (the plain version
on the whole captions, as phase 7 runs it).  With several trees each round runs them in
turns, the order reversed every other round (A B, B A, ...), so a drift of
the card's clocks falls on all alike.

``--sass`` compares the SASS of every kernel of the first two trees' builds
whose name lacks ``f32w`` (the wide kernels are new).

Prints the card's name and power limit, one JSON line per tree and turn, and
each measurement's median over the rounds; ``--out`` also writes them as
JSON.  Needs a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import sys

from xmc_gan_tpu_torch.turns import Record, in_turns, parser, prebuild, sass

CHILD = r"""
import re, statistics, torch
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds

torch.backends.cuda.matmul.allow_tf32 = False
for lib in getattr(ds, "LIBRARIES", (ds.KERNEL,)):  # one library in older trees
    lib.load()
iters = args["iters"]
flush = torch.empty(2**26, device="cuda")  # 256 MB: more than the L2 holds
norm = torch.nn.functional.normalize


def draw(gen, b, bc, R, T, D, ln):
    r = norm(torch.randn(b, R, D, generator=gen, device="cuda"), dim=-1)
    w = norm(torch.randn(bc, T, D, generator=gen, device="cuda"), dim=-1)
    if ln:
        mask = torch.rand(bc, T, generator=gen, device="cuda") > 0.5
        mask[1] = True
        mask[2] = True
        mask[2, 1:5] = False
    else:
        lens = torch.randint(1, T + 1, (bc,), generator=gen, device="cuda")
        mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    return r, w, mask, torch.randn(b, bc, generator=gen, device="cuda")


def kernel_ms(fn):
    # the damsm kernels of one call of fn, the median over iters calls, each
    # after an L2 flush, from a whole trace
    kernels = profiling.device_kernels(lambda: [(flush.zero_(), fn()) for _ in range(iters)])[0]
    per_call, names, call = [], set(), -1
    for k in kernels:
        if "damsm" not in k["name"] and "sum_splits" not in k["name"]:
            call += "fill" in k["name"].lower() or "zero" in k["name"].lower()
            continue
        while len(per_call) <= call:
            per_call.append(0.0)
        per_call[call] += k["ms"]
        names.add(re.search(r"(damsm_\w+|sum_splits_kernel)(<[^>]*>)?", k["name"])[0])
    return statistics.median(per_call), sorted(names)


out = {}
for label, (shape, ln, dtype) in args["sets"].items():
    b, bc, R, T, D = shape
    cd = dtype and getattr(torch, dtype)
    rate = 989e12 if cd == torch.bfloat16 else 67e12
    r, w, mask, up = draw(torch.Generator(device="cuda").manual_seed(12), *shape, ln)
    words = int((~mask).sum())
    w_sub, m_sub = ds.split_captions(w, mask, ds.sub_caption_width(R, T, D, cd))
    s = ds._launch_fwd(r, w_sub, m_sub, 4.0, 5.0, cd).view(b, bc, -1).requires_grad_()
    (g_sub,) = torch.autograd.grad(ds.combine_sub_scores(s, 5.0), s, up)
    g_sub = g_sub.reshape(b, -1).contiguous()
    block = 2**28 if ln else None
    calls = {
        "forward": (2, lambda: ds._launch_fwd(r, w_sub, m_sub, 4.0, 5.0, cd),
                    lambda: ds.damsm_scores_ref(r, w, mask, 4.0, 5.0, cd, block)),
        "d_regions": (5, lambda: ds._launch_bwd("dr", r, w_sub, m_sub, g_sub, 4.0, 5.0, cd),
                      lambda: ds._plain_vjp("dr", r, w, mask, up, 4.0, 5.0, cd, block)),
        "d_words": (4, lambda: ds._launch_bwd("dw", r, w_sub, m_sub, g_sub, 4.0, 5.0, cd),
                    lambda: ds._plain_vjp("dw", r, w, mask, up, 4.0, 5.0, cd, block)),
    }
    for name, (dots, kern, plain) in calls.items():
        k_ms, names = kernel_ms(kern)
        out[f"{label} {name}"] = {
            "ms": profiling.cuda_ms(kern, iters), "kernel_ms": k_ms,
            "plain_ms": profiling.cuda_ms(plain, 1),
            "bound_ms": 2 * R * D * dots * b * words / rate * 1e3, "kernels": names,
            "real_words": words, "sub_captions": list(w_sub.shape[:2])}
    del r, w, mask, up, w_sub, m_sub, s, g_sub
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


# (B, Bc, R, T, D), LN-drawn mask, compute dtype
SETS = {"LN fp32": ((256, 256, 256, 200, 768), True, None),
        "LN bf16": ((256, 256, 256, 200, 768), True, "bfloat16"),
        "flagship fp32": ((128, 128, 256, 20, 256), False, None),
        "flagship bf16": ((128, 128, 256, 20, 256), False, "bfloat16")}


def main() -> int:
    ap = parser(__doc__, iters=2)
    ap.add_argument("--sets", nargs="*", choices=sorted(SETS),
                    help="the sets to time (default: all four)")
    args = ap.parse_args()
    trees = [t.resolve() for t in args.trees]
    record = Record(trees, args.out)
    prebuild(trees, "from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds, build; "
                    "build.load_all(getattr(ds, 'LIBRARIES', (ds.KERNEL,)))")
    if args.sass:
        record.add("sass", sass(trees, "damsm_score.cu", keep=lambda name: "f32w" not in name))
    sets = {k: v for k, v in SETS.items() if not args.sets or k in args.sets}
    in_turns(trees, args.rounds, CHILD, {"iters": args.iters, "sets": sets}, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
