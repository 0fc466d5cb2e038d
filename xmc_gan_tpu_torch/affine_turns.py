"""The fused_affine backward at the train steps' shapes on the card, one tree or several in turns.

    python -m xmc_gan_tpu_torch.affine_turns [--trees DIR ...] [--rounds R] [--iters N]
                                             [--sets NAME ...] [--sass] [--step]
                                             [--out FILE]

Each tree is a checkout of this repository (default: this one).  For each, a
child process whose working directory and first import path is the tree
builds that tree's ``csrc/fused_affine.cu`` and times that tree's backward
wrapper (``ops.cuda.fused_affine._launch_bwd``, the call that G's backward
makes) at the 14 epilogue inputs of one train step:

  * "flagship fp32" and "flagship bf16": the flagship_word step (256²,
    NCH=32, batch 128), the ``[B, C]`` vectors in x's dtype, as the step's
    Affine MLPs hand them over;
  * "LN bf16": the LN-COCO step (``ln_coco_256.yml``: NCH=96, batch 256).

One shape is resident at a time: its x, dy (channels_last, N(0, 1)) and
vectors are drawn, timed and freed before the next.  Per set it reports,
summed over the 14 launches:

  * ``ms``: CUDA events around ``--iters`` back-to-back wrapper calls of a
    shape (the kernel and whatever the wrapper launches beside it; small
    shapes find their bytes in L2), as ``chip_smoke.py`` phase 7 times it;
  * ``kernel_ms``: the profiler's device time of the backward kernel alone,
    the median of ``--iters`` launches, each after a 256 MB write that
    evicts the 50 MB L2 (the byte bound's premise: every byte from HBM);
  * ``clone_ms``: the same for ``clone`` of a tensor of 1.5x x's bytes: a
    copy of the backward's bytes (x and dy read, dx written) as a yardstick;
  * ``launches``: the kernels one wrapper call launches, from a trace;
  * ``bound_ms``: x and dy read and dx written once at 3.35 TB/s.

With several trees each round runs them in turns, the order reversed every
other round (A B, B A, ...), so a drift of the card's clocks falls on both
alike (``turns``).

``--sass`` builds the first two trees' ``csrc/fused_affine.cu`` and compares
the SASS of the forward kernels (every kernel whose name lacks ``bwd``).

``--step`` runs, per tree, one bf16 flagship_word train step (that tree's
``chip_smoke.TRAIN_OVERRIDES``, after two warm-up steps) under the profiler
and reports how many kernels it launches, and how many of them are
``fused_affine`` kernels.

Prints the card's name and power limit, one JSON line per tree and turn, and
each measurement's median over the rounds; ``--out`` also writes them as
JSON.  Needs a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import sys

from xmc_gan_tpu_torch.turns import REPO, Record, in_turns, parser, run_child, sass

CHILD = r"""
import math, statistics, torch
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa

iters = args["iters"]
fa.KERNEL.load()
flush = torch.empty(2**26, device="cuda")  # 256 MB: more than the L2 holds


def flushed(fn, pattern, copies=False):
    # the device ms of the kernels (or copies) matching pattern in iters
    # calls of fn, each after an L2 flush, from a whole trace; and the
    # kernels one call launches
    seen = profiling.device_kernels(lambda: [(flush.zero_(), fn()) for _ in range(iters)],
                                    expect={pattern: iters}, copies=copies)[0]
    return [k["ms"] for k in seen if pattern in k["name"]], len(seen) // iters - 1


out = {}
gen = torch.Generator(device="cuda").manual_seed(3)
for label, spec in args["sets"].items():
    dtype = getattr(torch, spec["dtype"])
    es = torch.empty((), dtype=dtype).element_size()
    res = {"ms": 0.0, "kernel_ms": 0.0, "clone_ms": 0.0, "clone_event_ms": 0.0,
           "bound_ms": 0.0, "launches": 0, "by_shape": []}
    counts = {}
    for s in spec["shapes"]:
        counts[tuple(s)] = counts.get(tuple(s), 0) + 1
    for shape, n in counts.items():
        b, c = shape[:2]
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last)
        mods = tuple(torch.randn(b, c, generator=gen, device="cuda").to(dtype)
                     for _ in range(4))
        call = lambda: fa._launch_bwd(x, mods, dy, 0.2)
        ms = profiling.cuda_ms(call, iters)
        bwd, launches = flushed(call, "fused_affine_bwd")
        del dy
        flat = torch.empty(3 * x.numel() // 2, dtype=dtype, device="cuda")
        del x
        clone = lambda: flat.clone()
        clone_event = profiling.cuda_ms(clone, iters)
        copies, _ = flushed(clone, "Memcpy", copies=True)
        del flat
        torch.cuda.empty_cache()
        row = {"shape": list(shape), "launches_a_step": n, "ms": ms,
               "kernel_ms": statistics.median(bwd), "clone_ms": statistics.median(copies),
               "clone_event_ms": clone_event, "bound_ms": 3 * math.prod(shape) * es / 3.35e12 * 1e3,
               "launches": launches}
        res["by_shape"].append(row)
        for key in ("ms", "kernel_ms", "clone_ms", "clone_event_ms", "bound_ms"):
            res[key] += n * row[key]
        res["launches"] += n * launches
    out[label] = res
print(json.dumps(out))
"""

STEP_CHILD = r"""
import numpy as np, torch
import chip_smoke as cs
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.train import create_train_state, make_train_step

cfg = cfg_from_dict(cs.TRAIN_OVERRIDES)
bs = cfg.TRAIN.BATCH_SIZE
state = create_train_state(cfg, torch.bfloat16, "cuda", seed=0)
step = make_train_step(cfg)
rng = np.random.RandomState(7)
batch = {k: torch.from_numpy(v).cuda()
         for k, v in cs.train_batch(rng, cfg, bs, cs.prefix_mask).items()}
noise = torch.from_numpy(rng.randn(bs, cfg.TRAIN.NOISE_DIM).astype(np.float32)).cuda()
for _ in range(2):
    step(state, batch, noise)
torch.cuda.synchronize()
names = [k["name"] for k in profiling.device_kernels(lambda: step(state, batch, noise))[0]]
print(json.dumps({"step_kernels": len(names),
                  "fused_affine_kernels": sum("fused_affine" in n for n in names),
                  "fused_affine_bwd_kernels": sum("fused_affine_bwd" in n for n in names)}))
"""


def sets() -> dict:
    """The three sets of 14 launches, from this checkout's configs."""
    sys.path.insert(0, str(REPO))
    from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
    from xmc_gan_tpu_torch.models.df_gan import epilogue_shapes

    cfg_dir = REPO / "xmc_gan_tpu" / "cfg"
    flagship = cfg_from_dict({"IMG": {"SIZE": 256}, "TEXT": {"ENCODER_DIR": ""}},
                             base=cfg_from_file(str(cfg_dir / "df_gan_damsm.yml")))
    ln = cfg_from_file(str(cfg_dir / "ln_coco_256.yml"))
    fs, ls = epilogue_shapes(flagship, 128), epilogue_shapes(ln, ln.TRAIN.BATCH_SIZE)
    return {"flagship fp32": {"dtype": "float32", "shapes": fs},
            "flagship bf16": {"dtype": "bfloat16", "shapes": fs},
            "LN bf16": {"dtype": "bfloat16", "shapes": ls}}


def main() -> int:
    ap = parser(__doc__, iters=10)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--sets", nargs="*", help="the sets to time (default: all three)")
    args = ap.parse_args()
    trees = [t.resolve() for t in args.trees]
    record = Record(trees, args.out)
    if args.sass:
        record.add("sass", sass(trees, "fused_affine.cu", keep=lambda name: "bwd" not in name))
    if args.step:
        record.add("step", {str(t): run_child(t, STEP_CHILD, {}) for t in trees})
    payload = {"sets": {k: v for k, v in sets().items() if not args.sets or k in args.sets},
               "iters": args.iters}
    in_turns(trees, args.rounds, CHILD, payload, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
