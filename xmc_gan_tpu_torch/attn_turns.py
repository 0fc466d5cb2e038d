"""The cross_attention kernels at the In sampler's shapes on the card, one tree or several in turns.

    python -m xmc_gan_tpu_torch.attn_turns [--trees DIR ...] [--rounds R] [--suspects]
                                           [--sass] [--out FILE]

Each tree is a checkout of this repository (default: this one).  For each, a
child process whose working directory and first import path is the tree
builds that tree's ``csrc/cross_attention.cu`` and times with CUDA events the
ten launches of one 256², NCH=32, batch-128 ``CONCEPT_INATTN_GEN`` request
through that tree's ``masked_cross_attention_kernel``, fp32 and bf16, on
inputs drawn as ``chip_smoke.py`` phase 7 draws them: queries and keys
l2-normalized, caption lengths uniform in 1..15, the keys passed as the
values and laid out as the In sampler's (``[B, G, D, T]`` in memory, seen as
``[B, G, T, D]``), the queries as planes (``[B, G, D, N]``: "request", the
layout the sampler hands over on the card, where its GroupNorm returns
NCHW) and as rows (``[B, N, G, D]``: "rows q", the channels_last query map,
as on the CPU).  With several trees each
round runs them in turns, the order reversed every other round (A B, B A,
...), so a drift of the card's clocks falls on both alike.

``--suspects`` adds, per tree and dtype, the same ten launches, the
queries as rows,
  * with the queries dense (``[B, G, N, D]`` contiguous) instead,
  * with every caption 0 (all padded), 1 and 15 words long,
and, as a yardstick of the bytes alone, a ``clone`` of the dense queries
(the same bytes read and written once).

``--sass`` builds the first two trees' ``csrc/cross_attention.cu`` and
compares the SASS of every kernel the first tree's build has with the
second's.

Prints the card's name and power limit, one JSON line per tree and turn, and
each measurement's median over the rounds; ``--out`` also writes them as
JSON.  Needs a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# the ten In launches of one 256², NCH=32 request at batch 128: (B, G, N, T, D)
# (models.concept_gan.attention_shapes; fixed here so every tree times the same)
IN_SHAPES = [(128, 16, n, 15, 4) for n in (256, 1024, 1024, 4096, 4096, 16384, 16384,
                                            65536, 65536, 65536)]

CHILD = r"""
import json, sys, torch
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca

args = json.loads(sys.argv[1])
shapes = [tuple(s) for s in args["shapes"]]
ca.KERNEL.load()
norm = torch.nn.functional.normalize


def inputs(dtype, gen, words, layout):
    calls = {}
    for s in sorted(set(shapes)):
        b, g, n, t, d = s
        q = norm(torch.randn(b, n, g, d, generator=gen, device="cuda"), dim=-1).to(dtype)
        k = norm(torch.randn(b, t, g, d, generator=gen, device="cuda"), dim=-1).to(dtype)
        q = q.transpose(1, 2)
        k = k.permute(0, 2, 3, 1).contiguous().transpose(2, 3)  # [B, G, D, T] in memory
        if layout == "planes":
            q = q.permute(0, 1, 3, 2).contiguous().transpose(2, 3)
        elif layout == "dense":
            q = q.contiguous()
        if words is None:
            lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        else:
            lens = torch.full((b,), words, device="cuda")
        calls[s] = (q, k, k, torch.arange(t, device="cuda")[None, :] >= lens[:, None])
    return [calls[s] for s in shapes]


def ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


out = {}
variants = {"request": (None, "planes"), "rows q": (None, "rows")}
if args["suspects"]:
    variants.update({"dense q": (None, "dense"), "0 words": (0, "rows"),
                     "1 word": (1, "rows"), "15 words": (15, "rows")})
for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
    for label, (words, layout) in variants.items():
        calls = inputs(dtype, torch.Generator(device="cuda").manual_seed(6), words, layout)

        def run():
            for q, k, v, mask in calls:
                ca.masked_cross_attention_kernel(q, k, v, mask, 1.0)

        out[f"{name} {label}"] = ms(run, args["iters"])
        if label == "dense q":
            dense_q = [c[0] for c in calls]
            out[f"{name} copy"] = ms(lambda: [x.clone() for x in dense_q], args["iters"])
            del dense_q
        del calls
        torch.cuda.empty_cache()
print(json.dumps(out))
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_tree(tree: Path, suspects: bool, iters: int) -> dict:
    args = json.dumps({"shapes": IN_SHAPES, "suspects": suspects, "iters": iters})
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, "-c", CHILD, args], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sass(trees: list[Path]) -> dict:
    """The SASS of each kernel of the first tree's build against the second's."""
    sys.path.insert(0, str(REPO))
    from xmc_gan_tpu_torch.ops.cuda.build import NVCC_FLAGS, find_nvcc

    nvcc = find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    funcs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees[:2]):
            lib = os.path.join(tmp, f"lib{i}.so")
            subprocess.run([nvcc, *NVCC_FLAGS, "-o", lib,
                            str(tree / "xmc_gan_tpu_torch" / "csrc" / "cross_attention.cu")],
                           check=True, capture_output=True)
            text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                                  check=True).stdout
            # the anonymous namespace's name carries a per-file hash
            text = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON", text)
            parts = {}
            for part in re.split(r"\n\s*Function : ", text)[1:]:
                name, body = part.split("\n", 1)
                parts[name.strip()] = re.sub(r"[ \t]+", " ", body.split("\n\t\t..........")[0])
            funcs.append(parts)
    first, second = funcs
    return {"identical": sorted(n for n in first if second.get(n) == first[n]),
            "differ": sorted(n for n in first if n in second and second[n] != first[n]),
            "missing": sorted(n for n in first if n not in second),
            "new": sorted(n for n in second if n not in first)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="*", type=Path, default=[REPO])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--suspects", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    trees = [t.resolve() for t in args.trees]
    result = {"card": card(), "trees": [str(t) for t in trees], "turns": []}
    print(result["card"], flush=True)
    if args.sass:
        if len(trees) < 2:
            raise SystemExit("--sass compares two trees")
        result["sass"] = sass(trees)
        print(json.dumps({"sass": result["sass"]}), flush=True)
    for r in range(args.rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            times = time_tree(tree, args.suspects, args.iters)
            result["turns"].append({"tree": str(tree), "round": r, "ms": times})
            print(json.dumps(result["turns"][-1]), flush=True)
    if result["turns"]:
        result["median_ms"] = {
            str(tree): {key: statistics.median(t["ms"][key] for t in result["turns"]
                                               if t["tree"] == str(tree))
                        for key in result["turns"][0]["ms"]}
            for tree in trees}
        print(json.dumps({"median_ms": result["median_ms"]}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
