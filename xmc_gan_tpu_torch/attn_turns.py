"""The cross_attention kernels at the In sampler's shapes on the card, one tree or several in turns.

    python -m xmc_gan_tpu_torch.attn_turns [--trees DIR ...] [--rounds R] [--suspects]
                                           [--bwd] [--words] [--outattn] [--sass]
                                           [--out FILE]

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
...), so a drift of the card's clocks falls on both alike (``turns``).

``--suspects`` adds, per tree and dtype, the same ten launches, the
queries as rows,
  * with the queries dense (``[B, G, N, D]`` contiguous) instead,
  * with every caption 0 (all padded), 1 and 15 words long,
and, as a yardstick of the bytes alone, a ``clone`` of the dense queries
(the same bytes read and written once).

``--bwd`` times the backward instead: the 6 In and the 6 Out backward
launches of one 64² word-attention train step (``concept_in_df_gan.yml``,
batch 88, T = 15; ``chip_smoke.attention_bwd_calls``' inputs: In, the
queries as planes, the keys ``[B, G, D, T]`` in memory, dO dense; Out, dO a
slice of the ``[B, 16, 360]`` condition's gradient) through each tree's
``_launch_bwd``, each launch after an L2 flush (a 256 MB fill), from whole
traces: the kernels' device time per launch (median over ``--iters``) and
their sum per set, beside the 6 launches timed back to back with CUDA
events.

``--words`` times the backward's N = 4,096 In launch of that step alone
(the same inputs) with every caption 0, 8 and 15 words long, with the
step's mixed lengths (uniform in 1..15) and with those lengths sorted over
the rows, and with values apart from the keys: how the time follows the
real words, the rows' mix and the keys passed as the values.

``--outattn`` times the forward at the Out sampler's shape instead: the 10
launches of one 256², batch-128 ``CONCEPT_OUTATTN_GEN`` request (B = 128,
N = 16, T = 15, D = 4; inputs as ``chip_smoke.py`` phase 7 draws them:
l2-normalized, the keys passed as the values, caption lengths uniform in
1..15) through each tree's ``masked_cross_attention_kernel``, fp32 and
bf16: each launch after an L2 flush, from whole traces (the kernels'
device time per launch, median over ``--iters``, and their sum), beside
the 10 timed back to back with CUDA events; and the wrapper's host µs a
call (the enqueue, the device keeping up), whole and by the parts a
wrapper may take: the checks, the plan, the operands' 4-D views, the
output's allocation, entering ``torch.cuda.device``, reading the current
stream, and the ``ctypes`` call that launches (a tree's wrapper that makes
no view, or enters the device only for another card, skips those parts;
each is timed all the same).

``--sass`` builds the first two trees' ``csrc/cross_attention.cu`` and
compares the SASS of every kernel the first tree's build has with the
second's.

Prints the card's name and power limit, one JSON line per tree and turn, and
each measurement's median over the rounds; ``--out`` also writes them as
JSON.  Needs a GPU and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import sys

from xmc_gan_tpu_torch.turns import Record, in_turns, parser, sass

# the ten In launches of one 256², NCH=32 request at batch 128: (B, G, N, T, D)
# (models.concept_gan.attention_shapes; fixed here so every tree times the same)
IN_SHAPES = [(128, 16, n, 15, 4) for n in (256, 1024, 1024, 4096, 4096, 16384, 16384,
                                            65536, 65536, 65536)]
# the backward launches of one 64² word-attention train step at batch 88
BWD_SHAPES = {"in": [(88, 16, n, 15, 4) for n in (256, 1024, 1024, 4096, 4096, 4096)],
              "out": [(88, 1, 16, 15, 4)] * 6, "words": [(88, 16, 4096, 15, 4)]}
# the ten Out launches of one 256², NCH=32 request at batch 128
OUT_SHAPES = [(128, 1, 16, 15, 4)] * 10

CHILD = r"""
import torch
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca

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

        out[f"{name} {label}"] = profiling.cuda_ms(run, args["iters"])
        if label == "dense q":
            dense_q = [c[0] for c in calls]
            out[f"{name} copy"] = profiling.cuda_ms(lambda: [x.clone() for x in dense_q],
                                                    args["iters"])
            del dense_q
        del calls
        torch.cuda.empty_cache()
print(json.dumps(out))
"""


BWD_CHILD = r"""
import statistics, sys
import torch
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca

iters = args["iters"]
ca.KERNEL.load()
norm = torch.nn.functional.normalize
flush = torch.empty(2**26, device="cuda")  # 256 MB: more than the L2 holds
pattern = "attn_bwd"


def calls(which, dtype, gen):
    out = []
    for b, g, n, t, d in args["shapes"][which]:
        if which != "out":
            q = norm(torch.randn(b, n, g, d, generator=gen, device="cuda"), dim=-1).to(dtype)
            k = norm(torch.randn(b, t, g, d, generator=gen, device="cuda"), dim=-1).to(dtype)
            q = q.permute(0, 2, 3, 1).contiguous().transpose(2, 3)  # planes, [B, G, D, N]
            k = k.permute(0, 2, 3, 1).contiguous().transpose(2, 3)  # [B, G, D, T] in memory
            dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        else:  # the Out block's [B, 16, D] states
            q = torch.randn(b, n, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, t, d, generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, n, 356 + d), generator=gen, device="cuda").to(dtype)[..., 356:]
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        mask = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        out.append((q, k, mask, dout))
    return out


def timed(cs, values=None):
    # the launches back to back (CUDA events), then each launch's device time
    # after an L2 flush, iters times in launch order, from a whole trace
    one = lambda c: ca._launch_bwd(c[0], c[1], c[1] if values is None else values, c[2], c[3],
                                   1.0)
    ms = profiling.cuda_ms(lambda: [one(c) for c in cs], iters)
    seen = profiling.device_kernels(
        lambda: [(flush.zero_(), one(c)) for _ in range(iters) for c in cs],
        expect={pattern: iters * len(cs)})[0]
    return ms, [x["ms"] for x in seen if pattern in x["name"]], seen


out = {}
if args["words"]:
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        (q, k, mask, dout), = calls("words", dtype, torch.Generator(device="cuda").manual_seed(16))
        b, t = mask.shape
        lens = (~mask).sum(1)
        for label in ("0", "8", "15", "mixed", "mixed sorted", "mixed, values apart"):
            if label[0].isdigit():
                n_words = torch.full((b,), int(label), device="cuda")
            else:
                n_words = lens.sort(descending=True).values if "sorted" in label else lens
            m = torch.arange(t, device="cuda")[None, :] >= n_words[:, None]
            ms, times, _ = timed([(q, k, m, dout)], k.clone() if "apart" in label else None)
            out[f"{name} {label}"] = {"kernel_ms": statistics.median(times), "events_ms": ms}
        torch.cuda.empty_cache()
    print(json.dumps(out))
    sys.exit(0)
for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
    for which in ("in", "out"):
        cs = calls(which, dtype, torch.Generator(device="cuda").manual_seed(16))
        ms, times, seen = timed(cs)
        per_launch = {f"{i}: N={s[2]}": statistics.median(times[i::len(cs)])
                      for i, s in enumerate(args["shapes"][which])}
        out[f"{name} {which}"] = {"kernel_ms": sum(per_launch.values()), "events_ms": ms,
                                  "kernels": sorted({x["name"][x["name"].index(pattern):]
                                                     .split("(")[0] for x in seen
                                                     if pattern in x["name"]}),
                                  "per_launch_ms": per_launch}
        del cs
        torch.cuda.empty_cache()
print(json.dumps(out))
"""


OUT_CHILD = r"""
import re, statistics, time
import torch
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca

iters = args["iters"]
ca.KERNEL.load()
norm = torch.nn.functional.normalize
flush = torch.empty(2**26, device="cuda")  # 256 MB: more than the L2 holds
pattern = r"attn_(small|wide|grouped|short)<"


def calls(dtype, gen):
    out = []
    for b, g, n, t, d in args["shapes"]:  # the Out block's [B, N, D] and [B, T, D]
        q = norm(torch.randn(b, n, d, generator=gen, device="cuda"), dim=-1).to(dtype)
        k = norm(torch.randn(b, t, d, generator=gen, device="cuda"), dim=-1).to(dtype)
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        out.append((q, k, k, torch.arange(t, device="cuda")[None, :] >= lens[:, None]))
    return out


def host_us(fn, reps=500):
    # the host's µs a call of fn, the device keeping up (synchronized outside the time)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


out = {}
for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
    cs = calls(dtype, torch.Generator(device="cuda").manual_seed(6))
    run = lambda: [ca.masked_cross_attention_kernel(*c, 1.0) for c in cs]
    ms = profiling.cuda_ms(run, iters)
    seen = profiling.device_kernels(
        lambda: [(flush.zero_(), ca.masked_cross_attention_kernel(*c, 1.0))
                 for _ in range(iters) for c in cs], expect={pattern: iters * len(cs)})[0]
    times = [x["ms"] for x in seen if re.search(pattern, x["name"])]
    per_launch = {f"{i}": statistics.median(times[i::len(cs)]) for i in range(len(cs))}
    q, k, v, mask = cs[0]
    p = ca.plan_for(q, k)
    q4, k4, v4 = ca._view4(q), ca._view4(k), ca._view4(v)
    o = torch.empty(q4.shape, device="cuda", dtype=dtype)
    fn = ca.KERNEL.load().xmc_cross_attention
    stream = torch.cuda.current_stream().cuda_stream
    launch = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask.data_ptr(), o.data_ptr(),
              *q4.shape, k4.shape[2], *q4.stride(), *k4.stride(), *v4.stride(),
              *o.stride()[:3], 1.0, ca._DTYPE_CODE[dtype], ca._KERNEL_CODE[p.kernel],
              int(p.planes), p.threads, p.blocks, p.tile, p.tiles_per_block, stream)

    def device_ctx():
        with torch.cuda.device(q.device):
            pass

    host = {"call": host_us(lambda: ca.masked_cross_attention_kernel(q, k, v, mask, 1.0)),
            "check": host_us(lambda: ca._check(q, k, v, mask)),
            "plan": host_us(lambda: ca.plan_for(q, k)),
            "views": host_us(lambda: (ca._view4(q), ca._view4(k), ca._view4(v))),
            "alloc": host_us(lambda: torch.empty(q4.shape, device="cuda", dtype=dtype)),
            "device_ctx": host_us(device_ctx),
            "stream": host_us(lambda: torch.cuda.current_stream(q.device).cuda_stream),
            "ctypes": host_us(lambda: fn(*launch))}
    out[name] = {"kernel_ms": sum(per_launch.values()), "events_ms": ms,
                 "kernels": sorted({re.search(r"attn_\w+<[^>]*>", x["name"]).group(0)
                                    for x in seen if re.search(pattern, x["name"])}),
                 "plan": [str(p)], "host_us": host, "per_launch_ms": per_launch}
    del cs
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main() -> int:
    ap = parser(__doc__, iters=5)
    ap.add_argument("--suspects", action="store_true")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--words", action="store_true")
    ap.add_argument("--outattn", action="store_true")
    args = ap.parse_args()
    trees = [t.resolve() for t in args.trees]
    record = Record(trees, args.out)
    if args.sass:
        record.add("sass", sass(trees, "cross_attention.cu"))
    if args.outattn:
        in_turns(trees, args.rounds, OUT_CHILD, {"shapes": OUT_SHAPES, "iters": args.iters},
                 record)
    elif args.bwd or args.words:
        in_turns(trees, args.rounds, BWD_CHILD,
                 {"shapes": BWD_SHAPES, "iters": args.iters, "words": args.words}, record)
    else:
        in_turns(trees, args.rounds, CHILD,
                 {"shapes": IN_SHAPES, "suspects": args.suspects, "iters": args.iters}, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
