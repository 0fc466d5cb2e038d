"""Device time on the card: CUDA events around calls, and the kernels of one call from a trace.

``cuda_ms`` times calls with CUDA events (the device's clock, host time
between launches included).  ``device_kernels`` reads the kernels that one
call launches from a ``torch.profiler`` (CUPTI) trace, and takes the trace
again where it is not whole: on the H100 machine a trace has come back
without the kernels of its first launches (``_OPENERS``).  ``chip_smoke.py``,
the ``*_turns`` timing tools and the card tests read every trace through
it.  ``read_trace`` reads a trace that a program wrote itself (the
trainer's ``profile_dir``).  Imports torch only; needs a GPU when called.
"""

from __future__ import annotations

import json
import math
import os
import re
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["cuda_ms", "device_kernels", "read_trace"]

_SPAN = "profiling.device_kernels"  # the traced call's annotation
_LAUNCH = re.compile(r"^cuda(LaunchKernel|LaunchKernelExC)(_v\d+)?$")  # runtime launch calls
_TRIES = 3
# Launches of a one-element fill that open every trace, before the traced
# call.  On the H100 machine a trace lost the kernels of its first N
# launches, N from 0 to 5 in one ``chip_smoke.py`` process and growing from
# trace to trace, whatever the time between the launches; these absorb them.
_OPENERS = 256


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


def _trace(fn) -> tuple[list[dict], float]:
    opener = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(_OPENERS):
            opener.zero_()
        torch.cuda.synchronize()
        with record_function(_SPAN):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], wall_ms


def _read(events: list[dict], copies: bool) -> tuple[list[dict], list[str]]:
    """The call's device events in start order, and the runtime kernel
    launches inside its span that have no kernel in the trace (each as its
    place among the span's launches and the op that made it)."""
    span = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == _SPAN)
    lo, hi = span["ts"], span["ts"] + span["dur"]
    ops = {e["args"].get("External id"): e for e in events if e.get("cat") == "cpu_op"}
    host = {e["args"].get("correlation"): e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    cats = ("kernel", "gpu_memcpy", "gpu_memset") if copies else ("kernel",)
    device, ran = [], {}
    for e in sorted((e for e in events if e.get("cat") in cats), key=lambda e: e["ts"]):
        corr = e["args"].get("correlation")
        ran[corr] = e["name"]
        call = host.get(corr)
        # the call's own: launched inside its span (or with no host record, run inside it)
        if not (lo <= call["ts"] <= hi if call else e["ts"] >= lo):
            continue
        op = ops.get(call["args"].get("External id")) if call else None
        device.append({"name": e["name"], "ts": e["ts"], "ms": e["dur"] / 1e3,
                       "stream": e["args"].get("stream"),
                       "op": op and op["name"], "dims": op and op["args"].get("Input Dims"),
                       "grid": e["args"].get("grid"), "block": e["args"].get("block")})
    launches = sorted((e["ts"], c, e) for c, e in host.items() if e.get("cat") == "cuda_runtime"
                      and _LAUNCH.match(e["name"]) and lo <= e["ts"] <= hi)
    lost = []
    for i, (_, c, e) in enumerate(launches):
        if c not in ran:
            op = ops.get(e["args"].get("External id"))
            before = ran.get(launches[i - 1][1], "?")[:80] if i else None
            lost.append(f"launch {i + 1} of {len(launches)} (op {op and op['name']}, after "
                        f"{before})")
    return device, lost


def device_kernels(fn, expect: dict[str, int] | None = None,
                   copies: bool = False) -> tuple[list[dict], float, float]:
    """The CUDA kernels that one call of ``fn``, which has run before,
    launches, from a ``torch.profiler`` trace of it: ``[{"name", "ts",
    "ms", "stream", "op", "dims", "grid", "block"}]`` in start order (``ts``
    in the trace's µs; ``op`` and
    ``dims``: the PyTorch op that launched the kernel and its input shapes;
    ``grid`` and ``block`` as the trace gives them), the device's busy ms
    (the union of the kernels' intervals: cuDNN runs some kernels on side
    streams, so their sum can exceed it), and the call's wall ms under the
    profiler.  ``copies`` adds the device's copies and fills, which are not
    kernels (a ``clone`` of a dense tensor is one copy).

    The trace must be whole: it holds a kernel, every kernel launch of the
    runtime's in the call's span has its kernel, and for each pattern of
    ``expect`` exactly that many kernels' names match it (``re.search``).
    A trace that is not is taken again, three times in all, then this
    raises."""
    for _ in range(_TRIES):
        events, wall_ms = _trace(fn)
        kernels, lost = _read(events, copies)
        counts = {pat: sum(bool(re.search(pat, k["name"])) for k in kernels)
                  for pat in expect or {}}
        if kernels and not lost and counts == dict(expect or {}):
            break
    else:
        raise RuntimeError(f"torch.profiler's trace was not whole {_TRIES} times in a row: "
                           f"{len(kernels)} kernels, launches without their kernel {lost}, "
                           f"kernels by pattern {counts}, want {expect}")
    busy_us, end = 0.0, -math.inf
    for k in kernels:  # in start order
        stop = k["ts"] + k["ms"] * 1e3
        busy_us += max(0.0, stop - max(k["ts"], end))
        end = max(end, stop)
    return kernels, busy_us / 1e3, wall_ms


def read_trace(path: str) -> dict:
    """The CUDA kernels of a Chrome trace that ``torch.profiler`` wrote
    (e.g. ``Trainer(profile_dir=...)``), with no span of its own: the
    kernels' names in start order, the device's busy ms (the union of their
    intervals), the trace's span ms (first event's start to last event's
    end, host events included), the number of runtime kernel launches, and
    the places among them (0 = the first) of those that have no kernel in
    the trace (``lost``: such a trace is not whole; ``_OPENERS`` says where
    the H100 machine loses them).  It cannot be taken again, as
    ``device_kernels`` does."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    ran = {e["args"].get("correlation") for e in kernels}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and _LAUNCH.match(e["name"])), key=lambda e: e["ts"])
    lost = [i for i, e in enumerate(launches) if e["args"].get("correlation") not in ran]
    timed = [e for e in events if "ts" in e and "dur" in e]
    span_us = max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
    busy_us, end = 0.0, -math.inf
    for k in kernels:
        stop = k["ts"] + k["dur"]
        busy_us += max(0.0, stop - max(k["ts"], end))
        end = max(end, stop)
    return {"names": [k["name"] for k in kernels], "busy_ms": busy_us / 1e3,
            "span_ms": span_us / 1e3, "launches": len(launches), "lost": lost}
