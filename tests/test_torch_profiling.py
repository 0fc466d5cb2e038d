"""The trace reader behind every profiled number of the port, and the turns driver's medians, on the CPU.

``profiling._read`` gets synthetic chrome-trace events, as ``torch.profiler``
exports them: a call's span, its runtime launches and their kernels.
"""

import pytest

from xmc_gan_tpu_torch import profiling, turns


def _trace(lost=(), extra=()):
    """An opener kernel before the span, then three launches in it (one by
    an op, two from the autograd thread without one); ``lost`` drops those
    launches' kernels, ``extra`` adds device events."""
    events = [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0,
               "args": {"correlation": 1}},
              {"cat": "kernel", "name": "opener", "ts": 2.0, "dur": 1.0,
               "args": {"correlation": 1}},
              {"cat": "user_annotation", "name": profiling._SPAN, "ts": 10.0, "dur": 100.0,
               "args": {}},
              {"cat": "cpu_op", "name": "aten::mul", "ts": 11.0, "dur": 2.0,
               "args": {"External id": 7, "Input Dims": [[2, 3]]}}]
    for corr, ts in ((2, 12.0), (3, 20.0), (4, 30.0)):
        args = {"correlation": corr, **({"External id": 7} if corr == 2 else {})}
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                       "args": args})
        if corr not in lost:
            events.append({"cat": "kernel", "name": f"k{corr}", "ts": ts + 5.0, "dur": 4.0,
                           "args": {"correlation": corr, "stream": 7, "grid": [corr, 1, 1],
                                    "block": [256, 1, 1]}})
    return events + list(extra)


def test_read_keeps_the_calls_kernels_and_counts_none_lost():
    kernels, lost = profiling._read(_trace(), copies=False)
    assert lost == []
    assert [k["name"] for k in kernels] == ["k2", "k3", "k4"]  # the opener left out
    assert kernels[0]["op"] == "aten::mul" and kernels[0]["dims"] == [[2, 3]]
    assert kernels[1]["op"] is None and kernels[1]["grid"] == [3, 1, 1]
    assert kernels[2]["block"] == [256, 1, 1] and kernels[2]["ms"] == pytest.approx(4e-3)


@pytest.mark.parametrize("lost", [(2,), (3, 4), (2, 3, 4)])
def test_read_counts_launches_whose_kernel_the_trace_lost(lost):
    kernels, missing = profiling._read(_trace(lost=lost), copies=False)
    assert len(missing) == len(lost) and len(kernels) == 3 - len(lost)
    assert missing[0].startswith(f"launch {lost[0] - 1} of 3 (op ")
    if lost == (2,):
        assert missing == ["launch 1 of 3 (op aten::mul, after None)"]
    if lost == (3, 4):
        assert missing[0] == "launch 2 of 3 (op None, after k2)"


def test_read_takes_copies_only_when_asked():
    copy = [{"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 40.0,
             "args": {"correlation": 5}},
            {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 45.0,
             "dur": 3.0, "args": {"correlation": 5}}]
    assert [k["name"] for k in profiling._read(_trace(extra=copy), copies=False)[0]] == [
        "k2", "k3", "k4"]
    kernels, lost = profiling._read(_trace(extra=copy), copies=True)
    assert lost == [] and kernels[-1]["name"].startswith("Memcpy DtoD")


def test_read_keeps_a_kernel_with_no_host_record_only_inside_the_span():
    orphans = [{"cat": "kernel", "name": "early", "ts": 5.0, "dur": 1.0,
                "args": {"correlation": 90}},
               {"cat": "kernel", "name": "driver launched", "ts": 50.0, "dur": 1.0,
                "args": {"correlation": 91}}]
    kernels, lost = profiling._read(_trace(extra=orphans), copies=False)
    assert lost == [] and [k["name"] for k in kernels] == ["k2", "k3", "k4", "driver launched"]


def test_turns_median_folds_nested_results_and_leaves_lists_out():
    runs = [{"a": {"ms": 1.0, "by_shape": [1]}, "b": 5.0},
            {"a": {"ms": 3.0, "by_shape": [2]}, "b": 4.0},
            {"a": {"ms": 2.0, "by_shape": [3]}, "b": 9.0}]
    assert turns.median(runs) == {"a": {"ms": 2.0}, "b": 5.0}


@pytest.mark.parametrize("lost", [(), (3,)])
def test_read_trace_reads_a_programs_own_trace(lost, tmp_path):
    """``read_trace`` (the trainer's ``profile_dir`` trace): every kernel in
    start order, the busy ms as the union of overlapping kernels, the span
    over every timed event and the launches without their kernel."""
    import json

    overlap = {"cat": "kernel", "name": "side", "ts": 24.0, "dur": 8.0, "args": {"correlation": 9}}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace(lost=lost, extra=[overlap])}))
    got = profiling.read_trace(str(path))
    names = ["opener", "k2", "side", "k3", "k4"]
    assert got["names"] == [n for n in names if n != "k3" or not lost]
    # opener 2-3, k2 17-21, side 24-32, k3 25-29, k4 35-39
    assert got["busy_ms"] == pytest.approx((1 + 4 + 8 + 4) / 1e3)
    assert got["span_ms"] == pytest.approx((110 - 2) / 1e3)
    assert got["launches"] == 4 and got["lost"] == ([2] if lost else [])
