"""Reading a trace: busy and idle time of the window, the idle stretches
named by what the host's main thread was doing, and kernels attributed to
a program scope by their launches' correlation ids."""

import json

import pytest

from port_bench import tracing


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summary_of_a_made_up_trace(tmp_path):
    events = [
        ev("user_annotation", tracing.WINDOW, 1000, 1000),
        ev("user_annotation", "bench.step", 1000, 300),
        ev("user_annotation", "DLRM embedding forward", 1010, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 1020, 5, corr=7),
        ev("cuda_runtime", "cudaLaunchKernel", 1200, 5, corr=8),
        ev("user_annotation", "bench.next_batch", 1300, 600),
        ev("kernel", "lookup", 1100, 200, tid=9, corr=7),
        ev("kernel", "tower", 1250, 150, tid=9, corr=8),
        ev("gpu_memcpy", "Memcpy HtoD", 1800, 100, tid=10),
        ev("kernel", "before the window", 900, 50, tid=9, corr=1),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tracing.summarize(str(path), 2, scopes=["DLRM embedding forward"])
    assert s.window_s == pytest.approx(1e-3)
    # device busy 1100-1400 and 1800-1900
    assert s.busy_s == pytest.approx(400e-6)
    assert s.kernels == 2
    assert s.scope_s["DLRM embedding forward"] == pytest.approx(200e-6)
    assert dict(s.device_ops)["lookup"] == pytest.approx(200e-6)
    # idle 1400-1800 while the host waited for a batch, 1000-1100 in the
    # step, 1900-2000 in no span of the harness
    assert s.idle_gaps[0] == ("bench.next_batch", pytest.approx(400e-6))
    assert {n for n, _ in s.idle_gaps} == {
        "bench.step", "bench.next_batch", "python (no span)"}
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(600e-6)
    b = tracing.breakdown(s)
    assert set(b) == {"device_ops", "idle_gaps"}


def test_a_trace_without_the_window_is_refused(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [ev("kernel", "k", 1, 1)]}))
    with pytest.raises(ValueError):
        tracing.summarize(str(path), 1)
