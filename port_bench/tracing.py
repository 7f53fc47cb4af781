"""Reading a traced run: the chrome trace that the program's own profiler
(dlrm_tpu_torch/utils/profiling.py::profile, entered so that its scopes are
live) writes, reduced to what the per-layer metrics read.

The benchmark marks the traced stretch with a span of its own, WINDOW, and
the host's phases inside it with spans named bench.*. From the trace:
  busy_s      the union of the device's operations (kernels, copies, sets)
              that start inside the window
  window_s    the window span's length (it ends after a synchronize, so
              every operation it started has ended)
  device_ops  device seconds by operation name
  idle_gaps   the device's idle stretches, each named by the innermost span
              or operation of the host's main thread at the stretch's start
  scope_s     device seconds of the kernels launched under each of the
              program's scopes (by the launch's correlation id)
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


def span(name: str, on: bool):
    """A host span in the trace while tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@dataclass
class Summary:
    """What a traced stretch of `steps` steps (or batches) shows."""

    window_s: float
    busy_s: float
    steps: int
    kernels: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    scope_s: Dict[str, float]
    op_s: Dict[str, float]
    kind: str = ""  # the driver's: "train" or "serve"
    host_ms: Dict[str, List[float]] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)
    power: str = ""


def _union(intervals: Sequence[Tuple[float, float]]):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(events, t: float) -> str:
    best = None
    for e in events:
        if e["ts"] <= t < e["ts"] + e["dur"] and (
                best is None or e["dur"] < best["dur"]):
            best = e
    return "python (no span)" if best is None else best["name"]


def summarize(path: str, steps: int, scopes: Sequence[str] = ()) -> Summary:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"] == WINDOW]
    if len(win) != 1:
        raise ValueError(f"{len(win)} {WINDOW} spans in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    main = win[0]["tid"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(b - a for a, b in merged)

    op_s: Dict[str, float] = {}
    for e in dev:
        op_s[e["name"]] = op_s.get(e["name"], 0.0) + e["dur"] * 1e-6
    ranked = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]

    host = [e for e in events if e.get("tid") == main
            and e.get("cat") in HOST_CATS and e["name"] != WINDOW
            and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1] - edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    idle = [(_innermost(host, start + 1e-3), dur * 1e-6)
            for start, dur in gaps]

    scope_s = {}
    kernels = {e["args"]["correlation"]: e for e in dev
               if e.get("cat") == "kernel" and "correlation" in e.get(
                   "args", {})}
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})]
    for name in scopes:
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"] == name and w0 <= e["ts"] < w1]
        corr = {e["args"]["correlation"] for e in launches for s in spans
                if e["tid"] == s["tid"]
                and s["ts"] <= e["ts"] < s["ts"] + s["dur"]}
        scope_s[name] = sum(kernels[c]["dur"] for c in corr
                            if c in kernels) * 1e-6
    return Summary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, steps=steps,
        kernels=sum(1 for e in dev if e.get("cat") == "kernel"),
        device_ops=[(n[:120], s) for n, s in ranked], idle_gaps=idle,
        scope_s=scope_s, op_s=op_s)


def breakdown(s: Summary) -> dict:
    return {"device_ops": [[n, v] for n, v in s.device_ops],
            "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
