"""The loop of a serving cell: DLRMModel.apply on row-wise int8 tables
(params["emb"] = {"quantized": {"packed": ...}}, ops/quantized.py's lookup)
with the towers in the configuration's compute dtype, a closed loop over a
pool of host batches.

Set-up: the model; the int8 rows filled and the dense parameters drawn on
the card from the seed; the pool from the traffic's generator; a warm-up
through the window's own loop.

Host: the process runs the configuration's `host_threads` intra-op threads
(the pinned copies), and the waiter sleeps on its event instead of spinning,
so that the dispatching thread keeps a core on a shared host.

Window: closed, with `in_flight` batches outstanding. A batch is dispatched
(its H2D by HostBatch.to_device, the forward, the D2H of its scores into
pinned host memory) once the batch `in_flight` before it has its scores in
host memory; a waiter thread stamps each batch's arrival on the host clock
as its event completes. The rate counts the examples whose scores arrived
inside the window; the tail is over every batch dispatched in it, from its
dispatch to its scores' arrival, those that arrive after the window closed
included. A traced run profiles a bounded stretch of batches with the
program's profiler on, so that its scopes ("DLRM embedding forward") are
live.

Correctness (reference/dlrm_ref.py::serve_probs): every batch's scores,
warm-up and window, against the reference's probabilities for its pool
batch, from the same int8 bytes and dense parameters; it runs once the
window has closed and the peak memory has been read.
"""

from __future__ import annotations

import contextlib
import gc
import os
import queue
import shutil
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from port_bench import core, program, tracing, weights
from port_bench.reference import dlrm_ref
from port_bench.roofline import work


class ClosedLoop:
    """Dispatch and arrival of scored batches, `in_flight` outstanding."""

    def __init__(self, dispatch: Callable, in_flight: int, dev):
        self.dispatch = dispatch
        self.in_flight = in_flight
        self.dev = dev
        self.sent: List[float] = []
        self.arrived: Dict[int, float] = {}
        self.scores: Dict[int, np.ndarray] = {}
        self.cond = threading.Condition()
        self.q: queue.Queue = queue.Queue()
        self.err: List[BaseException] = []
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            i, ready, out = item
            try:
                if ready is not None:
                    ready.synchronize()
                t = time.perf_counter()
                scores = out.numpy().copy()
            except BaseException as e:  # surface it in the main thread
                self.err.append(e)
                t, scores = time.perf_counter(), None
            with self.cond:
                self.arrived[i] = t
                self.scores[i] = scores
                self.cond.notify_all()

    def send(self, i: int) -> None:
        """Dispatch batch i once batch i - in_flight has arrived."""
        with self.cond:
            self.cond.wait_for(lambda: i - self.in_flight < 0
                               or i - self.in_flight in self.arrived)
        if self.err:
            raise self.err[0]
        self.sent.append(time.perf_counter())
        out = self.dispatch(i)
        ready = None
        if self.dev.type == "cuda":
            ready = torch.cuda.Event(blocking=True)
            ready.record()
        self.q.put((i, ready, out))

    def drain(self, n: int) -> None:
        with self.cond:
            self.cond.wait_for(lambda: len(self.arrived) >= n)

    def close(self) -> None:
        self.q.put(None)
        self.waiter.join()
        if self.err:
            raise self.err[0]


def run(cell: core.Cell, seed: int, seconds: float, trace: bool,
        dev: torch.device, stages: core.Stages,
        fault: Optional[Callable] = None, control: bool = False) -> dict:
    """fault: wraps the program's forward (tests break the timed path with
    it). control: serve with the program's int8 towers (quantize_mlps), the
    precision below the configuration's."""
    mc, pc, tr = cell.config["model"], cell.config["path"], cell.traffic
    sizes, hot, d = mc["table_sizes"], mc["hot_sizes"], mc["embedding_dim"]
    b, pool_n = int(tr["batch"]), int(tr["pool"])
    if "host_threads" in pc:
        torch.set_num_threads(int(pc["host_threads"]))
    net = program.model(mc)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    if not np.array_equal(offs, np.asarray(net.row_offsets, np.int64)):
        raise RuntimeError("the program's table layout is not the one the "
                           "benchmark fills")
    stages.mark("model")
    packed = weights.fill_int8(int(sum(sizes)), d, float(pc["amplitude"]),
                               seed, dev)
    dense = weights.draw_dense(mc, seed, dev)
    params = dict(dense, emb={"quantized": {"packed": packed}})
    if control:
        params = net.quantize_mlps(params, 8)

    @torch.no_grad()
    def forward(batch):
        return net.apply(params, batch, hot_sizes=tuple(hot))

    if fault is not None:
        forward = fault(forward)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages.mark("weights on the device")
    raw = cell.generator().pool(tr, sizes, hot, mc["mlp_bot"][0], seed)
    # the loader's work: each batch in the flat per-hit layout the device
    # reads (table-major), so the window ships it as it is
    cols = list(zip(core.hot_columns(hot), hot))
    host = [program.host_batch(dict(r, idx=np.concatenate(
        [r["idx"][:, c: c + h].ravel() for c, h in cols]))) for r in raw]
    pin = dev.type == "cuda"
    outs = [torch.empty((b, 1), dtype=torch.float32, pin_memory=pin)
            for _ in range(int(pc["in_flight"]) + 1)]

    def dispatch(i: int):
        with tracing.span("bench.dispatch", trace_on[0]):
            probs = forward(host[i % pool_n].to_device(dev))
            out = outs[i % len(outs)]
            out.copy_(probs.reshape(b, 1), non_blocking=pin)
        return out

    trace_on = [False]
    loop = ClosedLoop(dispatch, int(pc["in_flight"]), dev)
    stages.mark("host batches")
    warm = int(pc["warmup_batches"])
    for i in range(warm):
        loop.send(i)
    loop.drain(warm)
    stages.mark("warm-up batches")

    trace_dir = tempfile.mkdtemp(prefix="port_bench_trace_") if trace else None
    profiler = (program.profiling.profile(True, trace_dir) if trace
                else contextlib.nullcontext())
    trace_on[0] = trace
    i = warm
    gc.collect()
    gc.freeze()
    with profiler:
        with tracing.span(tracing.WINDOW, trace):
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < seconds and not (
                    trace and i - warm >= int(pc["trace_batches"])):
                loop.send(i)
                i += 1
            with tracing.span("bench.drain", trace):
                loop.drain(i)
            t_end = time.perf_counter()
    trace_on[0] = False
    gc.unfreeze()
    loop.close()
    setup_s = t_start - stages.t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n = i - warm
    window = range(warm, i)
    lat_ms = [(loop.arrived[j] - loop.sent[j]) * 1e3 for j in window]
    in_time = sum(1 for j in window if loop.arrived[j] <= t_start + seconds)
    per_s = np.bincount([int(loop.arrived[j] - t_start) for j in window])
    print(f"batches arrived in each second of the window: {per_s.tolist()}",
          file=sys.stderr)
    e2e = {"serve_examples_per_s": in_time * b / min(seconds, t_end - t_start),
           "serve_batch_p95_ms": float(np.percentile(lat_ms, 95)),
           "setup_s": setup_s}

    summary = None
    if trace:
        summary = tracing.summarize(
            os.path.join(trace_dir, program.profiling.TRACE_FILE), n,
            scopes=[program.profiling.EMB_FWD])
        shutil.rmtree(trace_dir, ignore_errors=True)
        summary.kind = "serve"
        distinct = [sum(len(np.unique(r["idx"][:, c: c + h]))
                        for c, h in cols) for r in raw]
        row_b = d + 8
        summary.work.update({
            "flops": float(n * work.model_flops(mc, b, train=False)),
            "bytes": float(sum(work.step_bytes(mc, b, distinct[j % pool_n],
                                               False, row_b)
                               for j in window))})

    ref = reference(packed, offs, raw, dense, hot, dev, "fp32")
    checks = core.Checks(cell.limits)
    gaps = {j: float(np.abs(loop.scores[j].reshape(-1)
                            - ref[j % pool_n]).max())
            for j in range(i)}
    checks.add("probs_gap", max(gaps.values()))
    if control:
        # the program's int8 towers (the control), and beside it the
        # reference computed in fp8
        ref8 = reference(packed, offs, raw, dense, hot, dev, "fp8")
        return {"control": {
            "probs_gap": max(gaps.values()),
            "fp8_reference_probs_gap": max(float(np.abs(a - r).max())
                                           for a, r in zip(ref8, ref))}}
    lim = cell.limits["probs_gap"]["limit"]
    return {"attempted": n, "failed": sum(1 for j in window if gaps[j] > lim),
            "e2e": e2e, "summary": summary, "checks": checks,
            "memory_peak_bytes": peak}


def reference(packed, offs, raw: List[dict], dense: dict, hot, dev,
              quant: str) -> List[np.ndarray]:
    """The reference's probabilities for each pool batch."""
    dlrm_ref.exact_matmuls()
    out = []
    cols = list(zip(core.hot_columns(hot), hot))
    with torch.no_grad():
        for r in raw:
            idx = [torch.from_numpy(r["idx"][:, c: c + h].astype(np.int64))
                   .to(dev) for c, h in cols]
            p = dlrm_ref.serve_probs(packed, offs, idx, dense,
                                     torch.from_numpy(r["dense"]).to(dev),
                                     quant)
            out.append(p.reshape(-1).cpu().numpy())
    return out
