"""Profiling: a chrome trace of a run, named regions, and what the regions
recorded (the port of dlrm_tpu/utils/profiling.py).

The reference wraps its train loop in torch.autograd.profiler and exports a
chrome trace (dlrm_s_pytorch.py:1513-1515, 1794-1806), labelling regions
with record_function (:130, :552, :565, :572, :576, :1604). Here
torch.profiler traces the host and, on the card, the device, and writes
`trace.json` into the output directory; the region labels are the
reference's, kept verbatim, and the port's own in the same style.

The autograd engine runs a backward on a thread of its own, so a scope
around the call that builds a graph does not hold its backward:
backward_scope(name, fn, *inputs) runs fn's backward inside scope(name),
on whatever thread runs it, traced or not (the same bits as plain
autograd).

While profile() traces, each scope() also keeps a Span in memory (its
name, thread, enclosing scope, host start and end, and with device=True
the card's time between two CUDA events), count() adds to named counters,
and every synchronizing CUDA call that the sync debug mode reports inside
a scope is counted under SYNCS, in the counters and in the innermost open
scope of its thread (calls outside every scope are not counted).
spans() and counters() read what the last profile() kept: the spans that
began and ended inside it, the counts, and the changes of the CUDA
allocators' own counters over it. Outside profile(), scope() is a null
context and count() returns at once: nothing is kept.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity

FWD = "DLRM forward"
EMB_FWD = "DLRM embedding forward"
BOT_FWD = "DLRM bottom nlp forward"
INT_FWD = "DLRM interaction forward"
INT_BWD = "DLRM interaction backward"
TOP_FWD = "DLRM top nlp forward"
LOSS = "DLRM loss compute"
BWD = "DLRM backward"
DENSE_UPDATE = "DLRM dense update"
TABLE_GRADS = "DLRM table grads"
TABLE_UPDATE = "DLRM table update"
TO_DEVICE = "DLRM to_device"
TO_DEVICE_PIN = "DLRM to_device pin"
TO_DEVICE_H2D = "DLRM to_device h2d"
PREFETCH_WAIT = "DLRM prefetch wait"

# counters
TO_DEVICE_BYTES = "DLRM to_device bytes"
SYNCS = "DLRM syncs"  # present only where the sync debug mode was on
# the stream step's hits, and its rows of more than K2_CHUNK hits and their
# hits, which K2 sums in chunks (build_stream_work's counts on the host)
K2_HITS = "DLRM K2 hits"
K2_LONG_RUNS = "DLRM K2 long runs"
K2_LONG_HITS = "DLRM K2 long-run hits"
# the fused step's hits (its batch's shape: batch x the hot sizes' sum)
FUSED_HITS = "DLRM fused hits"

# the allocators' cumulative counters whose change over profile() is kept,
# as "<function>.<key>" (port_bench's to_device readers report them); a
# key the installed torch lacks is left out
HOST_STATS = ("num_host_alloc", "host_alloc_time.total")  # microseconds
DEVICE_STATS = ("num_alloc_retries", "num_sync_all_streams",
                "num_device_alloc", "num_device_free")

SYNC_MESSAGE = "called a synchronizing CUDA operation"

TRACE_FILE = "trace.json"

_active = False  # set while profile() traces
_trace_id = 0  # counts profile() entries; a span keeps only its own
_lock = threading.Lock()
_local = threading.local()  # .stack: the open spans of a thread
_spans: List["Span"] = []
_counters: Dict[str, float] = {}


@dataclass(eq=False)
class Span:
    """One scope() entered and left while profile() traced."""

    name: str
    thread: int  # native thread id, the trace's tid
    parent: Optional["Span"] = field(repr=False)  # enclosing, same thread
    start_ns: int = 0  # time.perf_counter_ns()
    end_ns: int = 0
    counts: Dict[str, float] = field(default_factory=dict)  # while innermost
    events: Optional[tuple] = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """The card's milliseconds between the entry and exit events
        (device=True), read when asked: it waits for the exit event."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Scope(torch.profiler.record_function):
    """record_function(name) that also keeps a Span (see the module doc)."""

    def __init__(self, name: str, device: bool):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        super().__enter__()
        stack = _stack()
        self.trace_id = _trace_id
        self.span = Span(self.name, threading.get_native_id(),
                         stack[-1] if stack else None)
        if self.device:
            self.span.events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
            self.span.events[0].record()
        stack.append(self.span)
        self.span.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        span = self.span
        span.end_ns = time.perf_counter_ns()
        if span.events is not None:
            span.events[1].record()
        _stack().pop()
        if _active and self.trace_id == _trace_id:
            with _lock:
                _spans.append(span)
        return super().__exit__(*exc)


def scope(name: str, device: bool = False
          ) -> contextlib.AbstractContextManager:
    """record_function(name), keeping a Span, while profile() traces, else
    a null context. device=True (for work on the current CUDA stream) also
    times the region on the card."""
    if _active:
        return _Scope(name, device)
    return contextlib.nullcontext()


class _ScopedBackward(torch.autograd.Function):
    """fn(*inputs) as one node: its forward builds fn's graph on detached
    inputs, its backward runs that graph's backward inside scope(name)."""

    @staticmethod
    def forward(ctx, name, fn, *inputs):
        ctx.name = name
        ctx.inputs = [t.detach().requires_grad_(need) for t, need in
                      zip(inputs, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            ctx.out = fn(*ctx.inputs)
        return ctx.out.detach()

    @staticmethod
    def backward(ctx, grad):
        want = [t for t in ctx.inputs if t.requires_grad]
        with scope(ctx.name):
            got = iter(torch.autograd.grad(ctx.out, want, grad))
        return (None, None, *(next(got) if need else None
                              for need in ctx.needs_input_grad[2:]))


def backward_scope(name: str, fn, *inputs: torch.Tensor) -> torch.Tensor:
    """fn(*inputs), with its backward inside scope(name) where a gradient
    is taken; the plain call otherwise."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        return fn(*inputs)
    return _ScopedBackward.apply(name, fn, *inputs)


def count(name: str, n: float = 1) -> None:
    """Add n to counter `name`, and to the innermost open scope's counts,
    while profile() traces."""
    if not _active:
        return
    stack = _stack()
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if stack:
            stack[-1].counts[name] = stack[-1].counts.get(name, 0) + n


def spans() -> List[Span]:
    """The spans the last profile() kept, in the order they ended."""
    with _lock:
        return list(_spans)


def counters() -> Dict[str, float]:
    """The counts of the last profile(), with the allocators' changes."""
    with _lock:
        return dict(_counters)


def _allocator_stats() -> Dict[str, float]:
    if not torch.cuda.is_available():
        return {}
    out = {}
    for fn, keys in ((torch.cuda.host_memory_stats, HOST_STATS),
                     (torch.cuda.memory_stats, DEVICE_STATS)):
        stats = fn()
        out.update({f"{fn.__name__}.{k}": stats[k] for k in keys
                    if k in stats})
    return out


@contextlib.contextmanager
def _counting_syncs(cuda: bool) -> Iterator[None]:
    """The sync debug mode set to warn (on a card), and its warnings
    counted under SYNCS where a scope is open on the warning's thread and
    dropped elsewhere; the mode, the warning filters and showwarning are
    restored on exit."""
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                category=UserWarning)
        show = warnings.showwarning

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if SYNC_MESSAGE not in str(message):
                show(message, category, filename, lineno, file, line)
            elif _stack():
                count(SYNCS)

        warnings.showwarning = hook
        if not cuda:
            yield
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def profile(enabled: bool, output_dir: str = "dlrm_profile") -> Iterator[None]:
    """Context manager around a training run: with `enabled`, profiles the
    host (and the card, where CUDA is available) and writes the chrome
    trace to output_dir/trace.json, which Perfetto and chrome://tracing
    open; the spans and counters it kept stay readable until the next
    profile()."""
    global _active, _trace_id
    if not enabled:
        yield
        return
    os.makedirs(output_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with _lock:
        _spans.clear()
        _counters.clear()
        _trace_id += 1
        if cuda:
            _counters[SYNCS] = 0
    before = _allocator_stats()
    with _counting_syncs(cuda):
        _active = True
        try:
            with torch.profiler.profile(activities=activities) as prof:
                yield
        finally:
            _active = False
            after = _allocator_stats()
            with _lock:
                _counters.update({k: v - before[k] for k, v in after.items()})
    prof.export_chrome_trace(os.path.join(output_dir, TRACE_FILE))
    print(f"profiler trace written to {output_dir}")
