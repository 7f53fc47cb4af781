"""Profiling: a chrome trace of a run and named regions (the port of
dlrm_tpu/utils/profiling.py).

The reference wraps its train loop in torch.autograd.profiler and exports a
chrome trace (dlrm_s_pytorch.py:1513-1515, 1794-1806), labelling regions
with record_function (:130, :552, :565, :572, :576, :1604). Here
torch.profiler traces the host and, on the card, the device, and writes
`trace.json` into the output directory; the region labels are the
reference's, kept verbatim.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity

FWD = "DLRM forward"
EMB_FWD = "DLRM embedding forward"
BOT_FWD = "DLRM bottom nlp forward"
INT_FWD = "DLRM interaction forward"
TOP_FWD = "DLRM top nlp forward"
LOSS = "DLRM loss compute"
BWD = "DLRM backward"

TRACE_FILE = "trace.json"

_active = False  # set while profile() traces


@contextlib.contextmanager
def profile(enabled: bool, output_dir: str = "dlrm_profile") -> Iterator[None]:
    """Context manager around a training run: with `enabled`, profiles the
    host (and the card, where CUDA is available) and writes the chrome
    trace to output_dir/trace.json, which Perfetto and chrome://tracing
    open."""
    global _active
    if not enabled:
        yield
        return
    os.makedirs(output_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _active = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        _active = False
    prof.export_chrome_trace(os.path.join(output_dir, TRACE_FILE))
    print(f"profiler trace written to {output_dir}")


def scope(name: str) -> contextlib.AbstractContextManager:
    """record_function(name) while profile() traces, else a null
    context."""
    if _active:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
