"""The readers of the program's spans and counters (utils/profiling.py's
spans() and counters(), taken through port_bench/program.py) on made-up
records: each one's value, and nothing where the records are absent, as
on a program without them."""

import os
import types

import pytest

from port_bench import core, program
from port_bench.tracing import Summary
from dlrm_tpu_torch.utils.profiling import Span

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MS = 1_000_000  # ns


class Events:
    """A made-up pair of CUDA events, `ms` apart on the card."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms


def span(name, ms, parent=None, counts=None, device_ms=None, start=0):
    s = Span(name, 1, parent, start * MS, (start + ms) * MS,
             dict(counts or {}))
    if device_ms is not None:
        e = Events(device_ms)
        s.events = (e, e)
    return s


def summary(kind, steps):
    return Summary(window_s=1.0, busy_s=0.5, steps=steps, kernels=0,
                   device_ops=[], idle_gaps=[], scope_s={}, op_s={},
                   kind=kind)


def read(name, s, spans, counters, monkeypatch):
    fake = types.SimpleNamespace(spans=lambda: list(spans),
                                 counters=lambda: dict(counters))
    monkeypatch.setattr(program, "profiling", fake)
    return core.load_module(ROOT, "metrics", name).read(s)


def to_device_calls():
    """Two calls, each pinning and copying two arrays, and a pin whose
    call was not kept (it straddled the traced stretch)."""
    out = []
    for k in range(2):
        call = span("DLRM to_device", 30, start=100 * k)
        out.append(call)
        for j in range(2):
            out.append(span("DLRM to_device pin", 5 + k, parent=call,
                            counts={"DLRM to_device bytes": 4e6}))
            out.append(span("DLRM to_device h2d", 1 + k, parent=call))
    out.append(span("DLRM to_device pin", 50,
                    parent=span("DLRM to_device", 60)))
    return out


COUNTERS = {"host_memory_stats.num_host_alloc": 8,
            "host_memory_stats.host_alloc_time.total": 3000,
            "memory_stats.num_alloc_retries": 1,
            "memory_stats.num_sync_all_streams": 2,
            "memory_stats.num_device_alloc": 3,
            "memory_stats.num_device_free": 1}


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_to_device_pin_ms(kind, monkeypatch):
    got = read(f"to_device_pin_ms.{kind}", summary(kind, 2),
               to_device_calls(), COUNTERS, monkeypatch)
    # (5 + 5 + 6 + 6) ms of pins over 2 calls; 16 MB over 22 ms
    assert got["value"] == pytest.approx(11.0)
    assert got["calls"] == 2
    assert got["pinned_GB_per_s"] == pytest.approx(16e6 / 22e-3 / 1e9)
    assert got["fresh_pinned_allocs_per_call"] == 4
    assert got["fresh_pinned_alloc_ms_per_call"] == pytest.approx(1.5)
    other = "serve" if kind == "train" else "train"
    assert read(f"to_device_pin_ms.{kind}", summary(other, 2),
                to_device_calls(), COUNTERS, monkeypatch) is None


def test_to_device_h2d_ms(monkeypatch):
    got = read("to_device_h2d_ms.train", summary("train", 2),
               to_device_calls(), COUNTERS, monkeypatch)
    assert got["value"] == pytest.approx(3.0)  # (1 + 1 + 2 + 2) / 2
    assert (got["calls"], got["alloc_retries"], got["sync_all_streams"],
            got["device_allocs"], got["device_frees"]) == (2, 1, 2, 3, 1)
    # without the allocator's counters (a CPU run) the mean stays
    got = read("to_device_h2d_ms.train", summary("train", 2),
               to_device_calls(), {}, monkeypatch)
    assert set(got) == {"value", "calls"}


def test_table_grads_ms(monkeypatch):
    spans = [span("DLRM table grads", 1, device_ms=18.5),
             span("DLRM table grads", 1, device_ms=19.5),
             span("DLRM table update", 1, device_ms=40.0)]
    got = read("table_grads_ms.train", summary("train", 2), spans, {},
               monkeypatch)
    assert got == {"value": pytest.approx(19.0), "spans": 2}
    # host spans only (no events: a CPU run)
    assert read("table_grads_ms.train", summary("train", 2),
                [span("DLRM table grads", 1)], {}, monkeypatch) is None


def test_prefetch_wait_ms(monkeypatch):
    spans = [span("DLRM prefetch wait", ms) for ms in (0.5, 3.5, 2.0)]
    got = read("prefetch_wait_ms.train", summary("train", 2), spans, {},
               monkeypatch)
    assert got == {"value": pytest.approx(3.0), "waits": 3,
                   "max_ms": pytest.approx(3.5)}


def test_host_syncs_per_batch(monkeypatch):
    fwd = span("DLRM forward", 60)
    spans = [span("DLRM embedding forward", 40, parent=fwd,
                  counts={"DLRM syncs": 12}),
             span("DLRM embedding forward", 40, parent=fwd,
                  counts={"DLRM syncs": 12}),
             span("DLRM top nlp forward", 5, counts={"DLRM syncs": 1}),
             span("DLRM to_device", 5, counts={"DLRM syncs": 2}),
             span("DLRM bottom nlp forward", 5, counts={"DLRM syncs": 1}),
             fwd]
    got = read("host_syncs_per_batch.serve", summary("serve", 2), spans,
               {"DLRM syncs": 28}, monkeypatch)
    assert got["value"] == pytest.approx(14.0)
    assert got["top_spans"][:2] == [["DLRM embedding forward", 12.0],
                                    ["DLRM to_device", 1.0]]
    assert len(got["top_spans"]) == 3
    # the sync count was not on (no card): nothing, rather than 0
    assert read("host_syncs_per_batch.serve", summary("serve", 2), spans,
                {}, monkeypatch) is None


def test_forward_host_ms(monkeypatch):
    spans = [span("DLRM forward", 70), span("DLRM forward", 90),
             span("DLRM embedding forward", 50)]
    got = read("forward_host_ms.serve", summary("serve", 2), spans, {},
               monkeypatch)
    assert got == {"value": pytest.approx(80.0), "spans": 2}


@pytest.mark.parametrize("name", [
    "table_grads_ms.train", "to_device_pin_ms.train",
    "to_device_h2d_ms.train", "prefetch_wait_ms.train",
    "to_device_pin_ms.serve", "host_syncs_per_batch.serve",
    "forward_host_ms.serve"])
def test_nothing_where_the_records_are_absent(name, monkeypatch):
    kind = name.rsplit(".", 1)[1]
    # a program whose profiling keeps no records (the parent's)
    monkeypatch.setattr(program, "profiling", types.SimpleNamespace())
    s = summary(kind, 2)
    assert core.load_module(ROOT, "metrics", name).read(s) is None
    # records kept, none of this reader's
    assert read(name, s, [span("DLRM elsewhere", 1)], {},
                monkeypatch) is None
