"""The reader of K2's long-run counters (k2_long_hit_pct.train) on made-up
counters: the share of the traced steps' hits on rows of more than C hits,
and nothing on a program without the counters."""

import types

import pytest

from port_bench import core, program
from port_bench.tests.test_port_bench_program_spans import ROOT, read, summary

NAME = "k2_long_hit_pct.train"


def test_k2_long_hit_pct(monkeypatch):
    counters = {"DLRM K2 hits": 4_000_000, "DLRM K2 long runs": 1090,
                "DLRM K2 long-run hits": 2_400_000}
    got = read(NAME, summary("train", 2), [], counters, monkeypatch)
    assert got == {"value": pytest.approx(60.0),
                   "long_runs": pytest.approx(545.0)}
    assert read(NAME, summary("serve", 2), [], counters, monkeypatch) is None


@pytest.mark.parametrize("profiling", [
    types.SimpleNamespace(),  # no counters at all
    types.SimpleNamespace(counters=lambda: {"DLRM syncs": 3}),  # the parent's
])
def test_nothing_without_the_counters(profiling, monkeypatch):
    monkeypatch.setattr(program, "profiling", profiling)
    mod = core.load_module(ROOT, "metrics", NAME)
    assert mod.read(summary("train", 2)) is None
