"""The program's spans and counters (dlrm_tpu_torch/utils/profiling.py):
kept only inside profile(), nested with their parent and thread, on the
trace's timeline too; counters cleared at each profile(); the stream
train step's spans once a step through the prefetcher; the sync debug
mode and the warning filters restored. Imports nothing of JAX; the `cuda`
cases (the table grads' device time, the sync count) run on the card:
`python3 -m pytest --noconftest -m cuda tests/test_torch_profiling.py`."""

import contextlib
import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.config import DCNConfig, DLRMConfig
from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.train import stream_step
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
from dlrm_tpu_torch.utils import profiling as prof

TABLES = (300, 7, 2000)
HOTS = (3, 1, 5)
B = 64
STEP_SPANS = (prof.EMB_FWD, prof.LOSS, prof.BWD, prof.DENSE_UPDATE,
              prof.TABLE_GRADS, prof.TABLE_UPDATE)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _names(spans):
    return [s.name for s in spans]


def test_outside_profile_nothing_is_kept(tmp_path, monkeypatch):
    with prof.profile(True, str(tmp_path)):
        with prof.scope("kept"):
            prof.count("n", 2)
    kept = prof.spans()
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    ctx = prof.scope("outside", device=True)
    assert isinstance(ctx, contextlib.nullcontext)
    with ctx:
        prof.count("n", 5)
    assert not made
    assert _names(prof.spans()) == _names(kept) == ["kept"]
    assert prof.counters()["n"] == 2


def test_nested_scopes_keep_parent_thread_and_lie_in_the_trace(tmp_path):
    def other():
        with prof.scope("worker"):
            time.sleep(0.002)

    with prof.profile(True, str(tmp_path)):
        with prof.scope("outer"):
            time.sleep(0.03)
            with prof.scope("inner"):
                time.sleep(0.03)
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    got = {s.name: s for s in prof.spans()}
    assert set(got) == {"outer", "inner", "worker"}
    outer, inner, worker = got["outer"], got["inner"], got["worker"]
    me = threading.get_native_id()
    assert inner.parent is outer and outer.parent is None
    assert inner.thread == outer.thread == me
    assert worker.parent is None and worker.thread != me
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    assert outer.host_ms >= inner.host_ms >= 30
    assert inner.device_ms is None  # no device=True
    with open(os.path.join(tmp_path, prof.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    for s in (outer, inner):
        (e,) = [e for e in events if e.get("name") == s.name
                and e.get("ph") == "X"]
        assert e["tid"] == s.thread
        assert e["dur"] * 1e-3 == pytest.approx(s.host_ms, rel=0.2, abs=2)


def test_a_span_open_across_the_edges_is_not_kept(tmp_path):
    with prof.profile(True, str(tmp_path / "a")):
        open_at_exit = prof.scope("straddles")
        open_at_exit.__enter__()
    open_at_exit.__exit__(None, None, None)
    assert prof.spans() == []


def test_counters_add_only_while_tracing_and_clear(tmp_path):
    prof.count("bytes", 7)
    with prof.profile(True, str(tmp_path)):
        prof.count("bytes", 3)
        with prof.scope("s"):
            prof.count("bytes", 4)
            with prof.scope("t"):
                prof.count("bytes", 5)
    prof.count("bytes", 11)
    assert prof.counters()["bytes"] == 12
    s, t = sorted(prof.spans(), key=lambda x: x.name)
    assert s.counts == {"bytes": 4} and t.counts == {"bytes": 5}
    with prof.profile(True, str(tmp_path)):
        pass
    assert "bytes" not in prof.counters()


def test_sync_warnings_count_only_inside_a_scope(tmp_path):
    """The hook the sync debug mode's warnings reach: one inside a scope
    counts against it, one outside every scope does not, and any other
    warning still shows."""
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with prof.profile(True, str(tmp_path)):
            warnings.warn(prof.SYNC_MESSAGE + " (outside)")
            with prof.scope("syncs"):
                warnings.warn(prof.SYNC_MESSAGE + " (inside)")
                warnings.warn("something else")
    (s,) = prof.spans()
    assert s.counts == {prof.SYNCS: 1}
    assert prof.counters()[prof.SYNCS] == 1
    assert [str(w.message) for w in shown] == ["something else"]


def test_sync_mode_and_warning_filters_are_restored(tmp_path, monkeypatch):
    filters, show = list(warnings.filters), warnings.showwarning
    with prof.profile(True, str(tmp_path)):
        assert warnings.filters != filters
        assert warnings.showwarning is not show
    assert warnings.filters == filters and warnings.showwarning is show

    mode = ["default"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))
    with pytest.raises(RuntimeError):
        with prof._counting_syncs(True):
            assert mode == ["warn"]
            raise RuntimeError("the run failed")
    assert mode == ["default"]
    assert warnings.filters == filters and warnings.showwarning is show


def _step_and_batches(dev, n):
    model = DLRMModel(DLRMConfig(
        embedding_dim=8, table_sizes=TABLES, mlp_bot=(13, 16, 8),
        mlp_top=(16, 1), interaction="dcn",
        dcn=DCNConfig(num_layers=1, low_rank_dim=4), loss="bce",
        num_indices_per_lookup=max(HOTS)))
    plan = stream_step.plan_for_model(model, B, block_rows=128,
                                      hot_sizes=HOTS)
    params = stream_step.pad_params(
        model.init_params(seed=0, device=dev), model, plan)
    opt = stream_step.init_stream_opt_state("rwsadagrad", params, plan)
    step = stream_step.make_stream_train_step(
        model, "rwsadagrad", plan, grad_impl="gather", device=dev)
    rng = np.random.default_rng(3)
    hosts = [ragged_multihot_batch(rng, 13, TABLES, HOTS, B)
             .with_stream_work(plan) for _ in range(n)]
    return step, params, opt, plan, hosts


def _run_steps(dev, n, tmp_path):
    step, params, opt, plan, hosts = _step_and_batches(dev, n)
    feed = DevicePrefetcher(
        hosts, lambda hb: hb.to_device(dev, flat_hots=plan.hot), depth=2,
        device=dev)
    with prof.profile(True, str(tmp_path)):
        for batch in feed:
            params, opt, loss, _ = step(params, opt, batch, 0.01)
        float(loss)
    return prof.spans()


def test_stream_step_spans_once_a_step(tmp_path):
    n = 3
    spans = _run_steps(torch.device("cpu"), n, tmp_path)
    names = _names(spans)
    for name in STEP_SPANS:
        assert names.count(name) == n, name
    # the prefetcher's waits: one a batch, and the one that finds it done
    assert names.count(prof.PREFETCH_WAIT) == n + 1
    assert names.count(prof.TO_DEVICE) == n
    for s in spans:
        if s.name in (prof.LOSS, prof.BWD):
            assert s.parent is None
    calls = [s for s in spans if s.name == prof.TO_DEVICE]
    assert len({s.thread for s in calls}) == 1
    assert calls[0].thread != threading.get_native_id()


@pytest.mark.cuda
def test_table_grads_device_time_and_syncs_on_the_card(card, tmp_path):
    spans = _run_steps(card, 3, tmp_path / "step")
    grads = [s for s in spans if s.name == prof.TABLE_GRADS]
    assert len(grads) == 3 and all(s.device_ms > 0 for s in grads)
    names = _names(spans)
    assert names.count(prof.TO_DEVICE_PIN) == names.count(prof.TO_DEVICE_H2D)
    assert names.count(prof.TO_DEVICE_PIN) > 0
    assert prof.counters()[prof.TO_DEVICE_BYTES] > 0

    x = torch.ones(8, device=card)
    before = torch.cuda.get_sync_debug_mode()
    with prof.profile(True, str(tmp_path / "sync")):
        assert torch.cuda.get_sync_debug_mode() == 1  # warn
        x.sum().item()  # outside every scope: not counted
        with prof.scope("one sync"):
            x.sum().item()
        torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == before
    (s,) = prof.spans()
    assert s.counts == {prof.SYNCS: 1}
    c = prof.counters()
    assert c[prof.SYNCS] == 1
    for key in prof.DEVICE_STATS:
        assert f"memory_stats.{key}" in c
    assert "host_memory_stats.num_host_alloc" in c
