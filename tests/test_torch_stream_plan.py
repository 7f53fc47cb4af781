"""The port's copies of the stream plan and its builders
(dlrm_tpu_torch/ops/stream_plan.py, native/stream_work.cc) against
dlrm_tpu's: the numpy paths give IDENTICAL arrays; the port's native builder
gives its numpy path's arrays too (dlrm_tpu's native builder leaves the
slots of a run in scan order, which tests/test_stream_kernels.py allows for
it; the port's sorts them by row, as the numpy path does)."""

import dataclasses

import numpy as np
import pytest

from dlrm_tpu.ops import stream_plan as jsp
from dlrm_tpu_torch.native import stream_native
from dlrm_tpu_torch.ops import stream_plan as tsp

TABLES = (300, 50, 700)
D = 128
B = 256
H = 2
BR = 1024


def _batch(seed, hot):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, n, (B, H)) for n in TABLES]).astype(
        np.int32
    )
    wt = rng.uniform(0.5, 1.5, size=(len(TABLES), B, H)).astype(np.float32)
    hots = hot if isinstance(hot, tuple) else (hot,) * len(TABLES)
    for t, h in enumerate(hots):
        wt[t, :, h:] = 0.0
    return idx, wt, hots


def _flat(arr, hots):
    return np.concatenate([arr[t, :, :h] for t, h in enumerate(hots)], axis=1)


def _assert_work_identical(a, b):
    assert a.num_real_items == b.num_real_items
    for f in ("rows_u", "vals_u", "wts_u", "w2t", "item_block", "item_row0",
              "item_u"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _check_work_equal_up_to_run_order(wn, wp):
    """Identical items/windows; identical per-run slot content up to the
    order of slots inside a run (which no kernel depends on)."""
    assert wn.num_real_items == wp.num_real_items
    for f in ("item_block", "item_row0", "item_u", "w2t"):
        np.testing.assert_array_equal(getattr(wn, f), getattr(wp, f), f)

    def canon(w_):
        r = np.stack([
            w_.rows_u.reshape(-1).astype(np.float64),
            w_.vals_u.reshape(-1).astype(np.float64),
            w_.wts_u.reshape(-1).astype(np.float64),
        ])
        return r[:, np.lexsort(r[::-1])]

    np.testing.assert_array_equal(canon(wn), canon(wp))


@pytest.mark.parametrize("hot", [H, (2, 1, 2)], ids=["uniform", "ragged"])
@pytest.mark.parametrize("layout", ["padded", "flat"])
@pytest.mark.parametrize("skip_wts", [False, True])
def test_numpy_plan_and_work_identical_to_dlrm_tpu(hot, layout, skip_wts):
    idx, wt, hots = _batch(3, hot)
    jplan = jsp.make_stream_plan(TABLES, D, B, hot, block_rows=BR)
    tplan = tsp.make_stream_plan(TABLES, D, B, hot, block_rows=BR)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    assert tplan.acc_rows == jplan.acc_rows
    assert tplan.u_total == jplan.u_total
    if layout == "flat":
        idx, wt = _flat(idx, hots), _flat(wt, hots)
    w_in = None if skip_wts else wt
    jw = jsp.build_stream_work(jplan, idx, w_in, prefer_native=False,
                               skip_wts=skip_wts)
    tw = tsp.build_stream_work(tplan, idx, w_in, prefer_native=False,
                               skip_wts=skip_wts)
    _assert_work_identical(jw, tw)
    _assert_work_identical(
        jsp.touched_update_items(jplan, jw), tsp.touched_update_items(tplan, tw)
    )


def test_padding_helpers_identical_to_dlrm_tpu():
    rng = np.random.default_rng(5)
    plan = tsp.make_stream_plan(TABLES, D, B, H, block_rows=BR)
    jplan = jsp.make_stream_plan(TABLES, D, B, H, block_rows=BR)
    tabs = [rng.normal(size=(n, D)).astype(np.float32) for n in TABLES]
    np.testing.assert_array_equal(
        tsp.stack_tables_padded(tabs, plan), jsp.stack_tables_padded(tabs, jplan)
    )
    acc = rng.random(sum(TABLES)).astype(np.float32)
    packed = tsp.pack_rowwise_accum(acc, plan)
    np.testing.assert_array_equal(packed, jsp.pack_rowwise_accum(acc, jplan))
    np.testing.assert_array_equal(
        tsp.unpack_rowwise_accum(packed, sum(TABLES)), acc
    )
    np.testing.assert_array_equal(tsp.flat_col0((3, 1, 4)),
                                  jsp.flat_col0((3, 1, 4)))


@pytest.mark.parametrize("hot", [H, (2, 1, 2)], ids=["uniform", "ragged"])
def test_native_stream_work_matches_numpy(hot):
    """The port's C++ builder emits the same plan as its numpy path."""
    assert stream_native.available(), "g++ build of stream_work.cc failed"
    idx, wt, hots = _batch(11, hot)
    plan = tsp.make_stream_plan(TABLES, D, B, hot, block_rows=BR)
    wn = tsp.build_stream_work(plan, idx, wt, prefer_native=True)
    wp = tsp.build_stream_work(plan, idx, wt, prefer_native=False)
    _check_work_equal_up_to_run_order(wn, wp)
    # the flat on-disk layout builds the same work natively
    wf = tsp.build_stream_work(plan, _flat(idx, hots), _flat(wt, hots),
                               prefer_native=True)
    _check_work_equal_up_to_run_order(wf, wp)


@pytest.mark.parametrize("hot", [H, (2, 1, 2)], ids=["uniform", "ragged"])
@pytest.mark.parametrize("layout", ["padded", "flat"])
def test_native_stream_work_identical_to_numpy(hot, layout):
    """The C++ builder sorts each block's hits by row, stably in scan order,
    as the numpy path does: the two plans are identical, slot for slot (the
    port's K2 needs every row's hits in one contiguous run). Rows repeat
    within and across bags here, so the order of equal rows is tested."""
    idx, wt, hots = _batch(12, hot)
    idx //= 4  # about four hits per touched row
    plan = tsp.make_stream_plan(TABLES, D, B, hot, block_rows=BR)
    wp = tsp.build_stream_work(plan, idx, wt, prefer_native=False)
    if layout == "flat":
        idx, wt = _flat(idx, hots), _flat(wt, hots)
    _assert_work_identical(
        tsp.build_stream_work(plan, idx, wt, prefer_native=True), wp)


def test_native_budgeted_stream_work_identical_to_numpy():
    """The same with a budgeted table, whose weight-0 hits are dropped."""
    idx, wt, _ = _batch(13, H)
    wt[1][np.random.default_rng(14).random(wt[1].shape) < 0.5] = 0.0
    budget = [None, int((wt[1] != 0).sum()) + 16, None]
    plan = tsp.make_stream_plan(TABLES, D, B, H, block_rows=BR,
                                u_budget=budget)
    _assert_work_identical(
        tsp.build_stream_work(plan, idx, wt, prefer_native=True),
        tsp.build_stream_work(plan, idx, wt, prefer_native=False))


def test_mixed_layout_build_routes_off_native():
    """flat idx + padded wt: the native builder would address wt with idx's
    strides, so build_stream_work takes the numpy path, and the native
    wrapper rejects mixed layouts outright."""
    idx, wt, hots = _batch(17, (2, 1, 2))
    plan = tsp.make_stream_plan(TABLES, D, B, hots, block_rows=BR)
    oracle = tsp.build_stream_work(plan, idx, wt, prefer_native=False)
    mixed = tsp.build_stream_work(plan, _flat(idx, hots), wt,
                                  prefer_native=True)
    _check_work_equal_up_to_run_order(mixed, oracle)
    with pytest.raises(ValueError, match="SAME layout"):
        stream_native.build_stream_work_native(plan, _flat(idx, hots), wt)


def test_no_cross_table_chunk_bleed():
    """Work items span 256 slots but runs pad to 128, so each table segment
    keeps a CHUNK of sentinel tail: no real item's chunk may cross into the
    next table's slots (whose table-local rows alias the item's block).
    Adversarial input: table 0 takes 8 hits in 8 distinct 128-row blocks,
    table 1's hits sit at local rows 896..903 (table 0's last block range).
    Both port builders; then the plain K2 sgd update equals the exact
    per-row sum of the hits' gradients."""
    import torch

    from dlrm_tpu_torch.ops.stream_kernels import stream_update

    tables_n = (1024, 1024)
    b, h, br = 8, 1, 128
    plan = tsp.make_stream_plan(tables_n, D, b, h, block_rows=br)
    seg_end = list(plan.u_base[1:]) + [plan.u_size]
    blk2t = np.zeros(plan.num_blocks, np.int32)
    for t in range(len(tables_n)):
        blk2t[plan.block_base[t]: plan.block_base[t]
              + plan.blocks_per_table[t]] = t
    idx = np.stack([
        np.arange(b, dtype=np.int32) * br,
        896 + np.arange(b, dtype=np.int32),
    ])[:, :, None]
    wt = np.ones((2, b, h), np.float32)
    for native in (False, True):
        work = tsp.build_stream_work(plan, idx, wt, prefer_native=native)
        for i in range(work.num_real_items):
            blk = int(work.item_block[i])
            if blk == plan.pad_block or int(work.item_u[i]) >= plan.u_size:
                continue
            assert int(work.item_u[i]) + tsp.CHUNK <= seg_end[blk2t[blk]]

    work = tsp.build_stream_work(plan, idx, wt, prefer_native=False)
    rng = np.random.default_rng(3)
    tabs = [rng.normal(size=(n, D)).astype(np.float32) for n in tables_n]
    dly = rng.normal(size=(2, b, D)).astype(np.float32)
    stacked = tsp.stack_tables_padded(tabs, plan)
    g_u = np.zeros((plan.u_total, D), np.float32)
    rows = work.rows_u.reshape(-1)
    for u in np.flatnonzero(rows >= 0):
        t = int(work.w2t[u // tsp.WINDOW])
        g_u[u] = work.wts_u.reshape(-1)[u] * dly[t, work.vals_u.reshape(-1)[u]]
    table = torch.from_numpy(stacked.copy())
    stream_update(
        "sgd", plan, table, None, torch.from_numpy(g_u),
        torch.from_numpy(work.rows_u), torch.from_numpy(work.item_block),
        torch.from_numpy(work.item_row0), torch.from_numpy(work.item_u), 0.05,
    )
    want = stacked.copy()
    for t in range(2):
        for bag in range(b):
            want[plan.padded_offsets[t] + idx[t, bag, 0]] -= 0.05 * dly[t, bag]
    np.testing.assert_allclose(table.numpy(), want, rtol=1e-6, atol=1e-6)


def test_skip_wts_unit_weight_build():
    """skip_wts builds (native + numpy) give identical rows/vals/items with
    wts_u=None, and the weights derived on the device (rows != -1) equal
    the explicitly built unit weights."""
    idx, _, _ = _batch(13, (2, 1, 2))
    plan = tsp.make_stream_plan(TABLES, D, B, (2, 1, 2), block_rows=BR)
    full = tsp.build_stream_work(plan, idx, None, prefer_native=False)
    lean = tsp.build_stream_work(plan, idx, None, prefer_native=False,
                                 skip_wts=True)
    assert lean.wts_u is None
    np.testing.assert_array_equal(full.rows_u, lean.rows_u)
    np.testing.assert_array_equal(full.vals_u, lean.vals_u)
    np.testing.assert_array_equal(full.item_u, lean.item_u)
    derived = (lean.rows_u != tsp.SENTINEL_ROW).astype(np.float32)
    np.testing.assert_array_equal(full.wts_u, derived)
    nat = tsp.build_stream_work(plan, idx, None, prefer_native=True,
                                skip_wts=True)
    assert nat.wts_u is None
    nat_derived = (nat.rows_u != tsp.SENTINEL_ROW).astype(np.float32)
    _check_work_equal_up_to_run_order(
        dataclasses.replace(nat, wts_u=nat_derived),
        dataclasses.replace(lean, wts_u=derived),
    )
