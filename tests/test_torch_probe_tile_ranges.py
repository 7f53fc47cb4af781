"""The plan invariant that csrc/k2_bisect.cu relies on, on the CPU: within a
table block's slot span [item_u[first], item_u[last - 1] + 256) the
predicate rows_u[s] < 0 || rows_u[s] >= x is monotone for every row x of
the block, so one 128-row tile's hits are the contiguous slot range between
two searches, and that range holds one run per touched row. Checked on the
numpy and the native builder's plans, with the full cover list and the
touched-only list, by a mirror of the kernel's 32-way search (first_past)
against a full scan of the block's items. The cases: ragged v2 hot sizes at
a small batch, a Pareto-skewed batch (long runs across items), blocks whose
hit counts are multiples of 128 (the next block's rows follow with no
sentinel between) and hit-free blocks (their one sentinel item)."""

import numpy as np
import pytest

from dlrm_tpu_torch.data.random_data import V2_HOT_SIZES
from dlrm_tpu_torch.native import stream_native
from dlrm_tpu_torch.ops.stream_plan import (
    CHUNK,
    build_stream_work,
    make_stream_plan,
    touched_update_items,
)

TILE = 128  # csrc/k2_bisect.cu kTileRows


def first_past(rows, a, b, x):
    """csrc/k2_bisect.cu first_past, lane by lane: the first slot in [a, b)
    whose row is a sentinel or >= x, or b."""
    def past(r):
        return r < 0 or r >= x

    while b - a > 32:
        step = (b - a + 31) // 32
        m = [p >= b or past(rows[p])
             for p in (a + (lane + 1) * step - 1 for lane in range(32))]
        if not any(m):
            return b
        k = m.index(True)
        end = a + (k + 1) * step - 1
        a += k * step
        b = min(b, end)
    for p in range(a, b):
        if past(rows[p]):
            return p
    return b


def _case(name):
    """name -> (plan, idx [T, B, H]) with unit weights."""
    rng = np.random.default_rng(14)
    if name == "v2_ragged":
        tables = tuple(1500 + 700 * t for t in range(26))
        plan = make_stream_plan(tables, 16, 24, V2_HOT_SIZES, block_rows=1024)
        idx = np.zeros((26, 24, max(V2_HOT_SIZES)), np.int32)
        for t, (n, h) in enumerate(zip(tables, V2_HOT_SIZES)):
            idx[t, :, :h] = rng.integers(0, n, (24, h))
        return plan, idx
    if name == "pareto":
        tables = (5000, 3000, 9000)
        plan = make_stream_plan(tables, 16, 64, 20, block_rows=1024)
        idx = np.stack([np.minimum(rng.pareto(1.1, (64, 20)) * 3, n - 1)
                        for n in tables]).astype(np.int32)
        return plan, idx
    if name == "x128":
        # blocks 0 and 1 get 128 and 384 hits: a run of a multiple of 128
        # slots, so block 0's item reads block 1's first 128 rows; block 2
        # none; block 3 one; table 1 all of its hits in its last block
        block = [0] * 128 + [1] * 384 + [3]
        rows = np.array(block) * 1024 + rng.integers(0, 1024, len(block))
        plan = make_stream_plan((4096, 2100), 16, len(block), 1,
                                block_rows=1024)
        idx = np.stack([rows, 2048 + rng.integers(0, 52, len(block))])
        return plan, idx[:, :, None].astype(np.int32)
    # few hits into large tables: most blocks are hit-free
    tables = (100_000, 40_000)
    plan = make_stream_plan(tables, 16, 8, 2, block_rows=1024)
    return plan, np.stack([rng.integers(0, n, (8, 2)) for n in tables]
                          ).astype(np.int32)


def _work(plan, idx, builder, touched):
    if builder == "native":
        if not stream_native.available():
            pytest.skip("the native stream-work builder needs g++")
        work = stream_native.build_stream_work_native(plan, idx, None)
    else:
        work = build_stream_work(plan, idx, None, prefer_native=False)
    return touched_update_items(plan, work) if touched else work


@pytest.mark.parametrize("touched", [False, True], ids=["full", "touched"])
@pytest.mark.parametrize("builder", ["numpy", "native"])
@pytest.mark.parametrize("case", ["v2_ragged", "pareto", "x128", "sparse"])
def test_tile_hits_are_the_range_between_two_searches(case, builder,
                                                       touched):
    plan, idx = _case(case)
    work = _work(plan, idx, builder, touched)
    rows = work.rows_u.reshape(-1)
    ib, ir, iu = work.item_block, work.item_row0, work.item_u
    tiles = plan.block_rows // TILE
    seen_blocks = seen_runs = seen_hits = 0
    for b in range(plan.num_blocks):
        items = np.flatnonzero(ib == b)
        if items.size == 0:
            continue
        # the kernel's block_ranges: one contiguous item range a block
        assert np.array_equal(items, np.arange(items[0], items[-1] + 1))
        seen_blocks += 1
        a = int(iu[items[0]])
        end = min(int(iu[items[-1]]) + CHUNK, plan.u_total)
        row0 = int(ir[items[0]])
        scan = np.concatenate([np.arange(u, u + CHUNK) for u in iu[items]])
        scan = scan[scan < plan.u_total]
        for t in range(tiles):
            x0 = row0 + t * TILE
            pred = (rows[a:end] < 0) | (rows[a:end] >= x0)
            assert not np.any(pred[:-1] & ~pred[1:]), (b, t)  # monotone
            lo = first_past(rows, a, end, x0)
            hi = first_past(rows, a, end, x0 + TILE)
            want = scan[(rows[scan] >= x0) & (rows[scan] < x0 + TILE)]
            assert np.array_equal(np.arange(lo, hi), np.sort(want)), (b, t)
            tile_rows = rows[lo:hi]
            starts = np.count_nonzero(np.diff(tile_rows)) + (hi > lo)
            assert starts == np.unique(tile_rows).size <= TILE
            seen_runs += starts
            seen_hits += hi - lo
    assert seen_blocks > 0
    assert seen_hits == np.count_nonzero(rows >= 0)
    if case == "x128":  # block 1's rows follow block 0's with no sentinel
        assert rows[plan.u_base[0] + 128] >= 1024
    if not touched:
        assert seen_blocks == plan.num_blocks  # hit-free blocks included
    assert seen_runs <= seen_hits
