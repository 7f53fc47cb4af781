"""Host-side work plan for the streamed embedding update (the U-layout).

The port's copy of dlrm_tpu/ops/stream_plan.py: the same numpy code, the same
arrays, so the JAX package and the port consume identical plans (tests/
test_torch_stream_plan.py holds them equal). The plan depends only on the
batch's sparse indices, never on device values, so it is built on the host
in the input pipeline (numpy here, or the threaded C++ builder in
native/stream_work.cc).

THE U-LAYOUT. All hits of a batch live in one canonical "U-space":
  * per table, hits (row, bag, weight) are sorted by table-local row;
  * the run of hits belonging to each table BLOCK (block_rows rows) is
    padded to a multiple of 128 slots with sentinels (row=-1, wt=0), so
    every block's run starts 128-aligned and runs never overlap;
  * each table's segment is padded to a multiple of 1024 (the window size)
    so windows never straddle tables;
  * one trailing all-sentinel window serves as the target of padding items.
Static size: U_t = B*H*2 + 256 + 1024 bounds any distribution of hits (each
non-empty block adds <=127 pad slots, there are <= B*H non-empty blocks, and
every table segment keeps >= one 256-slot chunk of sentinel tail so a chunk
overrunning its run never reads the next table's slots).

Arrays (shipped to the device with the batch):
  rows_u/vals_u [Uw, 8, 128] int32, wts_u [Uw, 8, 128] f32 — slot row (table
      local), bag index, weight; window w covers slots [w*1024, (w+1)*1024).
  w2t [Uw] int32 — window -> table (sentinel window -> T-1 so the forward
      kernel's revolving output stays on the final table).
  item_* [M] int32 — work items, ordered by (table, block), one per
      (block x 256-slot chunk of its run), plus one sentinel-chunk item per
      hit-free block (the streamed kernels must rewrite EVERY block), plus
      cover items for table tail padding, padded to the static M with items
      aimed at the trailing pad block:
        item_block  global block id (the trailing pad block for padding)
        item_row0   table-local first row of the block
        item_u      first U-slot of the chunk (multiple of 128)
Work items are consumed by the streamed-update and streamed-forward kernels;
windows by the grad and pooling kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

WINDOW = 1024  # U-slots per window (8 sublanes x 128 lanes)
CHUNK = 256  # U-slots per work item
SENTINEL_ROW = -1
# C: K2 sums a row's run of more than K2_CHUNK hits in chunks of K2_CHUNK
# (csrc/stream_update.cu kRunChunk); build_stream_work counts such runs
K2_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Static geometry shared by every batch of a given config."""

    table_sizes: Tuple[int, ...]
    dim: int
    batch: int
    hot: Tuple[int, ...]  # per-table hot size (ragged multi-hot aware)
    block_rows: int

    padded_offsets: Tuple[int, ...]  # block-aligned start row per table
    block_base: Tuple[int, ...]  # first global block id per table
    blocks_per_table: Tuple[int, ...]
    padded_rows: int  # includes the trailing pad block
    num_blocks: int  # real blocks (excluding the trailing pad block)
    u_base: Tuple[int, ...]  # first U-slot per table
    u_size: int  # real U-slots (excl. trailing sentinel window)
    max_items: int
    # per-table U budget in slots, -1 = unbudgeted (segment sized B*hot).
    # A budgeted table's builder DROPS weight-0 hits and errors loudly if
    # the kept hits exceed the budget — the owned-hits-only layout for
    # row-wise striped slots, whose per-shard masked weights zero ~(M-1)/M
    # of the hits (PERF_NOTES r5 shard_slice_probe: the static u_size is
    # what G_u gathers and K2 items cost, so the budget IS the lever).
    u_budget: Tuple[int, ...] = ()

    @property
    def pad_block(self) -> int:
        return self.num_blocks

    @property
    def num_windows(self) -> int:  # including the trailing sentinel window
        return self.u_size // WINDOW + 1

    @property
    def u_total(self) -> int:
        return self.u_size + WINDOW

    @property
    def acc_rows(self) -> int:
        """Rows of the packed row-wise accumulator [padded_rows/128, 128]."""
        return self.padded_rows // 128

    @property
    def hot_col0(self) -> np.ndarray:
        """Table t's first column in the flat row-major [B, sum(hot)]
        sparse layout (the materialized on-disk format). The single source
        for the flat addressing contract — the numpy builder, the native
        builder, and HostBatch.to_device all index through this."""
        return flat_col0(self.hot)


def flat_col0(hot) -> np.ndarray:
    """First flat column per table for a [B, sum(hot)] sparse block."""
    hot = np.asarray(hot)
    return np.concatenate([[0], np.cumsum(hot[:-1])]).astype(np.int64)


def make_stream_plan(
    table_sizes: Sequence[int],
    dim: int,
    batch: int,
    hot,  # int (uniform) or per-table Sequence[int] (ragged multi-hot)
    block_rows: int = 512,
    u_budget=None,  # per-table Optional[int] slot budgets (None/-1 = B*hot)
) -> StreamPlan:
    if block_rows % 128 != 0:
        raise ValueError("block_rows must be a multiple of 128")
    # batch*hot needs no alignment: each block's run is padded to a multiple
    # of 128 slots independently of the raw hit count
    hot_t = (
        tuple(int(h) for h in hot)
        if isinstance(hot, (list, tuple, np.ndarray))
        else tuple([int(hot)] * len(table_sizes))
    )
    if len(hot_t) != len(table_sizes):
        raise ValueError(
            f"{len(hot_t)} hot sizes for {len(table_sizes)} tables"
        )
    if min(hot_t) < 1:
        raise ValueError(
            f"hot sizes must be >= 1, got {hot_t} (a 0-hot table would get "
            "no windows and window_pool would leave its output block "
            "uninitialized)"
        )
    if u_budget is None:
        budgets = (-1,) * len(table_sizes)
    else:
        if len(u_budget) != len(table_sizes):
            raise ValueError(
                f"{len(u_budget)} u_budget entries for "
                f"{len(table_sizes)} tables"
            )
        budgets = tuple(
            -1 if b is None else int(b) for b in u_budget
        )
    offs, bases, nblks = [], [], []
    acc = 0
    for n in table_sizes:
        offs.append(acc)
        bases.append(acc // block_rows)
        nb = max(1, -(-n // block_rows))
        nblks.append(nb)
        acc += nb * block_rows
    num_blocks = acc // block_rows
    padded_rows = acc + block_rows
    u_base, u_acc = [], 0
    for nb, h, bud in zip(nblks, hot_t, budgets):
        u_base.append(u_acc)
        bh = batch * h if bud < 0 else min(bud, batch * h)
        # this table's hit count — U sized TIGHTLY per table
        # + CHUNK: work items span 256 slots but runs pad only to 128, so a
        # segment filled exactly to its bound would let its last chunk read
        # the NEXT table's first run (cross-table bleed: those rows are
        # table-local and can alias into the item's block range). At least
        # one CHUNK of sentinel tail per segment makes overreads all-sentinel.
        bound = bh + 127 * min(nb, bh) + CHUNK
        u_acc += -(-bound // WINDOW) * WINDOW
    u_base = tuple(u_base)
    u_size = u_acc
    # items: one per CHUNK of U plus one per block (empty or boundary slack)
    max_items = u_size // CHUNK + num_blocks + len(table_sizes) + 8
    return StreamPlan(
        table_sizes=tuple(int(n) for n in table_sizes),
        dim=dim,
        batch=batch,
        block_rows=block_rows,
        hot=hot_t,
        padded_offsets=tuple(offs),
        block_base=tuple(bases),
        blocks_per_table=tuple(nblks),
        padded_rows=padded_rows,
        num_blocks=num_blocks,
        u_base=u_base,
        u_size=u_size,
        max_items=int(max_items),
        u_budget=budgets,
    )


@dataclasses.dataclass
class StreamWork:
    """Per-batch arrays consumed by the streamed kernels."""

    rows_u: np.ndarray  # [Uw, 8, 128] int32, table-LOCAL rows, -1 sentinel
    vals_u: np.ndarray  # [Uw, 8, 128] int32, bag index
    wts_u: np.ndarray  # [Uw, 8, 128] float32, weight (0 = sentinel)
    w2t: np.ndarray  # [Uw] int32, window -> table
    item_block: np.ndarray  # [M] int32
    item_row0: np.ndarray  # [M] int32
    item_u: np.ndarray  # [M] int32, multiple of 128 (CHUNK-aligned)
    num_real_items: int
    # True once touched_update_items dropped the cover items: the list then
    # serves the in-place update (K2) only, never the streamed forward (K3)
    touched_only: bool = False
    # the hits placed in U, and the runs of more than K2_CHUNK hits of one
    # row with their hits: what K2 sums in chunks (the profiler's counters)
    hits: int = 0
    long_runs: int = 0
    long_hits: int = 0


def build_stream_work(
    plan: StreamPlan,
    idx: np.ndarray,  # [T, B, H] padded OR [B, sum_t hot_t] flat indices
    wt: Optional[np.ndarray] = None,  # same geometry (None -> all 1.0)
    prefer_native: bool = True,
    skip_wts: bool = False,  # weights are 1.0 for every REAL hit: leave
    # wts_u None — the device derives it as (rows_u != -1), skipping a
    # third of the host writes and of the H2D bytes. Only valid when
    # wt[:, :, :hot_t] is all-ones (or wt is None) for every table.
) -> StreamWork:
    """Builds the per-batch U-layout arrays. Uses the threaded C++ builder
    (native/stream_work.cc, ~20x faster) when available; the numpy path
    below is the reference implementation and the no-toolchain fallback.

    idx may be the padded [T, B, Hmax] layout or the FLAT row-major
    [B, sum_t hot_t] layout (table-major column blocks — exactly the
    materialized multi-hot on-disk format, multi_hot_criteo.py:11-20), so
    the disk input path feeds the builder with no padding expansion."""
    t_ = len(plan.table_sizes)
    if idx.ndim == 3:
        if (
            idx.shape[0] != t_
            or idx.shape[1] != plan.batch
            or idx.shape[2] < max(plan.hot)
        ):
            raise ValueError(
                f"batch shape {idx.shape} incompatible with plan "
                f"({t_}, {plan.batch}, hot={plan.hot})"
            )
    elif idx.ndim == 2:
        if idx.shape != (plan.batch, int(np.sum(plan.hot))):
            raise ValueError(
                f"flat batch shape {idx.shape} incompatible with plan "
                f"({plan.batch}, sum(hot)={int(np.sum(plan.hot))})"
            )
    else:
        raise ValueError(f"idx must be 2-D flat or 3-D padded, got {idx.shape}")
    b_ = plan.batch
    if prefer_native:
        from dlrm_tpu_torch.native import stream_native

        # the native builder derives ONE t_off/row_stride from idx's layout
        # and applies it to wt too — a mixed flat-idx/padded-wt batch (or
        # two padded arrays with different Hmax, ADVICE r4) would read
        # weights at wrong addresses there, so any shape mismatch takes
        # the numpy path (which dispatches per array via _tbl below)
        layouts_match = wt is None or skip_wts or wt.shape == idx.shape
        if stream_native.available() and layouts_match:
            return stream_native.build_stream_work_native(
                plan, idx, wt, skip_wts=skip_wts
            )
    br = plan.block_rows
    u_total = plan.u_total
    rows_u = np.full(u_total, SENTINEL_ROW, dtype=np.int32)
    vals_u = np.zeros(u_total, dtype=np.int32)
    wts_u = None if skip_wts else np.zeros(u_total, dtype=np.float32)
    w2t = np.full(plan.num_windows, t_ - 1, dtype=np.int32)

    items = []  # (block, row0, u)
    sent_u = plan.u_size  # first slot of the trailing sentinel window
    hot_col0 = plan.hot_col0

    def _tbl(arr, t, ht):
        """Table t's [B, ht] view in either input layout."""
        if arr.ndim == 3:
            return arr[t, :, :ht]
        return arr[:, hot_col0[t] : hot_col0[t] + ht]

    budgets = plan.u_budget or (-1,) * t_
    hits = long_runs = long_hits = 0
    for t in range(t_):
        ht = plan.hot[t]  # ragged multi-hot: only this table's real columns
        bh = b_ * ht
        bag_of_pos = (np.arange(bh, dtype=np.int32) // ht).astype(np.int32)
        rows = _tbl(idx, t, ht).reshape(bh).astype(np.int32)
        bud = budgets[t]
        w_full = None
        if not skip_wts and wt is not None:
            w_full = _tbl(wt, t, ht).reshape(bh).astype(np.float32)
        if bud >= 0 and bud < bh:
            # owned-hits-only segment: drop weight-0 hits (exact — they
            # contribute nothing) so the static U covers only this shard's
            # ~1/M owned share; overflow is a loud error, not corruption
            if w_full is None:
                raise ValueError(
                    f"table {t} has u_budget {bud} < {bh} hits but no "
                    "weights to drop by (unit-weight batches have no "
                    "zero-weight hits)"
                )
            keep = np.flatnonzero(w_full != 0)
            if len(keep) > bud:
                raise ValueError(
                    f"table {t}: {len(keep)} nonzero-weight hits exceed "
                    f"u_budget {bud} — widen the budget margin"
                )
            rows = rows[keep]
            bag_of_pos = bag_of_pos[keep]
            w_full = w_full[keep]
            bh = len(keep)
        order = np.argsort(rows, kind="stable")
        rs, vs = rows[order], bag_of_pos[order]
        if skip_wts:
            ws = None
        else:
            w = np.ones(bh, dtype=np.float32) if w_full is None else w_full
            ws = w[order]
        ub = plan.u_base[t]
        nb = plan.blocks_per_table[t]
        gb = plan.block_base[t]
        bounds = np.searchsorted(rs, np.arange(nb + 1) * br)
        placed = rs[bounds[0]:bounds[-1]]
        runs = np.diff(np.flatnonzero(np.diff(placed, prepend=-2, append=-2)))
        hits += len(placed)
        long_runs += int((runs > K2_CHUNK).sum())
        long_hits += int(runs[runs > K2_CHUNK].sum())
        u = ub
        for j in range(nb):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            cnt = hi - lo
            if cnt == 0:
                items.append((gb + j, j * br, sent_u))
                continue
            rows_u[u : u + cnt] = rs[lo:hi]
            vals_u[u : u + cnt] = vs[lo:hi]
            if ws is not None:
                wts_u[u : u + cnt] = ws[lo:hi]
            run = -(-cnt // 128) * 128  # pad the block's run to x128
            for c in range(0, run, CHUNK):
                items.append((gb + j, j * br, u + c))
            u += run
        useg_end = (
            plan.u_base[t + 1] if t + 1 < t_ else plan.u_size
        )
        assert u <= useg_end, "U-segment overflow (static bound violated)"
        # cover items for the table's tail padding (K3 must write all of R)
        for c in range(u, useg_end, CHUNK):
            items.append((plan.pad_block, 0, c))
        w2t[ub // WINDOW : useg_end // WINDOW] = t

    # cover items for the trailing sentinel window
    for c in range(plan.u_size, u_total, CHUNK):
        items.append((plan.pad_block, 0, c))

    m = plan.max_items
    if len(items) > m:
        raise AssertionError(f"{len(items)} items > static bound {m}")
    arr = np.zeros((m, 3), dtype=np.int32)
    arr[: len(items)] = np.asarray(items, dtype=np.int32)
    arr[len(items) :] = (plan.pad_block, 0, sent_u)
    return StreamWork(
        rows_u=rows_u.reshape(-1, 8, 128),
        vals_u=vals_u.reshape(-1, 8, 128),
        wts_u=None if skip_wts else wts_u.reshape(-1, 8, 128),
        w2t=w2t,
        item_block=arr[:, 0].copy(),
        item_row0=arr[:, 1].copy(),
        item_u=arr[:, 2].copy(),
        num_real_items=len(items),
        hits=hits,
        long_runs=long_runs,
        long_hits=long_hits,
    )


def touched_update_items(
    plan: StreamPlan, work: StreamWork
) -> StreamWork:
    """K2-only worklist: keep items of blocks with >= 1 real hit (drop the
    one-sentinel-chunk items of hit-free blocks and the tail-cover items),
    re-padded to the same static length.

    The full list exists because a streamed forward must write EVERY R_u
    slot, and an update that writes a fresh table must rewrite every block.
    The port's K2 (ops/stream_kernels.py::stream_update) updates the table
    and accumulator in place, so untouched blocks need neither a read nor a
    write: the update costs O(touched blocks) instead of O(table).

    ONLY valid for the in-place update; a streamed forward (K3) must keep
    the full item list."""
    keep = (work.item_block < plan.pad_block) & (work.item_u < plan.u_size)
    ib, ir, iu = (
        work.item_block[keep], work.item_row0[keep], work.item_u[keep]
    )
    m = plan.max_items
    sent_u = plan.u_size
    out_b = np.full(m, plan.pad_block, np.int32)
    out_r = np.zeros(m, np.int32)
    out_u = np.full(m, sent_u, np.int32)
    n = len(ib)
    out_b[:n], out_r[:n], out_u[:n] = ib, ir, iu
    return dataclasses.replace(
        work, item_block=out_b, item_row0=out_r, item_u=out_u,
        num_real_items=n, touched_only=True,
    )


def stack_tables_padded(
    tables: Sequence[np.ndarray], plan: StreamPlan
) -> np.ndarray:
    """Stack tables into the block-aligned padded layout [padded_rows, d]."""
    d = tables[0].shape[1]
    out = np.zeros((plan.padded_rows, d), dtype=tables[0].dtype)
    for t, tab in enumerate(tables):
        off = plan.padded_offsets[t]
        out[off : off + tab.shape[0]] = tab
    return out


def pack_rowwise_accum(acc: np.ndarray, plan: StreamPlan) -> np.ndarray:
    """[rows] row-wise accumulator -> packed [padded_rows/128, 128]."""
    out = np.zeros(plan.padded_rows, dtype=np.float32)
    out[: acc.shape[0]] = acc
    return out.reshape(plan.acc_rows, 128)


def unpack_rowwise_accum(packed: np.ndarray, rows: int) -> np.ndarray:
    return np.asarray(packed).reshape(-1)[:rows]
