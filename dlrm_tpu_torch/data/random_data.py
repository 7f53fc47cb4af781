"""Random multi-hot host batches and their trip to the device (the port of
dlrm_tpu/data/random_data.py's HostBatch, ragged_multihot_batch and
fixed_multihot_batch)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from dlrm_tpu_torch.data.batch import Batch, StreamArrays
from dlrm_tpu_torch.device import resolve_device
from dlrm_tpu_torch.ops.stream_plan import (
    StreamWork,
    build_stream_work,
    flat_col0,
    touched_update_items,
)


@dataclass
class HostBatch:
    """Host-side numpy batch (padded [T, B, H] or flat [B, sum(hot)] idx)."""

    dense: np.ndarray  # [B, D] float32
    idx: np.ndarray  # [T, B, H] or [B, sum(hot)] int32
    wt: Optional[np.ndarray]  # same layout as idx, float32; None = all ones
    labels: np.ndarray  # [B, 1] float32
    stream: Optional[StreamWork] = None

    def with_stream_work(self, plan, unit_weights: bool = False,
                         update_touched_only: bool = False) -> "HostBatch":
        """Attach the U-layout work plan (built on the host, see
        ops/stream_plan.py). unit_weights=True promises every REAL hit
        (first plan.hot[t] columns) has weight 1.0: the builder then skips
        wts_u and the train step derives it on the device from
        rows_u != -1. update_touched_only=True drops the hit-free blocks'
        items, so the in-place K2 update touches only blocks with hits; such
        a batch is refused by the streamed forward (fwd_impl="stream"),
        which needs the full cover list."""
        work = build_stream_work(
            plan, self.idx, None if unit_weights else self.wt,
            skip_wts=unit_weights,
        )
        if update_touched_only:
            work = touched_update_items(plan, work)
        return dataclasses.replace(self, stream=work)

    def to_device(self, device="cuda", flat_hots=None) -> Batch:
        """Copy the batch to `device`. flat_hots (per-table hot sizes) ships
        idx/wt in the FLAT per-hit layout ([sum_t B*h_t] table-major)
        instead of padded [T, B, Hmax], so only real hits cross the bus.
        On CUDA every array goes through pinned host memory with a
        non_blocking copy on the current stream, so the host can build the
        next batch while the device works."""
        dev = resolve_device(device)
        idx, wt = self.idx, self.wt
        if idx.ndim == 2 and flat_hots is None:
            raise ValueError(
                "a flat [B, sum(hot)] HostBatch must ship with "
                "flat_hots= (the padded [T, B, H] device layout was never "
                "materialized)"
            )
        if flat_hots is not None:
            col0 = flat_col0(flat_hots)

            def tbl(arr, t, h):
                if arr.ndim == 3:
                    return arr[t, :, :h]
                return arr[:, col0[t] : col0[t] + h]

            idx = np.concatenate(
                [tbl(idx, t, h).ravel() for t, h in enumerate(flat_hots)]
            )
            wt = (
                None
                if wt is None
                else np.concatenate(
                    [tbl(wt, t, h).ravel() for t, h in enumerate(flat_hots)]
                )
            )

        def put(arr):
            if arr is None:
                return None
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if dev.type == "cuda":
                return t.pin_memory().to(dev, non_blocking=True)
            return t.clone()

        stream = None
        if self.stream is not None:
            w = self.stream
            stream = StreamArrays(
                rows_u=put(w.rows_u),
                vals_u=put(w.vals_u),
                wts_u=put(w.wts_u),
                w2t=put(w.w2t),
                item_block=put(w.item_block),
                item_row0=put(w.item_row0),
                item_u=put(w.item_u),
                touched_only=w.touched_only,
            )
        return Batch(
            dense=put(self.dense),
            idx=put(idx.astype(np.int32, copy=False)),
            wt=put(wt),
            labels=put(self.labels),
            stream=stream,
        )


# The MLPerf DLRM-v2 per-table hot sizes (214 hits per sample), as bench.py
# draws its ragged batches.
V2_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                12, 100, 27, 10, 3, 1, 1)


def ragged_multihot_batch(
    rng: np.random.Generator,
    num_dense: int,
    table_sizes: Sequence[int],
    hot_sizes: Sequence[int],
    batch_size: int,
) -> HostBatch:
    """Ragged per-table multi-hot batch in the padded [T, B, Hmax] layout:
    table t's first hot_sizes[t] columns are real hits (weight 1), the rest
    weight-0 padding. Same numpy draws as dlrm_tpu's, so one seed gives one
    batch in both packages."""
    hmax = max(int(h) for h in hot_sizes)
    t_ = len(table_sizes)
    idx = np.zeros((t_, batch_size, hmax), np.int32)
    wt = np.zeros((t_, batch_size, hmax), np.float32)
    for t, n in enumerate(table_sizes):
        h = int(hot_sizes[t])
        idx[t, :, :h] = rng.integers(0, n, (batch_size, h))
        wt[t, :, :h] = 1.0
    return HostBatch(
        dense=rng.normal(size=(batch_size, num_dense)).astype(np.float32),
        idx=idx,
        wt=wt,
        labels=rng.integers(0, 2, (batch_size, 1)).astype(np.float32),
    )


def fixed_multihot_batch(
    rng: np.random.Generator,
    num_dense: int,
    table_sizes: Sequence[int],
    batch_size: int,
    hot_size: int,
) -> HostBatch:
    """Fixed-hot-size batch: every bag has exactly hot_size indices, so wt is
    None (all ones). Same numpy draws as dlrm_tpu's."""
    dense = rng.random((batch_size, num_dense), dtype=np.float32)
    idx = np.stack(
        [
            rng.integers(0, size, (batch_size, hot_size), dtype=np.int64).astype(
                np.int32
            )
            for size in table_sizes
        ]
    )
    labels = (rng.random((batch_size, 1)) < 0.5).astype(np.float32)
    return HostBatch(dense=dense, idx=idx, wt=None, labels=labels)
