"""Random host batches and their trip to the device (the port of
dlrm_tpu/data/random_data.py: HostBatch, the reference-RNG generators
_gen_sparse_group / generate_random_batch / RandomDataset, with its
trace-driven synthetic branch (data/synthetic.py), and
ragged_multihot_batch / fixed_multihot_batch).

RandomDataset replicates the numpy global-RNG call sequence of the reference
generators (dlrm_data_pytorch.py:571-680, 838-960): dense via ra.rand,
per-(table, sample) bag sizes via ra.random(1), indices via ra.random(size)
rounded and uniquified, targets via ra.rand; the seed is reset on access to
batch 0 and a short last batch may be padded with label -1 rows. The same
seed gives the JAX package's batches bit for bit."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Optional, Sequence

import numpy as np

from dlrm_tpu_torch.config import DLRMConfig, TrainConfig
from dlrm_tpu_torch.ops.stream_plan import (
    StreamWork,
    build_stream_work,
    flat_col0,
    touched_update_items,
)

if TYPE_CHECKING:
    from dlrm_tpu_torch.data.batch import Batch


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
        next batch while the device works. Only this method (with the
        body, _to_device) needs torch: the day parsers' worker processes
        import this module without it."""
        from dlrm_tpu_torch.utils import profiling as prof

        with prof.scope(prof.TO_DEVICE):
            return self._to_device(device, flat_hots)

    def _to_device(self, device, flat_hots) -> Batch:
        import torch

        from dlrm_tpu_torch.data.batch import Batch, StreamArrays
        from dlrm_tpu_torch.device import resolve_device
        from dlrm_tpu_torch.utils import profiling as prof

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
            if not arr.flags.writeable:  # a read-only memmap slice
                arr = arr.copy()
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if dev.type != "cuda":
                return t.clone()
            with prof.scope(prof.TO_DEVICE_PIN):
                prof.count(prof.TO_DEVICE_BYTES, t.nbytes)
                pinned = t.pin_memory()
            with prof.scope(prof.TO_DEVICE_H2D):
                return pinned.to(dev, non_blocking=True)

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
                hits=w.hits,
                long_runs=w.long_runs,
                long_hits=w.long_hits,
            )
        return Batch(
            dense=put(self.dense),
            idx=put(idx.astype(np.int32, copy=False)),
            wt=put(wt),
            labels=put(self.labels),
            stream=stream,
        )


def _gen_sparse_group(
    size: int,
    num_indices_per_lookup: int,
    fixed: bool,
    dist: str,
    dmin: float,
    dmax: float,
    mu: float,
    sigma: float,
) -> np.ndarray:
    """One bag of unique sorted indices; numpy RNG consumption order matches
    dlrm_data_pytorch.py:923-951 exactly (including np.round banker's rounding)."""
    if fixed:
        group_size = np.int64(num_indices_per_lookup)
    else:
        r = np.random.random(1)
        group_size = np.int64(
            np.round(max([1.0], r * min(size, num_indices_per_lookup)))
        )
    if dist == "gaussian":
        if mu == -1:
            mu = (dmax + dmin) / 2.0
        r = np.random.normal(mu, sigma, group_size)
        group = np.clip(r, dmin, dmax)
        group = np.unique(group).astype(np.int64)
    elif dist == "uniform":
        r = np.random.random(group_size)
        group = np.unique(np.round(r * (size - 1)).astype(np.int64))
    else:
        raise ValueError(f"rand_data_dist {dist!r} not supported")
    return group


def generate_random_batch(
    num_dense: int,
    table_sizes: Sequence[int],
    n: int,
    hot_size: int,
    num_indices_per_lookup_fixed: bool = False,
    round_targets: bool = False,
    rand_data_dist: str = "uniform",
    rand_data_min: float = 0.0,
    rand_data_max: float = 1.0,
    rand_data_mu: float = -1.0,
    rand_data_sigma: float = 1.0,
    pad_batch_to: Optional[int] = None,
) -> HostBatch:
    """One batch drawn from the CURRENT np.random global state (parity path).

    pad_batch_to: optionally pad a short final batch up to a static size with
    zero-weight rows (labels padded with -1 so eval can mask them).
    """
    dense = np.random.rand(n, num_dense).astype(np.float32)
    num_t = len(table_sizes)
    idx = np.zeros((num_t, n, hot_size), dtype=np.int32)
    wt = np.zeros((num_t, n, hot_size), dtype=np.float32)
    for k, size in enumerate(table_sizes):
        for b in range(n):
            group = _gen_sparse_group(
                int(size),
                hot_size,
                num_indices_per_lookup_fixed,
                rand_data_dist,
                rand_data_min,
                rand_data_max,
                rand_data_mu,
                rand_data_sigma,
            )
            ln = min(len(group), hot_size)
            idx[k, b, :ln] = group[:ln]
            wt[k, b, :ln] = 1.0
    labels = np.random.rand(n, 1).astype(np.float32)
    if round_targets:
        labels = np.round(labels).astype(np.float32)
    if pad_batch_to is not None and n < pad_batch_to:
        pad = pad_batch_to - n
        dense = np.concatenate([dense, np.zeros((pad, num_dense), np.float32)])
        idx = np.concatenate([idx, np.zeros((num_t, pad, hot_size), np.int32)], axis=1)
        wt = np.concatenate([wt, np.zeros((num_t, pad, hot_size), np.float32)], axis=1)
        labels = np.concatenate([labels, -np.ones((pad, 1), np.float32)])
    return HostBatch(dense=dense, idx=idx, wt=wt, labels=labels)


class RandomDataset:
    """Batch-indexable random dataset (RandomDataset, dlrm_data_pytorch.py:571-680).

    Each __getitem__(i) yields one whole batch; accessing element 0 resets the
    global numpy seed when reset_seed_on_access is set (:635-638), reproducing
    identical data every epoch.
    """

    def __init__(
        self,
        model_cfg: DLRMConfig,
        train_cfg: TrainConfig,
        reset_seed_on_access: bool = True,
        pad_last_batch: bool = False,
        trace_file: str = "",
        enable_padding: bool = False,
    ):
        """trace_file: the per-table dist-file path template ('j' stands
        for the table index) of data_generation="synthetic";
        enable_padding: its --data-trace-enable-padding."""
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.reset_seed_on_access = reset_seed_on_access
        self.pad_last_batch = pad_last_batch
        self.trace_file = trace_file
        self.enable_padding = enable_padding
        # single source of truth for the batch-count derivation
        nb = train_cfg.num_train_batches
        if train_cfg.num_batches > 0:
            self.data_size = nb * train_cfg.mini_batch_size
        else:
            self.data_size = train_cfg.data_size
        self.num_batches = nb

    def __len__(self) -> int:
        return self.num_batches

    def __getitem__(self, index: int) -> HostBatch:
        tc, mc = self.train_cfg, self.model_cfg
        if self.reset_seed_on_access and index == 0:
            np.random.seed(tc.numpy_rand_seed)
        n = min(tc.mini_batch_size, self.data_size - index * tc.mini_batch_size)
        if tc.data_generation == "synthetic":
            from dlrm_tpu_torch.data.synthetic import generate_synthetic_batch

            return generate_synthetic_batch(
                mc.num_dense,
                mc.table_sizes,
                n,
                mc.num_indices_per_lookup,
                self.trace_file,
                tc.num_indices_per_lookup_fixed,
                self.enable_padding,
                round_targets=tc.round_targets,
                pad_batch_to=(
                    tc.mini_batch_size if self.pad_last_batch else None
                ),
            )
        return generate_random_batch(
            mc.num_dense,
            mc.table_sizes,
            n,
            mc.num_indices_per_lookup,
            tc.num_indices_per_lookup_fixed,
            tc.round_targets,
            tc.rand_data_dist,
            tc.rand_data_min,
            tc.rand_data_max,
            tc.rand_data_mu,
            tc.rand_data_sigma,
            pad_batch_to=tc.mini_batch_size if self.pad_last_batch else None,
        )

    def __iter__(self) -> Iterator[HostBatch]:
        for i in range(self.num_batches):
            yield self[i]


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
