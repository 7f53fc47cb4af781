"""Multi-hot synthesizer: convert 1-hot Criteo batches to synthetic multi-hot
(the port's copy of dlrm_tpu/data/multi_hot.py).

Capability parity with torchrec_dlrm/multi_hot.py (class Multihot): each table
gets a lookup matrix [rows, hot_size] whose first column is the identity and
whose remaining columns are drawn uniform or Pareto(a=0.25) over the table's
rows with a fixed seed (:80-113); batch conversion replaces each 1-hot index
with its row of the lookup matrix (:115-159): one numpy gather per table,
into the padded [T, B, H] layout.

Also provides RestartableMap (:14-24): a re-iterable transforming wrapper.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Sequence

import numpy as np

from dlrm_tpu_torch.data.random_data import HostBatch


class RestartableMap:
    """Re-iterable map(fn, iterable) (multi_hot.py:14-24)."""

    def __init__(self, fn: Callable, source: Iterable):
        self.fn = fn
        self.source = source

    def __iter__(self):
        for x in self.source:
            yield self.fn(x)

    def __len__(self):
        return len(self.source)


class Multihot:
    def __init__(
        self,
        multi_hot_sizes: Sequence[int],
        num_embeddings_per_feature: Sequence[int],
        batch_size: int,
        collect_freqs_stats: bool = False,
        dist_type: str = "uniform",
        seed: int = 0,
    ):
        if dist_type not in ("uniform", "pareto"):
            raise ValueError(f"dist_type {dist_type!r} not supported")
        self.multi_hot_sizes = list(multi_hot_sizes)
        self.table_sizes = list(num_embeddings_per_feature)
        self.batch_size = batch_size
        self.dist_type = dist_type
        self.collect_freqs_stats = collect_freqs_stats
        rng = np.random.RandomState(seed)
        self.lookups: List[np.ndarray] = []
        for rows, h in zip(self.table_sizes, self.multi_hot_sizes):
            lk = np.empty((rows, h), dtype=np.int64)
            lk[:, 0] = np.arange(rows)  # first column = the original index
            if h > 1:
                if dist_type == "uniform":
                    lk[:, 1:] = rng.randint(0, rows, size=(rows, h - 1))
                else:  # pareto, clipped into range (multi_hot.py:96-107)
                    # int32 cast BEFORE the modulo, like the reference —
                    # ~0.5% of Pareto(0.25) draws exceed 2^31 and must wrap
                    # identically for fixed-seed table parity
                    draws = rng.pareto(a=0.25, size=(rows, h - 1)).astype(
                        np.int32
                    )
                    lk[:, 1:] = draws.astype(np.int64) % rows
            self.lookups.append(lk)
        # access-frequency stats pre/post conversion (multi_hot.py:65-73);
        # only materialized when requested — real configs total ~880M rows
        if collect_freqs_stats:
            self.freqs_pre = [np.zeros(n, np.int64) for n in self.table_sizes]
            self.freqs_post = [
                np.zeros(n, np.int64) for n in self.table_sizes
            ]
        else:
            self.freqs_pre = self.freqs_post = None

    def convert_to_multi_hot(self, batch: HostBatch) -> HostBatch:
        """1-hot HostBatch (H=1) -> multi-hot HostBatch (H=max hot size)."""
        num_t, b, h_in = batch.idx.shape
        assert h_in == 1, "multi-hot conversion expects 1-hot input"
        h_max = max(self.multi_hot_sizes)
        idx = np.zeros((num_t, b, h_max), dtype=np.int32)
        wt = np.zeros((num_t, b, h_max), dtype=np.float32)
        for t in range(num_t):
            one_hot = batch.idx[t, :, 0].astype(np.int64)
            h = self.multi_hot_sizes[t]
            expanded = self.lookups[t][one_hot]  # [B, h]
            idx[t, :, :h] = expanded
            wt[t, :, :h] = batch.wt[t] if batch.wt is not None else 1.0
            if self.collect_freqs_stats:
                np.add.at(self.freqs_pre[t], one_hot, 1)
                np.add.at(self.freqs_post[t], expanded.ravel(), 1)
        return HostBatch(dense=batch.dense, idx=idx, wt=wt, labels=batch.labels)

    def convert_dataloader(self, loader: Iterable) -> RestartableMap:
        return RestartableMap(self.convert_to_multi_hot, loader)

    def save_freqs_stats(self, path: str) -> None:
        if self.freqs_pre is None:
            raise ValueError(
                "no frequency stats collected (collect_freqs_stats=False)"
            )
        np.savez(
            path,
            **{f"pre_{i}": f for i, f in enumerate(self.freqs_pre)},
            **{f"post_{i}": f for i, f in enumerate(self.freqs_post)},
        )
