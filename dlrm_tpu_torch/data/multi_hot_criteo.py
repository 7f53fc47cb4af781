"""Materialized multi-hot Criteo dataset: writer + zero-copy mmap loader
(the port's copy of dlrm_tpu/data/multi_hot_criteo.py; files written by
either package load in the other).

Capability parity with torchrec_dlrm's multi-hot data path:
  * materialize_multihot_dataset — expands 1-hot processed days through the
    Multihot lookup tables and writes them to disk
    (scripts/materialize_synthetic_multihot_dataset.py:124-148);
  * MultiHotCriteoDataset — rank-aware batch loader over the materialized
    files with zero-copy memory mapping (multi_hot_criteo.py:166-188), batch
    round-robin rank assignment (:262, 281), buffer stitching across day
    files (:230-303), and last-batch padding.

On-disk layout (one directory): per day d,
    day_{d}_dense.npy   float32 [n, 13]   (log1p-transformed)
    day_{d}_labels.npy  float32 [n, 1]
    day_{d}_sparse.npy  int32   [n, sum(hot_sizes)]  (concatenated per-table)
plus meta.json {hot_sizes, table_sizes, days}. Plain .npy files are directly
np.memmap-able — the same zero-copy property the reference gets by mmapping
npy members inside an uncompressed zip, without the zip bookkeeping. A helper
to mmap members of reference-produced uncompressed .npz files is included for
interoperability.
"""

from __future__ import annotations

import json
import math
import os
import zipfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dlrm_tpu_torch.data.multi_hot import Multihot
from dlrm_tpu_torch.data.random_data import HostBatch


def mmap_npz_member(npz_path: str, member: str) -> np.ndarray:
    """Zero-copy np.memmap of one .npy member inside an UNCOMPRESSED .npz
    (the reference's trick, multi_hot_criteo.py:166-188)."""
    with zipfile.ZipFile(npz_path) as z:
        info = z.getinfo(member if member.endswith(".npy") else member + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError("member is compressed; zero-copy mmap impossible")
        with z.open(info) as f:
            # public header readers only (the private _read_array_header
            # changed signature once already); dispatch on the npy version
            version = np.lib.format.read_magic(f)
            if version >= (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            npy_header_bytes = f.tell()  # magic + header inside the member
    # absolute data offset = zip local file header + member's npy header
    with open(npz_path, "rb") as raw:
        raw.seek(info.header_offset + 26)  # name/extra length fields
        name_len = int.from_bytes(raw.read(2), "little")
        extra_len = int.from_bytes(raw.read(2), "little")
    abs_offset = info.header_offset + 30 + name_len + extra_len + npy_header_bytes
    return np.memmap(
        npz_path, dtype=dtype, mode="r", offset=abs_offset,
        shape=tuple(shape), order="F" if fortran else "C",
    )


def materialize_multihot_dataset(
    day_npz_files: Sequence[str],
    out_dir: str,
    table_sizes: Sequence[int],
    hot_sizes: Sequence[int],
    dist_type: str = "uniform",
    seed: int = 0,
) -> str:
    """Expand processed 1-hot days into the multi-hot on-disk layout."""
    os.makedirs(out_dir, exist_ok=True)
    mh = Multihot(hot_sizes, table_sizes, batch_size=0, dist_type=dist_type,
                  seed=seed)
    total_hot = int(np.sum(hot_sizes))
    for d, path in enumerate(day_npz_files):
        with np.load(path) as z:
            y = z["y"].astype(np.float32).reshape(-1, 1)
            dense = np.log1p(np.maximum(z["X_int"], 0).astype(np.float32))
            x_cat = z["X_cat"]
        n = y.shape[0]
        sparse = np.empty((n, total_hot), dtype=np.int32)
        col = 0
        for t, h in enumerate(hot_sizes):
            sparse[:, col : col + h] = mh.lookups[t][x_cat[:, t].astype(np.int64)]
            col += h
        np.save(os.path.join(out_dir, f"day_{d}_dense.npy"), dense)
        np.save(os.path.join(out_dir, f"day_{d}_labels.npy"), y)
        np.save(os.path.join(out_dir, f"day_{d}_sparse.npy"), sparse)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {
                "hot_sizes": [int(h) for h in hot_sizes],
                "table_sizes": [int(s) for s in table_sizes],
                "days": len(day_npz_files),
            },
            f,
        )
    return out_dir


class MultiHotCriteoDataset:
    """Rank-aware iterable over a materialized multi-hot directory.

    Batches are assigned round-robin to ranks (batch_idx % world == rank);
    batches spanning a day-file boundary are stitched from both files; a short
    final batch is padded with zero-weight rows (labels -1)."""

    def __init__(
        self,
        path: str,
        batch_size: int,
        days: Optional[Sequence[int]] = None,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = False,
        split: Optional[str] = None,  # None | first_half | second_half
    ):
        """split halves the selected days' row range — the reference divides
        the final day into DISJOINT val ("first_half") and test
        ("second_half") sets (torchrec_dlrm data_loader day-23 split)."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self.hot_sizes = meta["hot_sizes"]
        self.table_sizes = meta["table_sizes"]
        day_ids = list(days) if days is not None else list(range(meta["days"]))
        self.dense = [
            np.load(os.path.join(path, f"day_{d}_dense.npy"), mmap_mode="r")
            for d in day_ids
        ]
        self.labels = [
            np.load(os.path.join(path, f"day_{d}_labels.npy"), mmap_mode="r")
            for d in day_ids
        ]
        self.sparse = [
            np.load(os.path.join(path, f"day_{d}_sparse.npy"), mmap_mode="r")
            for d in day_ids
        ]
        self.day_rows = [a.shape[0] for a in self.dense]
        total_rows = int(np.sum(self.day_rows))
        if split is None:
            self.base, self.total = 0, total_rows
        elif split == "first_half":
            self.base, self.total = 0, total_rows // 2
        elif split == "second_half":
            self.base = total_rows // 2
            self.total = total_rows - self.base
        else:
            raise ValueError(f"split {split!r} not supported")
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        nb = self.total / batch_size
        self.num_batches = int(nb) if drop_last else math.ceil(nb)
        self.row_starts = np.concatenate([[0], np.cumsum(self.day_rows)])
        self.hot_max = max(self.hot_sizes)

    def __len__(self) -> int:
        return len(range(self.rank, self.num_batches, self.world_size))

    def _rows(self, lo: int, hi: int, arrays: List[np.ndarray]) -> np.ndarray:
        """Concatenate the [lo, hi) global-row slice across day files."""
        parts = []
        d = int(np.searchsorted(self.row_starts, lo, side="right") - 1)
        while lo < hi:
            local_lo = lo - self.row_starts[d]
            take = min(hi - lo, self.day_rows[d] - local_lo)
            parts.append(np.asarray(arrays[d][local_lo : local_lo + take]))
            lo += take
            d += 1
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def read_batch(self, idx: int, flat: bool = False) -> HostBatch:
        """flat=True keeps the sparse block in its ON-DISK row-major
        [B, sum(hot)] layout (wt=None): the U-layout builder and the flat
        per-hit device path consume it directly, skipping the [T, B, Hmax]
        padding expansion — the hot input path for stream-step training
        (to_device then REQUIRES flat_hots=). The padded default serves
        consumers that need [T, B, H] (the fused/butterfly paths)."""
        lo = self.base + idx * self.batch_size
        hi = min(self.base + self.total, lo + self.batch_size)
        dense = self._rows(lo, hi, self.dense)
        labels = self._rows(lo, hi, self.labels)
        sparse = self._rows(lo, hi, self.sparse)
        n = dense.shape[0]
        num_t = len(self.hot_sizes)
        if flat:
            if n < self.batch_size:
                pad = self.batch_size - n
                dense = np.concatenate(
                    [dense, np.zeros((pad, dense.shape[1]), np.float32)]
                )
                labels = np.concatenate(
                    [labels, -np.ones((pad, 1), np.float32)]
                )
                sparse = np.concatenate(
                    [sparse, np.zeros((pad, sparse.shape[1]), np.int32)]
                )
            return HostBatch(
                dense=np.ascontiguousarray(dense, dtype=np.float32),
                idx=np.ascontiguousarray(sparse, dtype=np.int32),
                wt=None,
                labels=np.ascontiguousarray(labels, dtype=np.float32),
            )
        idx_arr = np.zeros((num_t, n, self.hot_max), dtype=np.int32)
        wt = np.zeros((num_t, n, self.hot_max), dtype=np.float32)
        col = 0
        for t, h in enumerate(self.hot_sizes):
            idx_arr[t, :, :h] = sparse[:, col : col + h]
            wt[t, :, :h] = 1.0
            col += h
        if n < self.batch_size:
            pad = self.batch_size - n
            dense = np.concatenate([dense, np.zeros((pad, dense.shape[1]), np.float32)])
            labels = np.concatenate([labels, -np.ones((pad, 1), np.float32)])
            idx_arr = np.concatenate(
                [idx_arr, np.zeros((num_t, pad, self.hot_max), np.int32)], axis=1
            )
            wt = np.concatenate(
                [wt, np.zeros((num_t, pad, self.hot_max), np.float32)], axis=1
            )
        return HostBatch(
            dense=np.ascontiguousarray(dense, dtype=np.float32),
            idx=idx_arr,
            wt=wt,
            labels=np.ascontiguousarray(labels, dtype=np.float32),
        )

    def __iter__(self) -> Iterator[HostBatch]:
        for i in range(self.rank, self.num_batches, self.world_size):
            yield self.read_batch(i)


def main(argv=None):
    """Materialization CLI (materialize_synthetic_multihot_dataset.py analog):

        python -m dlrm_tpu_torch.data.multi_hot_criteo \\
            --in-processed-days day_0.npz day_1.npz --output-path out/ \\
            --num-embeddings-per-feature 200000,... --multi-hot-sizes 3,2,...
    """
    import argparse

    p = argparse.ArgumentParser(description="Materialize multi-hot Criteo")
    p.add_argument("--in-processed-days", nargs="+", required=True,
                   help="processed day npz files holding y, X_int and X_cat "
                   "(as the JAX package's data/criteo.py writes them)")
    p.add_argument("--output-path", required=True)
    p.add_argument("--num-embeddings-per-feature", required=True,
                   help="comma-separated table sizes")
    p.add_argument("--multi-hot-sizes", required=True,
                   help="comma-separated hot sizes")
    p.add_argument("--multi-hot-distribution-type", default="uniform",
                   choices=["uniform", "pareto"])
    args = p.parse_args(argv)
    sizes = [int(x) for x in args.num_embeddings_per_feature.split(",")]
    hots = [int(x) for x in args.multi_hot_sizes.split(",")]
    materialize_multihot_dataset(
        args.in_processed_days, args.output_path, sizes, hots,
        args.multi_hot_distribution_type,
    )
    print(f"materialized multi-hot dataset at {args.output_path}")
    return 0


if __name__ == "__main__":
    main()
