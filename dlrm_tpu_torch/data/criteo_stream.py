"""Out-of-core Criteo preprocessing + memmap day-file dataset (the port's
copy of dlrm_tpu/data/criteo_stream.py; numpy only).

Terabyte-scale twin of data/criteo.py::preprocess_raw, which holds every
day in host RAM (fine for tests, impossible for the 1TB dataset). This
module mirrors the reference's memory-map machinery:

  * per-day parsing in PARALLEL WORKER PROCESSES (the reference's
    dataset_multiprocessing path, data_utils.py:1104-1143), each writing
    raw per-day .npy files + its per-column unique values;
  * per-column dictionaries merged in the parent (data_utils.py:1152-1178);
  * chunked categorical remap over memmaps (processCriteoAdData,
    data_utils.py:114-171);
  * an OUT-OF-CORE cross-day shuffle equivalent to the 2-pass memmap
    bucket shuffle (concatCriteoAdData, data_utils.py:555-726): the global
    permutation is drawn with the SAME RandomState sequence as the in-RAM
    path — so on inputs small enough to run both, the outputs are
    BIT-EQUAL — and rows are moved chunk-by-chunk through memmaps, never
    materializing a full day (let alone the dataset) in RAM;
  * chunked day->bin conversion (data_loader_terabyte.py:251-290
    semantics, same record layout).

Peak RAM = O(chunk_rows * 160B) + dictionaries + the permutation index
(8B/row — 20x smaller than row data; the row data itself never loads).

Artifacts are uncompressed .npy triples (day_{i}.y.npy / .X_int.npy /
.X_cat.npy) so CriteoDayDataset can np.memmap them — the day-file
CriteoDataset equivalent (dlrm_data_pytorch.py:50-321) behind the v1
--memory-map flag.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dlrm_tpu_torch.data.criteo import NUM_CAT, NUM_DENSE, parse_raw_day
from dlrm_tpu_torch.data.random_data import HostBatch


def _day_prefix(out_dir: str, i: int) -> str:
    return os.path.join(out_dir, f"day_{i}_processed")


def _parse_worker(day: int, path: str, out_dir: str, max_ind_range: int,
                  sub_sample_rate: float, seed: int) -> None:
    d = parse_raw_day(path, max_ind_range, sub_sample_rate, seed)
    pre = os.path.join(out_dir, f"day_{day}_raw")
    np.save(pre + ".y.npy", d["y"].astype(np.int32))
    np.save(pre + ".X_int.npy", d["X_int"].astype(np.int32))
    np.save(pre + ".X_cat.npy", d["X_cat"].astype(np.int64))
    uniq = {
        f"col_{c}": np.unique(d["X_cat"][:, c]) for c in range(NUM_CAT)
    }
    np.savez(pre + ".uniq.npz", **uniq)


@dataclass
class CriteoStreamArtifacts:
    day_prefixes: List[str]  # day_{i}_processed (.y/.X_int/.X_cat .npy)
    counts_file: str
    counts: np.ndarray

    def day_rows(self, i: int) -> int:
        return np.load(
            self.day_prefixes[i] + ".y.npy", mmap_mode="r"
        ).shape[0]


def preprocess_raw_streaming(
    raw_files: Sequence[str],
    out_dir: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    randomize: str = "total",
    seed: int = 123,
    num_workers: int = 1,
    chunk_rows: int = 1_000_000,
) -> CriteoStreamArtifacts:
    """getCriteoAdData equivalent, out-of-core. Same per-day RNG seeding
    (seed + day) and the same shuffle RandomState draw order as
    criteo.preprocess_raw, so small inputs round-trip bit-equal."""
    os.makedirs(out_dir, exist_ok=True)
    days = len(raw_files)

    # ---- phase 1: parse days in worker processes (data_utils.py:1104-1143),
    # or in this process for one worker. spawn, not fork: the parent
    # usually has torch's threads running, and forking them can deadlock.
    ctx = mp.get_context("spawn")
    num_workers = max(1, int(num_workers))
    pending = list(enumerate(raw_files))
    if num_workers == 1:
        for i, p in pending:
            _parse_worker(i, p, out_dir, max_ind_range, sub_sample_rate,
                          seed + i)
        pending = []
    running: List[mp.Process] = []
    try:
        while pending or running:
            while pending and len(running) < num_workers:
                i, p = pending.pop(0)
                proc = ctx.Process(
                    target=_parse_worker,
                    args=(i, p, out_dir, max_ind_range, sub_sample_rate,
                          seed + i),
                )
                proc.start()
                running.append(proc)
            # reap ANY finished worker (a bounded join on the oldest is just
            # the wakeup; slower days must not serialize the whole pool)
            if running:
                running[0].join(timeout=0.2)
            for proc in list(running):
                if not proc.is_alive():
                    if proc.exitcode != 0:
                        raise RuntimeError(
                            f"day parser worker failed (exit {proc.exitcode})"
                        )
                    running.remove(proc)
    except BaseException:
        for proc in running:  # don't orphan multi-GB parsers on failure
            if proc.is_alive():
                proc.terminate()
        for proc in running:
            proc.join(timeout=5.0)
        raise

    # ---- phase 2: merge per-day uniques -> per-column dictionaries
    sorted_keys: List[np.ndarray] = []
    for c in range(NUM_CAT):
        uniq: Optional[np.ndarray] = None
        for i in range(days):
            with np.load(
                os.path.join(out_dir, f"day_{i}_raw.uniq.npz")
            ) as z:
                u = z[f"col_{c}"]
            uniq = u if uniq is None else np.union1d(uniq, u)
        sorted_keys.append(uniq)
    counts = np.asarray([len(k) for k in sorted_keys], dtype=np.int64)
    counts_file = os.path.join(out_dir, "day_fea_count.npz")
    np.savez_compressed(counts_file, counts=counts)

    # ---- phase 3: chunked remap raw cats -> contiguous ids (memmap in/out)
    day_rows = []
    for i in range(days):
        pre_raw = os.path.join(out_dir, f"day_{i}_raw")
        x_cat = np.load(pre_raw + ".X_cat.npy", mmap_mode="r")
        n = x_cat.shape[0]
        day_rows.append(n)
        out = np.lib.format.open_memmap(
            pre_raw + ".cat_ids.npy", mode="w+", dtype=np.int32,
            shape=(n, NUM_CAT),
        )
        for lo in range(0, n, chunk_rows):
            hi = min(n, lo + chunk_rows)
            block = np.asarray(x_cat[lo:hi])
            for c in range(NUM_CAT):
                out[lo:hi, c] = np.searchsorted(
                    sorted_keys[c], block[:, c]
                ).astype(np.int32)
        out.flush()
        del out

    # ---- phase 4: out-of-core shuffle into the final day files.
    # RandomState draw order matches criteo.preprocess_raw exactly:
    # 'total' -> one permutation of the train rows (last day untouched);
    # 'day'   -> one permutation per train day, in day order.
    rng = np.random.RandomState(seed)
    offs = np.concatenate([[0], np.cumsum(day_rows)]).astype(np.int64)
    n_last = day_rows[-1]
    n_train = int(offs[-1]) - n_last

    if randomize == "total" and days > 1:
        perm = rng.permutation(n_train)
        src_of = np.empty(int(offs[-1]), dtype=np.int64)
        # in-RAM path: shuffled[pos] = concat[perm[pos]]
        src_of[:n_train] = perm
        src_of[n_train:] = np.arange(n_train, int(offs[-1]))
    elif randomize == "day":
        src_of = np.arange(int(offs[-1]), dtype=np.int64)
        for i in range(days - 1):
            p = rng.permutation(day_rows[i])
            src_of[offs[i] : offs[i + 1]] = offs[i] + p
    else:
        src_of = np.arange(int(offs[-1]), dtype=np.int64)

    ys = [
        np.load(os.path.join(out_dir, f"day_{i}_raw.y.npy"), mmap_mode="r")
        for i in range(days)
    ]
    xis = [
        np.load(
            os.path.join(out_dir, f"day_{i}_raw.X_int.npy"), mmap_mode="r"
        )
        for i in range(days)
    ]
    xcs = [
        np.load(
            os.path.join(out_dir, f"day_{i}_raw.cat_ids.npy"), mmap_mode="r"
        )
        for i in range(days)
    ]

    def gather(global_ids: np.ndarray, mms: List[np.ndarray]) -> np.ndarray:
        """Gather rows by global index from the per-day memmaps."""
        day_of = np.searchsorted(offs, global_ids, side="right") - 1
        parts = np.empty(
            (len(global_ids),) + mms[0].shape[1:], dtype=mms[0].dtype
        )
        for d in np.unique(day_of):
            sel = day_of == d
            local = global_ids[sel] - offs[d]
            # sort local reads for sequentialish IO, then undo
            order = np.argsort(local, kind="stable")
            got = np.asarray(mms[d][local[order]])
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            parts[sel] = got[inv]
        return parts

    prefixes = []
    for i in range(days):
        pre = _day_prefix(out_dir, i)
        n = day_rows[i]
        oy = np.lib.format.open_memmap(
            pre + ".y.npy", mode="w+", dtype=np.int32, shape=(n,)
        )
        oi = np.lib.format.open_memmap(
            pre + ".X_int.npy", mode="w+", dtype=np.int32,
            shape=(n, NUM_DENSE),
        )
        oc = np.lib.format.open_memmap(
            pre + ".X_cat.npy", mode="w+", dtype=np.int32,
            shape=(n, NUM_CAT),
        )
        for lo in range(0, n, chunk_rows):
            hi = min(n, lo + chunk_rows)
            ids = src_of[int(offs[i]) + lo : int(offs[i]) + hi]
            oy[lo:hi] = gather(ids, ys)
            oi[lo:hi] = gather(ids, xis)
            oc[lo:hi] = gather(ids, xcs)
        for m in (oy, oi, oc):
            m.flush()
        del oy, oi, oc
        prefixes.append(pre)

    for i in range(days):  # drop intermediates
        pre_raw = os.path.join(out_dir, f"day_{i}_raw")
        for suf in (".y.npy", ".X_int.npy", ".X_cat.npy", ".cat_ids.npy",
                    ".uniq.npz"):
            try:
                os.remove(pre_raw + suf)
            except FileNotFoundError:
                pass
    return CriteoStreamArtifacts(
        day_prefixes=prefixes, counts_file=counts_file, counts=counts
    )


def days_to_binary_streaming(
    day_prefixes: Sequence[str],
    output_file_path: str,
    split: str = "train",
    chunk_rows: int = 1_000_000,
) -> None:
    """Chunked day .npy -> packed int32 .bin; byte-identical to
    criteo.numpy_to_binary on the same rows (data_loader_terabyte.py:251-290
    record layout: [y, 13 dense, 26 cat] int32)."""

    def write_rows(out, pre: str, lo: int, hi: int) -> None:
        y = np.load(pre + ".y.npy", mmap_mode="r")
        xi = np.load(pre + ".X_int.npy", mmap_mode="r")
        xc = np.load(pre + ".X_cat.npy", mmap_mode="r")
        for a in range(lo, hi, chunk_rows):
            b = min(hi, a + chunk_rows)
            rec = np.concatenate(
                [
                    np.asarray(y[a:b]).reshape(-1, 1),
                    np.asarray(xi[a:b]),
                    np.asarray(xc[a:b]),
                ],
                axis=1,
            ).astype(np.int32)
            out.write(rec.tobytes())

    with open(output_file_path, "wb") as out:
        if split == "train":
            for pre in day_prefixes:
                n = np.load(pre + ".y.npy", mmap_mode="r").shape[0]
                write_rows(out, pre, 0, n)
        else:
            assert len(day_prefixes) == 1
            pre = day_prefixes[0]
            n = np.load(pre + ".y.npy", mmap_mode="r").shape[0]
            mid = int(math.ceil(n / 2.0))
            if split == "test":
                write_rows(out, pre, 0, mid)
            else:
                write_rows(out, pre, mid, n)


class CriteoDayDataset:
    """Memmap day-file dataset with day-switching access — the v1
    CriteoDataset memory-map path (dlrm_data_pytorch.py:50-321, behind
    --memory-map): train = days 0..n-2 (+ nothing loaded up front), test /
    val = first/second half of the last day. Yields the same HostBatch
    layout as CriteoBinFile (one-hot cats, log1p dense)."""

    def __init__(
        self,
        day_prefixes: Sequence[str],
        counts_file: str,
        batch_size: int,
        split: str = "train",
        max_ind_range: int = -1,
    ):
        self.batch_size = batch_size
        self.max_ind_range = max_ind_range
        with np.load(counts_file) as z:
            self.counts = z["counts"]
        if split == "train":
            self.prefixes = list(day_prefixes[:-1]) or list(day_prefixes)
            self.lo = 0
            self.hi = None  # full days
        else:
            self.prefixes = [day_prefixes[-1]]
            n = np.load(
                day_prefixes[-1] + ".y.npy", mmap_mode="r"
            ).shape[0]
            mid = int(math.ceil(n / 2.0))
            self.lo, self.hi = (0, mid) if split == "test" else (mid, n)
        self.day_rows = []
        for pre in self.prefixes:
            n = np.load(pre + ".y.npy", mmap_mode="r").shape[0]
            lo = self.lo if len(self.prefixes) == 1 else 0
            hi = self.hi if (self.hi is not None and len(self.prefixes) == 1) else n
            self.day_rows.append(hi - lo)
        self.total = sum(self.day_rows)
        self._cur_day = -1
        self._mm: Optional[Tuple] = None

    def __len__(self) -> int:
        return math.ceil(self.total / self.batch_size)

    def _switch_day(self, d: int) -> None:
        # the reference's day-switching __getitem__ keeps ONE day mapped
        # (dlrm_data_pytorch.py:225-247); so do we
        pre = self.prefixes[d]
        self._mm = (
            np.load(pre + ".y.npy", mmap_mode="r"),
            np.load(pre + ".X_int.npy", mmap_mode="r"),
            np.load(pre + ".X_cat.npy", mmap_mode="r"),
        )
        self._cur_day = d

    def _rows(self, start: int, stop: int) -> Tuple[np.ndarray, ...]:
        """Gather rows [start, stop) of the logical split, switching day
        memmaps at boundaries."""
        base = self.lo if len(self.prefixes) == 1 else 0
        out_y, out_i, out_c = [], [], []
        pos = 0
        for d, rows in enumerate(self.day_rows):
            lo = max(start - pos, 0)
            hi = min(stop - pos, rows)
            if lo < hi:
                if self._cur_day != d:
                    self._switch_day(d)
                y, xi, xc = self._mm
                out_y.append(np.asarray(y[base + lo : base + hi]))
                out_i.append(np.asarray(xi[base + lo : base + hi]))
                out_c.append(np.asarray(xc[base + lo : base + hi]))
            pos += rows
        return (
            np.concatenate(out_y),
            np.concatenate(out_i),
            np.concatenate(out_c),
        )

    def __getitem__(self, b: int) -> HostBatch:
        start = b * self.batch_size
        stop = min(self.total, start + self.batch_size)
        y, xi, xc = self._rows(start, stop)
        if self.max_ind_range > 0:
            xc = xc % self.max_ind_range
        dense = np.log1p(np.maximum(xi, 0).astype(np.float32))
        idx = np.ascontiguousarray(xc.T[:, :, None].astype(np.int32))
        n = y.shape[0]
        wt = np.ones((NUM_CAT, self.batch_size, 1), np.float32)
        labels = y.astype(np.float32).reshape(-1, 1)
        if n < self.batch_size:
            pad = self.batch_size - n
            dense = np.concatenate(
                [dense, np.zeros((pad, NUM_DENSE), np.float32)]
            )
            idx = np.concatenate(
                [idx, np.zeros((NUM_CAT, pad, 1), np.int32)], axis=1
            )
            wt[:, n:, :] = 0.0
            labels = np.concatenate([labels, -np.ones((pad, 1), np.float32)])
        else:
            wt = wt[:, :n, :]
        return HostBatch(dense=dense, idx=idx, wt=wt, labels=labels)

    def __iter__(self) -> Iterator[HostBatch]:
        for b in range(len(self)):
            yield self[b]


def main(argv=None) -> int:
    """Standalone preprocessing CLI (the role of the reference's
    cython_criteo.py and process_Criteo_1TB_Click_Logs_dataset.sh): raw tsv
    days -> processed memmap day files (+ optional packed bins)."""
    import argparse

    p = argparse.ArgumentParser(
        description="Out-of-core Criteo preprocessing (tsv days -> memmap "
        "day files -> optional train/val/test bins)"
    )
    p.add_argument("--input-dir", required=True,
                   help="directory holding day_0..day_{N-1} raw tsv files")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--days", type=int, default=24)
    p.add_argument("--max-ind-range", type=int, default=-1)
    p.add_argument("--data-sub-sample-rate", type=float, default=0.0)
    p.add_argument("--data-randomize", type=str, default="total",
                   choices=["total", "day", "none"])
    p.add_argument("--numpy-rand-seed", type=int, default=123)
    p.add_argument("--dataset-multiprocessing", action="store_true",
                   help="parse days in parallel worker processes")
    p.add_argument("--chunk-rows", type=int, default=1_000_000)
    p.add_argument("--make-bins", action="store_true",
                   help="also write train/val/test .bin files")
    args = p.parse_args(argv)

    raw = [
        os.path.join(args.input_dir, f"day_{d}") for d in range(args.days)
    ]
    for f in raw:
        if not os.path.exists(f):
            raise SystemExit(f"missing raw day file {f}")
    workers = (
        max(2, os.cpu_count() or 2)
        if args.dataset_multiprocessing
        else 1
    )
    art = preprocess_raw_streaming(
        raw, args.output_dir, args.max_ind_range,
        args.data_sub_sample_rate, args.data_randomize,
        args.numpy_rand_seed, num_workers=workers,
        chunk_rows=args.chunk_rows,
    )
    print(f"processed {args.days} days -> {args.output_dir}; table counts: "
          f"{art.counts.tolist()}")
    if args.make_bins:
        days_to_binary_streaming(
            art.day_prefixes[:-1] or art.day_prefixes,
            os.path.join(args.output_dir, "train_data.bin"), "train",
            chunk_rows=args.chunk_rows,
        )
        days_to_binary_streaming(
            [art.day_prefixes[-1]],
            os.path.join(args.output_dir, "test_data.bin"), "test",
            chunk_rows=args.chunk_rows,
        )
        days_to_binary_streaming(
            [art.day_prefixes[-1]],
            os.path.join(args.output_dir, "val_data.bin"), "val",
            chunk_rows=args.chunk_rows,
        )
        print("wrote train/test/val bins")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
