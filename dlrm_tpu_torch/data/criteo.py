"""Criteo (Kaggle DAC / Terabyte) pipeline: preprocessing + loaders (the
port's copy of dlrm_tpu/data/criteo.py; numpy and the native parser, no
torch).

The reference pipeline's artifacts, so that datasets prepared by either
package (or the reference) interoperate:

  raw tsv (label \\t 13 int \\t 26 hex cat)
    -> per-day npz {X_int [n,13] i32, X_cat [n,26] i32, y [n] i32}
       with optional hex %% max_ind_range hashing and zero-label subsampling
       (data_utils.py:974-1086 process_one_file)
    -> per-column dictionaries -> contiguous ids + table counts npz
       (data_utils.py:1152-1178)
    -> day reordering / total shuffle (concatCriteoAdData, :174-757)
    -> train/val/test .bin: int32 records [y, 13 dense, 26 cat]
       (data_loader_terabyte.py:251-290 numpy_to_binary; val/test = halves of
       the last day, test first then val -- :276-288)

Loading: CriteoBinFile mirrors CriteoBinDataset (data_loader_terabyte.py:
197-248): one seek+read per batch, dense transformed with log1p, one-hot
categorical indices. The hot parse loop runs through the native C++
parser (native/criteo_preproc.cc, built with g++ at first use) where it
builds; the numpy parser is the fallback and the correctness oracle.
parse_raw_day prints which of the two parsed each file.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np

from dlrm_tpu_torch.data.random_data import HostBatch

NUM_DENSE = 13
NUM_CAT = 26
TOT_FEA = 1 + NUM_DENSE + NUM_CAT  # label + dense + cat


# --------------------------------------------------------------- raw parsing


def parse_raw_day(
    path: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    seed: int = 123,
) -> Dict[str, np.ndarray]:
    """Parse one raw tsv day file -> arrays (python fallback path).

    Matches process_one_file semantics (data_utils.py:974-1086): missing ints
    -> 0, hex cats -> int (% max_ind_range if set), optional random drop of
    zero-label rows at sub_sample_rate. Prints which parser ran.
    """
    from dlrm_tpu_torch.native import criteo_native

    if criteo_native.available():
        print(f"criteo: parsed {path} with the native parser")
        return criteo_native.parse_raw_day(
            path, max_ind_range, sub_sample_rate, seed
        )
    print(f"criteo: parsed {path} with the numpy parser (the native "
          "parser did not build)")
    rng = np.random.RandomState(seed)
    ys: List[int] = []
    dense_rows: List[List[int]] = []
    cat_rows: List[List[int]] = []
    with open(path, "rb") as f:
        for line in f:
            cols = line.rstrip(b"\r\n").split(b"\t")
            if len(cols) < TOT_FEA:  # pad short rows with missing fields
                cols = cols + [b""] * (TOT_FEA - len(cols))
            elif len(cols) > TOT_FEA:  # clamp malformed long rows (the
                cols = cols[:TOT_FEA]  # native parser does the same)
            y = int(cols[0]) if cols[0] else 0
            if sub_sample_rate > 0.0 and y == 0:
                if rng.uniform() < sub_sample_rate:
                    continue
            dense = [int(c) if c else 0 for c in cols[1 : 1 + NUM_DENSE]]
            if max_ind_range > 0:
                cats = [
                    (int(c, 16) % max_ind_range) if c else 0
                    for c in cols[1 + NUM_DENSE :]
                ]
            else:
                cats = [int(c, 16) if c else 0 for c in cols[1 + NUM_DENSE :]]
            ys.append(y)
            dense_rows.append(dense)
            cat_rows.append(cats)
    return {
        "y": np.asarray(ys, dtype=np.int32),
        "X_int": np.asarray(dense_rows, dtype=np.int32),
        "X_cat": np.asarray(cat_rows, dtype=np.int64),
    }


def split_kaggle_train(path: str, out_dir: str, days: int = 7) -> List[str]:
    """Split Kaggle train.txt into `days` chunk files (data_utils.py:930-946).

    Two streaming passes (count, then copy) — train.txt is ~11GB and
    readlines() would hold 2-3x that in RAM."""
    n = 0
    with open(path, "rb") as f:
        for _ in f:
            n += 1
    per = math.ceil(n / days)
    out = []
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "rb") as src:
        for d in range(days):
            p = os.path.join(out_dir, f"day_{d}")
            with open(p, "wb") as dst:
                for _ in range(per if d < days - 1 else n - per * (days - 1)):
                    line = src.readline()
                    if not line:
                        break
                    dst.write(line)
            out.append(p)
    return out


# --------------------------------------------------- dictionaries / remapping


def build_dicts(day_cats: Sequence[np.ndarray]) -> List[Dict[int, int]]:
    """Per-column raw-value -> contiguous-id dictionaries over all days
    (data_utils.py:1152-1178). Ids are assigned in sorted raw-value order for
    determinism."""
    dicts: List[Dict[int, int]] = []
    for col in range(NUM_CAT):
        uniq: set = set()
        for cats in day_cats:
            uniq.update(np.unique(cats[:, col]).tolist())
        dicts.append({v: i for i, v in enumerate(sorted(uniq))})
    return dicts


def remap_cats(x_cat: np.ndarray, dicts: List[Dict[int, int]]) -> np.ndarray:
    out = np.empty_like(x_cat, dtype=np.int32)
    for col in range(NUM_CAT):
        d = dicts[col]
        keys = np.fromiter(d.keys(), dtype=np.int64, count=len(d))
        vals = np.fromiter(d.values(), dtype=np.int32, count=len(d))
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        pos = np.searchsorted(keys, x_cat[:, col])
        out[:, col] = vals[pos]
    return out


@dataclass
class CriteoArtifacts:
    day_files: List[str]  # processed per-day npz paths
    counts_file: str  # npz with per-table row counts
    counts: np.ndarray


def preprocess_raw(
    raw_files: Sequence[str],
    out_dir: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    randomize: str = "total",
    seed: int = 123,
) -> CriteoArtifacts:
    """Full offline preprocessing (getCriteoAdData equivalent,
    data_utils.py:879-1220): parse days, build dicts, remap to contiguous ids,
    shuffle (within-day for 'day', cross-day for 'total'), write artifacts."""
    os.makedirs(out_dir, exist_ok=True)
    parsed = [
        parse_raw_day(p, max_ind_range, sub_sample_rate, seed + i)
        for i, p in enumerate(raw_files)
    ]
    dicts = build_dicts([d["X_cat"] for d in parsed])
    counts = np.asarray([len(d) for d in dicts], dtype=np.int64)
    counts_file = os.path.join(out_dir, "day_fea_count.npz")
    np.savez_compressed(counts_file, counts=counts)

    rng = np.random.RandomState(seed)
    day_files = []
    # 'total' shuffle: permute all rows across days, keeping per-day row counts
    # (the memory-map bucket shuffle of data_utils.py:555-726 produces the same
    # distributional result; we do it directly since days fit host RAM here)
    if randomize == "total" and len(parsed) > 1:
        all_y = np.concatenate([d["y"] for d in parsed])
        all_int = np.concatenate([d["X_int"] for d in parsed])
        all_cat = np.concatenate([d["X_cat"] for d in parsed])
        # do NOT shuffle the last day (it is the val/test day in MLPerf runs,
        # concatCriteoAdData shuffles train days only)
        n_last = parsed[-1]["y"].shape[0]
        n_train = all_y.shape[0] - n_last
        perm = rng.permutation(n_train)
        all_y[:n_train] = all_y[:n_train][perm]
        all_int[:n_train] = all_int[:n_train][perm]
        all_cat[:n_train] = all_cat[:n_train][perm]
        offs = np.cumsum([0] + [d["y"].shape[0] for d in parsed])
        parsed = [
            {
                "y": all_y[offs[i] : offs[i + 1]],
                "X_int": all_int[offs[i] : offs[i + 1]],
                "X_cat": all_cat[offs[i] : offs[i + 1]],
            }
            for i in range(len(raw_files))
        ]
    for i, d in enumerate(parsed):
        if randomize == "day" and i < len(parsed) - 1:
            perm = rng.permutation(d["y"].shape[0])
            d = {k: v[perm] for k, v in d.items()}
        x_cat = remap_cats(d["X_cat"], dicts)
        p = os.path.join(out_dir, f"day_{i}_processed.npz")
        np.savez_compressed(
            p, y=d["y"].astype(np.int32), X_int=d["X_int"], X_cat=x_cat
        )
        day_files.append(p)
    return CriteoArtifacts(day_files=day_files, counts_file=counts_file, counts=counts)


# ------------------------------------------------------------------ bin files


def numpy_to_binary(
    input_files: Sequence[str], output_file_path: str, split: str = "train"
) -> None:
    """Processed day npz -> packed int32 .bin (data_loader_terabyte.py:251-290):
    train = all files concatenated; the last day is halved into test (first
    half) and val (second half)."""
    with open(output_file_path, "wb") as out:
        if split == "train":
            for p in input_files:
                with np.load(p) as z:
                    rec = np.concatenate(
                        [z["y"].reshape(-1, 1), z["X_int"], z["X_cat"]], axis=1
                    ).astype(np.int32)
                out.write(rec.tobytes())
        else:
            assert len(input_files) == 1
            with np.load(input_files[0]) as z:
                rec = np.concatenate(
                    [z["y"].reshape(-1, 1), z["X_int"], z["X_cat"]], axis=1
                ).astype(np.int32)
            mid = int(np.ceil(rec.shape[0] / 2.0))
            part = rec[:mid] if split == "test" else rec[mid:]
            out.write(part.tobytes())


class CriteoBinFile:
    """Batch-indexable reader of the packed .bin format
    (CriteoBinDataset equivalent, data_loader_terabyte.py:197-248): one
    seek+read+frombuffer per batch; dense -> log1p float; one-hot categorical
    (H=1) in the padded device layout."""

    def __init__(
        self,
        data_file: str,
        counts_file: str,
        batch_size: int,
        max_ind_range: int = -1,
        drop_last: bool = False,
        pad_last: bool = True,
        rank: int = 0,
        world_size: int = 1,
        shuffle_batches: bool = False,  # --mlperf-bin-shuffle: RandomSampler
        seed: int = 0,  # over batch ids (dlrm_data_pytorch.py:450)
        shuffle_samples: bool = False,  # v2 --shuffle_training_set: one
        # sample-level permutation of the whole set at load (loads the bin
        # into RAM, like the reference's in-memory datapipe,
        # multi_hot_criteo.py:36-37)
    ):
        self.batch_size = batch_size
        self.max_ind_range = max_ind_range
        self.bytes_per_entry = 4 * TOT_FEA * batch_size
        total = os.path.getsize(data_file) // (4 * TOT_FEA)
        self.num_samples = total
        nb = total / batch_size
        self.num_batches = int(nb) if drop_last else math.ceil(nb)
        self.pad_last = pad_last
        self.file = open(data_file, "rb")
        with np.load(counts_file) as z:
            self.counts = z["counts"]
        if world_size > 1:
            raise NotImplementedError(
                "a rank-strided read (world_size > 1) belongs to multi-GPU "
                "training, which is not ported yet (ROADMAP queue A item 11)"
            )
        self.rank = rank
        self.world_size = world_size
        self.shuffle_batches = shuffle_batches
        self._seed = seed
        self._epoch = 0
        self._data = None
        if shuffle_samples:
            self.file.seek(0)
            arr = np.frombuffer(
                self.file.read(), dtype=np.int32
            ).reshape(-1, TOT_FEA)
            rng = np.random.default_rng(seed)
            self._data = arr[rng.permutation(arr.shape[0])]

    def __len__(self) -> int:
        # round-robin batch -> rank assignment (multi_hot_criteo.py:262)
        return len(range(self.rank, self.num_batches, self.world_size))

    def set_epoch(self, epoch: int) -> None:
        """Align the shuffle permutation with the trainer's epoch counter
        (torch DistributedSampler.set_epoch role). Without this, resume
        fast-forward would replay seed+0's permutation while the pre-crash
        run trained seed+epoch's — skipping the WRONG batches."""
        self._epoch = int(epoch)

    def batch_indices(self):
        ids = range(self.rank, self.num_batches, self.world_size)
        if not self.shuffle_batches:
            return ids
        # fresh permutation per epoch, like torch's RandomSampler re-drawing
        # each iterator (dlrm_data_pytorch.py:450)
        rng = np.random.default_rng(self._seed + self._epoch)
        self._epoch += 1
        return list(rng.permutation(np.asarray(ids)))

    def read_batch(self, idx: int) -> HostBatch:
        if self._data is not None:  # sample-shuffled in-memory copy
            arr = self._data[
                idx * self.batch_size : (idx + 1) * self.batch_size
            ]
        else:
            self.file.seek(idx * self.bytes_per_entry, 0)
            raw = self.file.read(self.bytes_per_entry)
            arr = np.frombuffer(raw, dtype=np.int32).reshape(-1, TOT_FEA)
        y = arr[:, 0].astype(np.float32).reshape(-1, 1)
        x_int = arr[:, 1 : 1 + NUM_DENSE]
        x_cat = arr[:, 1 + NUM_DENSE :]
        if self.max_ind_range > 0:
            x_cat = x_cat % self.max_ind_range
        dense = np.log1p(np.maximum(x_int, 0).astype(np.float32))
        idx_arr = np.ascontiguousarray(
            x_cat.T[:, :, None].astype(np.int32)
        )  # [26, B, 1]
        n = arr.shape[0]
        wt = None
        if n < self.batch_size and self.pad_last:
            pad = self.batch_size - n
            dense = np.concatenate([dense, np.zeros((pad, NUM_DENSE), np.float32)])
            idx_arr = np.concatenate(
                [idx_arr, np.zeros((NUM_CAT, pad, 1), np.int32)], axis=1
            )
            wt = np.ones((NUM_CAT, self.batch_size, 1), np.float32)
            wt[:, n:, :] = 0.0
            y = np.concatenate([y, -np.ones((pad, 1), np.float32)])
        if wt is None:
            wt = np.ones((NUM_CAT, n, 1), np.float32)
        return HostBatch(dense=dense, idx=idx_arr, wt=wt, labels=y)

    def __iter__(self) -> Iterator[HostBatch]:
        for i in self.batch_indices():
            yield self.read_batch(i)

    def __getitem__(self, i: int) -> HostBatch:
        # positional access is always in file order (shuffle only affects
        # iteration order, like a torch sampler)
        return self.read_batch(
            range(self.rank, self.num_batches, self.world_size)[i]
        )

    def close(self):
        self.file.close()


def make_criteo_datasets(model_cfg, train_cfg, args):
    """CLI glue: build train/test loaders from --processed-data-file /
    --raw-data-file flags (make_criteo_data_and_loaders equivalent,
    dlrm_data_pytorch.py:414-567). --memory-map selects the out-of-core
    preprocessing + memmap day-file dataset (dlrm_data_pytorch.py:50-321);
    --dataset-multiprocessing parses days in parallel worker processes
    (data_utils.py:1104-1143)."""
    out_dir = os.path.dirname(args.processed_data_file) or "."
    counts_file = os.path.join(out_dir, "day_fea_count.npz")
    train_bin = os.path.join(out_dir, "train_data.bin")
    test_bin = os.path.join(out_dir, "test_data.bin")
    memory_map = getattr(args, "memory_map", False)
    n_workers = (
        max(2, os.cpu_count() or 2)
        if getattr(args, "dataset_multiprocessing", False)
        else 1
    )

    def _raw_files():
        if not args.raw_data_file:
            raise FileNotFoundError(
                f"processed data not found in {out_dir} and no "
                "--raw-data-file given"
            )
        days = 7 if args.data_set == "kaggle" else 24
        if args.data_set == "kaggle":
            return split_kaggle_train(args.raw_data_file, out_dir, days)
        return [f"{args.raw_data_file}_{d}" for d in range(days)]

    if (memory_map or n_workers > 1) and (
        memory_map or not os.path.exists(train_bin)
    ):
        # (--dataset-multiprocessing with bins already on disk skips
        # preprocessing entirely, same as the single-worker path)
        from dlrm_tpu_torch.data import criteo_stream

        day0 = os.path.join(out_dir, "day_0_processed.y.npy")
        if not os.path.exists(day0):
            sart = criteo_stream.preprocess_raw_streaming(
                _raw_files(), out_dir, args.max_ind_range,
                args.data_sub_sample_rate, args.data_randomize,
                args.numpy_rand_seed, num_workers=n_workers,
            )
        else:
            days = 7 if args.data_set == "kaggle" else 24
            with np.load(counts_file) as z:
                counts = z["counts"]
            sart = criteo_stream.CriteoStreamArtifacts(
                day_prefixes=[
                    os.path.join(out_dir, f"day_{d}_processed")
                    for d in range(days)
                ],
                counts_file=counts_file,
                counts=counts,
            )
        if memory_map:
            train = criteo_stream.CriteoDayDataset(
                sart.day_prefixes, counts_file,
                train_cfg.mini_batch_size, "train", args.max_ind_range,
            )
            test = criteo_stream.CriteoDayDataset(
                sart.day_prefixes, counts_file,
                train_cfg.eval_batch_size, "test", args.max_ind_range,
            )
            return train, test
        if not os.path.exists(train_bin):
            criteo_stream.days_to_binary_streaming(
                sart.day_prefixes[:-1] or sart.day_prefixes, train_bin,
                "train",
            )
            criteo_stream.days_to_binary_streaming(
                [sart.day_prefixes[-1]], test_bin, "test"
            )
    elif not os.path.exists(train_bin):
        art = preprocess_raw(
            _raw_files(), out_dir, args.max_ind_range,
            args.data_sub_sample_rate, args.data_randomize,
            args.numpy_rand_seed,
        )
        numpy_to_binary(art.day_files[:-1] or art.day_files, train_bin, "train")
        numpy_to_binary([art.day_files[-1]], test_bin, "test")
    train = CriteoBinFile(
        train_bin, counts_file, train_cfg.mini_batch_size, args.max_ind_range,
        shuffle_batches=getattr(args, "mlperf_bin_shuffle", False),
        seed=train_cfg.numpy_rand_seed,
    )
    test = CriteoBinFile(
        test_bin, counts_file, train_cfg.eval_batch_size, args.max_ind_range
    )
    return train, test
