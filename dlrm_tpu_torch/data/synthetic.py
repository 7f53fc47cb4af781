"""Trace-driven synthetic sparse-input generation, the stack-distance model
(the port's copy of dlrm_tpu/data/synthetic.py; numpy only).

Capability parity with the reference's synthetic path (dlrm_data_pytorch.py:
963-1284): a memory-access trace is profiled into a stack-distance (LRU reuse
distance) distribution; synthetic index streams with the same temporal locality
are then generated by sampling stack distances and replaying them against an
LRU stack. Artifacts use the same 3-line dist-file format
(unique accesses / stack-distance values / cumulative probabilities,
dlrm_data_pytorch.py:1188-1216), so reference dist files load directly.
"""

from __future__ import annotations

import collections
from typing import List, Sequence, Tuple

import numpy as np

from dlrm_tpu_torch.data.random_data import HostBatch


# ----------------------------------------------------------------- profiling


def trace_profile(trace: Sequence[int]) -> Tuple[List[int], List[int]]:
    """Trace -> (stack_distances per access, first-touch line order).

    LRU reuse distance: 0 marks a cold (first) access; otherwise the distance
    is the number of distinct lines touched since the previous access to the
    same line, counted from the top of an LRU stack
    (trace_profile, dlrm_data_pytorch.py:1112-1156).
    """
    stack: List[int] = []
    sds: List[int] = []
    first_touch: List[int] = []
    pos = {}
    for x in trace:
        r = int(x)
        if r in pos:
            i = stack.index(r)
            sds.append(len(stack) - i)
            del stack[i]
            stack.append(r)
        else:
            sds.append(0)
            first_touch.append(r)
            stack.append(r)
            pos[r] = True
    return sds, first_touch


def distribution_from_trace(
    trace: Sequence[int],
) -> Tuple[List[int], List[int], List[float]]:
    """(line_accesses, list_sd, cumm_sd) — the dist-file triple."""
    sds, lines = trace_profile(trace)
    counts = sorted(collections.Counter(sds).items())
    total = float(len(sds))
    list_sd = [k for k, _ in counts]
    cumm = []
    acc = 0.0
    for _, c in counts:
        acc += c / total
        cumm.append(acc)
    return lines, list_sd, cumm


# -------------------------------------------------------------- dist file io


def read_dist_file(path: str) -> Tuple[List[int], List[int], List[float]]:
    with open(path) as f:
        lines = f.read().splitlines()
    unique_accesses = [int(el) for el in lines[0].split(", ")]
    list_sd = [int(el) for el in lines[1].split(", ")]
    cumm_sd = [float(el) for el in lines[2].split(", ")]
    return unique_accesses, list_sd, cumm_sd


def write_dist_file(
    path: str, line_accesses: Sequence[int], list_sd: Sequence[int],
    cumm_sd: Sequence[float],
) -> None:
    with open(path, "w") as f:
        f.write(", ".join(str(int(x)) for x in line_accesses) + "\n")
        f.write(", ".join(str(int(x)) for x in list_sd) + "\n")
        f.write(", ".join(str(float(x)) for x in cumm_sd) + "\n")


# -------------------------------------------------------------- generation


def sample_stack_distance(
    list_sd: Sequence[int], cumm_sd: Sequence[float], max_sd: int, seen: int,
    enable_padding: bool = False,
) -> int:
    """Inverse-CDF sample of a stack distance, restricted to distances already
    reachable (only `seen` distinct lines exist so far) — semantics of
    generate_stack_distance (dlrm_data_pytorch.py:1039-1056)."""
    u = float(np.random.rand(1)[0])
    if seen < max_sd:
        import bisect

        j = bisect.bisect(list(list_sd), seen) - 1
        u *= cumm_sd[j]
    elif enable_padding:
        f0 = cumm_sd[0]
        u = (1.0 - f0) * u + f0
    for j, f in enumerate(cumm_sd):
        if u <= f:
            return list_sd[j]
    return list_sd[-1]


def lru_trace(
    line_accesses: List[int],
    list_sd: Sequence[int],
    cumm_sd: Sequence[float],
    out_len: int,
    enable_padding: bool = False,
) -> List[int]:
    """Generate a synthetic access stream by LRU replay
    (trace_generate_lru, dlrm_data_pytorch.py:1059-1085). Mutates
    line_accesses like the reference (rotating cold lines to the back)."""
    max_sd = list_sd[-1]
    l = len(line_accesses)
    seen = 0
    out: List[int] = []
    for _ in range(out_len):
        sd = sample_stack_distance(list_sd, cumm_sd, max_sd, seen, enable_padding)
        if sd == 0:  # cold access: next unseen line
            ref = line_accesses.pop(0)
            line_accesses.append(ref)
            seen += 1
        else:  # reuse at LRU depth sd
            ref = line_accesses[l - sd]
            del line_accesses[l - sd]
            line_accesses.append(ref)
        out.append(int(ref))
    return out


_DIST_CACHE: dict = {}


def _read_dist_cached(path: str):
    """Parse each dist file once per (path, mtime) instead of on every
    batch (26 open+parse passes per __getitem__ stalled the prefetch
    producer). lru_trace mutates the line-access list per batch exactly
    like the reference — and the reference re-reads the file each batch,
    discarding those mutations — so a FRESH COPY of the lines is handed
    out while the immutable stack-distance tables are shared."""
    import os

    mtime = os.path.getmtime(path)
    hit = _DIST_CACHE.get(path)
    if hit is None or hit[0] != mtime:
        # one entry per path, replaced on rewrite — a long-lived process
        # that regenerates dist files doesn't pin every stale parse
        _DIST_CACHE[path] = hit = (mtime, read_dist_file(path))
    lines, list_sd, cumm_sd = hit[1]
    return list(lines), list_sd, cumm_sd


def generate_synthetic_batch(
    num_dense: int,
    table_sizes: Sequence[int],
    n: int,
    hot_size: int,
    trace_file_template: str,
    num_indices_per_lookup_fixed: bool = False,
    enable_padding: bool = False,
    round_targets: bool = False,
    pad_batch_to=None,
) -> HostBatch:
    """One synthetic batch: dense ~ U(0,1); per-table bags drawn from that
    table's dist file (path template with 'j' placeholder,
    generate_synthetic_input_batch, dlrm_data_pytorch.py:963-1035)."""
    dense = np.random.rand(n, num_dense).astype(np.float32)
    num_t = len(table_sizes)
    idx = np.zeros((num_t, n, hot_size), dtype=np.int32)
    wt = np.zeros((num_t, n, hot_size), dtype=np.float32)
    for k, size in enumerate(table_sizes):
        lines, list_sd, cumm_sd = _read_dist_cached(
            trace_file_template.replace("j", str(k))
        )
        for b in range(n):
            if num_indices_per_lookup_fixed:
                gs = hot_size
            else:
                r = np.random.random(1)
                gs = int(max(1, np.round(r * min(size, hot_size))[0]))
            raw = lru_trace(lines, list_sd, cumm_sd, gs, enable_padding)
            group = np.unique(raw).astype(np.int64)
            if group.min() < 0 or group.max() >= size:
                group = np.mod(group, size)
                group = np.unique(group)
            ln = min(len(group), hot_size)
            idx[k, b, :ln] = group[:ln]
            wt[k, b, :ln] = 1.0
    # targets come from the same generator as the random path
    # (generate_random_output_batch, dlrm_data_pytorch.py:838-845)
    labels = np.random.rand(n, 1).astype(np.float32)
    if round_targets:
        labels = np.round(labels).astype(np.float32)
    if pad_batch_to is not None and n < pad_batch_to:
        pad = pad_batch_to - n
        dense = np.concatenate(
            [dense, np.zeros((pad, num_dense), np.float32)]
        )
        idx = np.concatenate(
            [idx, np.zeros((num_t, pad, hot_size), np.int32)], axis=1
        )
        wt = np.concatenate(
            [wt, np.zeros((num_t, pad, hot_size), np.float32)], axis=1
        )
        labels = np.concatenate([labels, -np.ones((pad, 1), np.float32)])
    return HostBatch(dense=dense, idx=idx, wt=wt, labels=labels)


def synthesize_dist_fixture(
    path: str, table_size: int, trace_len: int = 200, seed: int = 0
) -> None:
    """Create a dist file by profiling a zipf-ish random trace (test fixture
    generator; the reference ships static input/dist_emb_*.log files)."""
    rng = np.random.RandomState(seed)
    # zipf-like popularity over the table rows
    ranks = np.arange(1, table_size + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    trace = rng.choice(table_size, size=trace_len, p=p)
    lines, list_sd, cumm_sd = distribution_from_trace(trace.tolist())
    write_dist_file(path, lines, list_sd, cumm_sd)


def main(argv=None):
    """Standalone trace-synthesis CLI (dlrm_data_pytorch.py:1219-1284):
    profile a trace -> dist file -> regenerate a synthetic trace."""
    import argparse

    p = argparse.ArgumentParser(description="Generate Synthetic Distributions")
    p.add_argument("--trace-file", type=str, default="./input/trace.log")
    p.add_argument("--trace-enable-padding", action="store_true",
                   default=False)
    p.add_argument("--dist-file", type=str, default="./input/dist.log")
    p.add_argument("--synthetic-file", type=str, default="./input/trace_synthetic.log")
    p.add_argument("--numpy-rand-seed", type=int, default=123)
    args = p.parse_args(argv)
    np.random.seed(args.numpy_rand_seed)
    with open(args.trace_file) as f:
        trace = [int(x) for x in f.readline().split(", ")]
    lines, list_sd, cumm_sd = distribution_from_trace(trace)
    write_dist_file(args.dist_file, lines, list_sd, cumm_sd)
    synth = lru_trace(lines, list_sd, cumm_sd, len(trace), args.trace_enable_padding)
    with open(args.synthetic_file, "w") as f:
        f.write(", ".join(str(x) for x in synth))
    return 0


if __name__ == "__main__":
    main()
