"""P1: per-row gather rate on the card, beside the library calls that do
the same or nearby work (the port of bench_scripts/scan_probe.py).

Lines, in the reference's order, each with its torch counterpart of the
reference's XLA op:
  CAL add 2.66GB (read+write)     t + 1.0 over the whole table (calibration)
  torch index_select random fp32  the library gather (XLA take)
  torch index_select random bf16  the same on a bf16 copy of the table
  torch gather+pool fp32          index_select, then the sum over 8 hits
  torch index_add_ sorted+unique  scatter-add into the table
  torch sort 425k                 sort_key_val's keys
  torch batched sort 26x16k       the per-table sort
  row_gather random / sorted      the hand-written gather (Pallas gather)
then a check of row_gather against index_select.

    python -m dlrm_tpu_torch.probes.scan_probe
"""

from __future__ import annotations

import numpy as np
import torch

from dlrm_tpu_torch.ops.probe_kernels import row_gather
from dlrm_tpu_torch.probes.common import probe_device, record, time_ms

ROWS_TOTAL = 26 * 200_000
D = 128
N = 26 * 2048 * 8  # 425,984 rows per gather (a multiple of 26 * 8)
ITERS = 10


def inputs(dev):
    """The table (normal, seed 0), its bf16 copy, the even random row
    indices (as the reference draws them), the same sorted, N unique sorted
    rows and the rows' scatter-add values."""
    rows_total, d, n = ROWS_TOTAL, D, N
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn((rows_total, d), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    idx0 = torch.from_numpy(
        (rng.integers(0, rows_total // 2 - 1, size=n) * 2).astype(np.int32)
    ).to(dev)
    uniq_sorted = torch.from_numpy(
        np.sort(rng.permutation(rows_total)[:n]).astype(np.int32)).to(dev)
    g = torch.randn((n, d), generator=gen, device=dev) * 1e-6
    return (table, table.to(torch.bfloat16), idx0, torch.sort(idx0).values,
            uniq_sorted, g)


def main(device="cuda") -> dict:
    """Run P1 and return {line: {"ms", "ns_per_row", "gbps", "nbytes"}}."""
    dev = probe_device(device)
    rows_total, d, n = ROWS_TOTAL, D, N
    table, table_bf, idx0, idx_sorted, uniq_sorted, g = inputs(dev)
    tb = rows_total * d * 4
    rb = n * d * 4  # one pass over the gathered rows
    res = {}

    def line(name, fn, **kw):
        res[name] = record(name, time_ms(fn, dev, ITERS), dev, **kw)

    buf = torch.empty_like(table)
    line(f"CAL add {tb / 1e9:.2f}GB (read+write)",
         lambda: torch.add(table, 1.0, out=buf), nbytes=2 * tb)
    del buf
    line("torch index_select random fp32",
         lambda: torch.index_select(table, 0, idx0), per_row=n,
         nbytes=2 * rb + n * 4)
    line("torch index_select random bf16",
         lambda: torch.index_select(table_bf, 0, idx0), per_row=n,
         nbytes=rb + n * 4)
    line("torch gather+pool fp32",
         lambda: torch.index_select(table, 0, idx0).view(n // 8, 8, d).sum(1),
         per_row=n)
    scattered = table.clone()
    line("torch index_add_ sorted+unique",
         lambda: scattered.index_add_(0, uniq_sorted, g), per_row=n,
         nbytes=3 * rb + n * 4)
    del scattered
    line(f"torch sort {n // 1000}k", lambda: torch.sort(idx0))
    line(f"torch batched sort 26x{n // 26 // 1000}k",
         lambda: torch.sort(idx0.view(26, n // 26), dim=1))
    for name, idx in (("random", idx0), ("sorted", idx_sorted)):
        line(f"row_gather {name}", lambda idx=idx: row_gather(table, idx),
             per_row=n, nbytes=2 * rb + n * 4)
    ok = torch.equal(row_gather(table, idx0), torch.index_select(table, 0, idx0))
    print(f"row_gather {'correct' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError("row_gather differs from index_select")
    return res


if __name__ == "__main__":
    main()
