"""P5: per-row gather and scatter-add rates on the card (the port of
bench_scripts/pallas_probe.py, whose Pallas kernels issued one row DMA per
index): row_gather and row_scatter_add_, each beside its library call
(torch.index_select, Tensor.index_add_) and checked against it.

    python -m dlrm_tpu_torch.probes.pallas_probe
"""

from __future__ import annotations

import numpy as np
import torch

from dlrm_tpu_torch.ops.probe_kernels import row_gather, row_scatter_add_
from dlrm_tpu_torch.probes.common import probe_device, record, time_ms

ROWS_TOTAL = 26 * 200_000
D = 128
N = 26 * 2048 * 8  # 425,984
ITERS = 20


def inputs(dev):
    """The table (normal, seed 0), N random row indices, N unique ones and
    the scatter's values."""
    rows_total, d, n = ROWS_TOTAL, D, N
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn((rows_total, d), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(
        rng.integers(0, rows_total, size=n).astype(np.int32)).to(dev)
    idx_unique = torch.from_numpy(
        rng.permutation(rows_total)[:n].astype(np.int32)).to(dev)
    delta = torch.randn((n, d), generator=gen, device=dev)
    return table, idx, idx_unique, delta


def main(device="cuda") -> dict:
    """Run P5 and return {line: {"ms", "ns_per_row", "gbps", "nbytes"}}."""
    dev = probe_device(device)
    d, n = D, N
    table, idx, idx_unique, delta = inputs(dev)
    rb = n * d * 4
    res = {}

    def line(name, fn, nbytes):
        res[name] = record(name, time_ms(fn, dev, ITERS), dev, per_row=n,
                           nbytes=nbytes, width=44)

    ref = torch.index_select(table, 0, idx)
    line("torch index_select", lambda: torch.index_select(table, 0, idx),
         2 * rb + n * 4)
    line("row_gather", lambda: row_gather(table, idx), 2 * rb + n * 4)
    if not torch.equal(row_gather(table, idx), ref):
        raise AssertionError("gather mismatch")
    del ref

    expect = table.clone().index_add_(0, idx_unique, delta)
    got = row_scatter_add_(table.clone(), idx_unique, delta)
    if not torch.equal(got, expect):
        raise AssertionError("scatter mismatch")
    del got, expect
    t = table.clone()
    line("torch index_add_ (unique)", lambda: t.index_add_(0, idx_unique, delta),
         3 * rb + n * 4)
    line("row_scatter_add", lambda: row_scatter_add_(t, idx_unique, delta),
         3 * rb + n * 4)
    print("row_gather and row_scatter_add correct", flush=True)
    return res


if __name__ == "__main__":
    main()
