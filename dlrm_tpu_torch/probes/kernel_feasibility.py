"""P6: the building blocks of K1-K4, each run on the card and checked, OK or
FAIL (the port of bench_scripts/kernel_feasibility.py, which asked whether
Mosaic could lower each one):
  T1  take of rows of a [256, 128] block by an int32 vector    row_gather
  T2  a product with two contracting dims, einsum slr,sld->rd  t2_contract
  T3  an int32 reshape (8, 128) -> (1024,) -> (8, 128), + 1    t3_reshape_add
  T4  one-hot accumulate: out[r] = sum of g[c], idx[c] == r    t4_onehot_accumulate
  T5  an in-place streamed block update at 2.66 GB, with its rate
                                                               block_stream
  T6  a revolving accumulation, out block k = x blocks 3k..3k+2
                                                               t6_revolve_accumulate
Each check uses the reference's own expression and tolerance.

    python -m dlrm_tpu_torch.probes.kernel_feasibility
"""

from __future__ import annotations

import numpy as np
import torch

from dlrm_tpu_torch.ops.probe_kernels import (
    block_stream,
    row_gather,
    t2_contract,
    t3_reshape_add,
    t4_onehot_accumulate,
    t6_revolve_accumulate,
)
from dlrm_tpu_torch.probes.common import probe_device, record, time_ms


def _randn(shape, seed, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def t1(dev):
    b, d, cap = 256, 128, 128
    dly = _randn((b, d), 0, dev)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, b, (8, cap)).astype(np.int32)).to(dev)
    out = row_gather(dly, idx[0])
    assert torch.equal(out, dly[idx[0].long()]), "T1 mismatch"


def t2(dev):
    a = _randn((8, 128, 256), 0, dev)
    b = _randn((8, 128, 128), 1, dev)
    out = t2_contract(a, b)
    ref = torch.einsum("slr,sld->rd", a, b)
    assert torch.allclose(out, ref, atol=1e-3), "T2 mism"


def t3(dev):
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    assert torch.equal(t3_reshape_add(x), x + 1), "T3 mismatch"


def t4(dev):
    cap, rows, d = 256, 512, 128
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, rows, (cap, 1)).astype(np.int32)).to(dev)
    g = _randn((cap, d), 0, dev)
    out = t4_onehot_accumulate(idx, g, rows)
    oh = torch.nn.functional.one_hot(idx[:, 0].long(), rows).float()
    assert torch.allclose(out, oh.T @ g, atol=1e-4), "T4 mism"


T5_ROWS = 26 * 200_000 // 2048 * 2048


def t5(dev):
    """The aliased stream at full scale (2048-row blocks); returns its
    line."""
    t = _randn((T5_ROWS, 128), 0, dev)
    nb = T5_ROWS * 128 * 4
    ms = time_ms(lambda: block_stream(t, scale=1.000001, shift=0.5,
                                      block_rows=2048), dev, 10)
    return record(f"  T5 stream {nb * 2 / 1e9:.2f} GB r+w", ms, dev,
                  nbytes=2 * nb, width=26)


def t6(dev):
    nb, br, d, steps = 4, 256, 128, 3
    x = _randn((nb * steps * br, d), 0, dev)
    out = t6_revolve_accumulate(x, steps, br)
    ref = x.reshape(nb, steps, br, d).sum(dim=1).reshape(nb * br, d)
    assert torch.allclose(out, ref, atol=1e-5), "T6 mism"


def run(name, fn, dev) -> str:
    """Run one check and print OK or FAIL with the first line of its
    error, as the reference does; returns the status."""
    try:
        fn(dev)
        status = "OK"
    except Exception as e:
        status = f"FAIL — {str(e).splitlines()[0][:200]}"
    print(f"{name}: {status}", flush=True)
    return status


def main(device="cuda") -> dict:
    """Run T1-T6; returns {name: "OK" | "FAIL — ..."}."""
    dev = probe_device(device)
    tests = [("T1 vmem take", t1), ("T2 dot 2-contract", t2),
             ("T3 int reshape", t3), ("T4 onehot matmul", t4),
             ("T5 aliased stream", t5),
             ("T6 revolving accum", t6)]
    return {name: run(name, fn, dev) for name, fn in tests}


if __name__ == "__main__":
    main()
