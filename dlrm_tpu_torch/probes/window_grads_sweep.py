"""K1 window_grads' design sweep on the card: the shipped kernel
(csrc/window_grads.cu) and variants of its depth, its register budget (the
blocks an SM its launch bounds allow) and its store hint
(probes/window_grads_sweep.cu), on chip_smoke.py phase
4's work: bench.py's 26 tables x 200,000 rows, d = 128, batch 16,384, the
ragged v2 hot sizes, unit weights, an fp32 dly as the [B, T, d] cotangent's
transposed view, mm_dtype bf16. Each variant is timed with G_u in fp32 and
in bf16, and on dly cast to bf16 first (the kernel's operand, the same
bits), beside the cast, gather_grads and one F.embedding_bag (one index a
bag, the weights as per_sample_weights) over a contiguous copy of dly. The
grids: a warp a tile, as the wrapper launches it, and a persistent one (the
blocks an SM holds x SMs, each warp walking tiles a grid apart). Every
configuration is checked once against
window_grads_plain, bit for bit; times are CUDA events around 20 calls
after one, two passes.

    python -m dlrm_tpu_torch.probes.window_grads_sweep
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
import torch.nn.functional as F

from dlrm_tpu_torch.buildlib import build_shared
from dlrm_tpu_torch.data.random_data import (
    V2_HOT_SIZES,
    ragged_multihot_batch,
)
from dlrm_tpu_torch.ops.stream_kernels import (
    _ENTRY_POINTS,
    _NVCC_FLAGS,
    _nvcc,
    gather_grads,
    window_grads,
    window_grads_grid,
    window_grads_plain,
)
from dlrm_tpu_torch.ops.stream_plan import SENTINEL_ROW, make_stream_plan
from dlrm_tpu_torch.probes.common import probe_device, time_ms

ITERS = 20
TABLES = (200_000,) * 26
D = 128
BATCH = 16_384
# (depth, blocks an SM, streaming store): window_grads_sweep.cu kVariants;
# the shipped kernel is (8, 3, True)
VARIANTS = ((1, 4, True), (2, 4, True), (4, 4, True), (4, 4, False),
            (8, 3, True), (8, 3, False), (8, 4, True), (8, 2, True),
            (16, 2, True), (4, 8, True), (2, 8, True), (1, 8, True))


def main_path_work(dev):
    """Phase 4's U-layout work on dev (unit weights, the full item list)
    and its random fp32 dly as the [T, B, d] view of [B, T, d]."""
    plan = make_stream_plan(TABLES, D, BATCH, V2_HOT_SIZES, block_rows=2048)
    hb = ragged_multihot_batch(np.random.default_rng(0), 13, TABLES,
                               V2_HOT_SIZES, BATCH)
    hb = hb.with_stream_work(plan, unit_weights=True)
    sw = hb.to_device(dev, flat_hots=plan.hot).stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    dly = torch.randn((BATCH, len(TABLES), D), generator=gen,
                      device=dev).transpose(0, 1)
    return plan, sw, dly, (sw.rows_u != SENTINEL_ROW).float()


def main(device: str = "cuda") -> dict:
    """Build the sweep, check every variant, time it; prints one line a
    variant and grid and returns {name: {form: [ms of each pass]}}."""
    dev = probe_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the K1 sweep times the card: it needs CUDA")
    lib = ctypes.CDLL(build_shared(
        "window_grads_sweep", ["probes/window_grads_sweep.cu"],
        [_nvcc(), *_NVCC_FLAGS],
        deps=["csrc/window_grads.cu", "csrc/u_layout.cuh"]))
    lib.k1_sweep.argtypes = [ctypes.c_int, *_ENTRY_POINTS["window_grads"][2]]
    lib.k1_sweep.restype = ctypes.c_int
    if lib.k1_sweep_count() != len(VARIANTS):
        raise RuntimeError("VARIANTS does not follow window_grads_sweep.cu")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan, sw, dly32, wts = main_path_work(dev)
    u = plan.u_total
    dly16 = dly32.to(torch.bfloat16)  # keeps the transposed strides
    mm = torch.bfloat16

    def runner(v, grid, dly, out_dtype):
        g = torch.empty((u, D), dtype=out_dtype, device=dev)
        args = (v, int(dly.dtype == torch.bfloat16), dly.data_ptr(),
                dly.stride(0), dly.stride(1), sw.vals_u.data_ptr(),
                wts.data_ptr(), sw.w2t.data_ptr(), g.data_ptr(), u, D, 1,
                int(out_dtype == torch.bfloat16), grid)

        def fn():
            err = lib.k1_sweep(*args,
                               torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"k1_sweep {v}: CUDA error {err}")
            return g
        return fn

    configs = {}
    for v, (depth, minb, cs) in enumerate(VARIANTS):
        name = f"depth {depth} x{minb} {'cs' if cs else 'plain'}"
        resident = lib.k1_sweep_resident(v)
        print(f"{name}: {resident} blocks an SM", flush=True)
        configs[name] = (v, window_grads_grid(u)[1])
        configs[f"{name} persistent"] = (v, sms * resident)
    want = {o: window_grads_plain(dly32, sw.vals_u, wts, sw.w2t, mm_dtype=mm,
                                  out_dtype=o)
            for o in (torch.float32, torch.bfloat16)}
    for name, (v, grid) in configs.items():
        for dly in (dly32, dly16):
            for o, w in want.items():
                got = runner(v, grid, dly, o)()
                torch.cuda.synchronize()
                if not torch.equal(got, w):
                    raise AssertionError(f"sweep {name}: differs from the "
                                         f"plain version (dly {dly.dtype}, "
                                         f"G_u {o})")
    del want
    print(f"window_grads sweep: {len(configs)} configurations "
          f"bit-identical to the plain version ({u} slots, {sms} SMs)",
          flush=True)

    flat = dly32.transpose(0, 1).contiguous().reshape(-1, D)  # [T * B, d]
    idx = (sw.w2t.long()[:, None, None] * BATCH
           + sw.vals_u.long()).reshape(-1)
    offsets = torch.arange(u, device=dev)
    wflat = wts.reshape(-1)
    yard = {
        "shipped (window_grads)": lambda: window_grads(
            dly32, sw.vals_u, wts, sw.w2t, mm_dtype=mm),
        "shipped, G_u bf16": lambda: window_grads(
            dly32, sw.vals_u, wts, sw.w2t, mm_dtype=mm,
            out_dtype=torch.bfloat16),
        "cast dly to bf16": lambda: dly32.to(torch.bfloat16),
        "gather_grads": lambda: gather_grads(dly32, sw.vals_u, wts, sw.w2t),
        "F.embedding_bag fp32": lambda: F.embedding_bag(
            idx, flat, offsets, mode="sum", per_sample_weights=wflat),
    }
    res = {}
    for rnd in range(2):
        for name, fn in yard.items():
            ms = time_ms(fn, dev, ITERS)
            res.setdefault(name, {}).setdefault("ms", []).append(ms)
            print(f"pass {rnd} {name:34s} {ms:8.4f} ms", flush=True)
        for name, (v, grid) in configs.items():
            times = {
                "G fp32": time_ms(runner(v, grid, dly32, torch.float32), dev,
                                  ITERS),
                "G bf16": time_ms(runner(v, grid, dly32, torch.bfloat16),
                                  dev, ITERS),
                "bf16 dly, G fp32": time_ms(
                    runner(v, grid, dly16, torch.float32), dev, ITERS),
                "bf16 dly, G bf16": time_ms(
                    runner(v, grid, dly16, torch.bfloat16), dev, ITERS),
            }
            for k, ms in times.items():
                res.setdefault(name, {}).setdefault(k, []).append(ms)
            print(f"pass {rnd} {name:34s} grid {grid:6d} " + "  ".join(
                f"{k} {ms:7.4f}" for k, ms in times.items()) + " ms",
                flush=True)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
