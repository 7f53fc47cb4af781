"""On-card smoke of the PyTorch/H100 port (dlrm_tpu_torch): builds its
kernels, holds each against its plain version, and drives the port's two
paths of the single-device DLRM-v2 streamed train step at the full width of
bench.py's configuration: the gather path (K2) and the streamed-forward,
one-hot-grads path (K3, K4, K1 and K2).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and "ok" is printed only when all pass):
  1. card and build: the card's name and power limit; K1-K4 (one nvcc
     sm_90a build per source) and the native stream-work builder (g++),
     all built in parallel from the sources in the checkout; TF32 off.
  2. K2 against its plain version on a mid-size ragged plan: sgd,
     rwsadagrad, adagrad; fp32 tables, bf16 tables with stochastic rounding
     off and on (the same hash on both sides); the full and the touched-only
     item list. Limits: fp32 rtol 1e-5 / atol 1e-6, bf16 at most 1 ulp apart
     -- the kernel and the plain version differ only in summation order.
  2b. K1, K3 and K4 against their plain versions on the same plan and the
     full item list: K1 with mm_dtype fp32 / bf16 and unit / random
     weights, K3 with fp32 / bf16 tables and mm_dtype, K4 as K1; K3 also on
     a plan whose first block's 128-slot run makes its 256-slot item
     overrun into the next block's run. Limits: K1 and K3 bit-identical
     (the same products and copies), K4 rtol 1e-5 / atol 1e-6 (fp32 atomic
     adds in a run-dependent order).
  3. the gather path at full width: 26 tables x 200,000 rows, d = 128, the
     ragged v2 hot sizes (214 hits/sample), batch 16,384, MLPs 13-512-256-128
     and 479-1024-1024-512-256-1, dot interaction, BCE, bf16 compute, bf16
     tables with stochastic rounding, rwsadagrad, block_rows 2048, flat
     layout, unit weights, touched-only items, fwd_impl="gather" and
     grad_impl="gather". A fresh host batch per step (ragged_multihot_batch,
     the native builder, pinned H2D); 3 warm-up and 20 timed steps; K2's
     own time, its plain version's and its bound at this shape; one
     full-width K2 step against its plain version; the eval step on one
     batch.
  4. the kernel path at full width: the same model and batch with
     fwd_impl="stream" (K3 then K4) and grad_impl="onehot" (K1) on the full
     item list (so K2 runs on it too); 3 warm-up and 20 timed steps, each
     kernel launched once per step; the profile; one full-width K1, K3 and
     K4 call against its plain version; each kernel's time, its plain
     version's and its bound from this run's data, and the library
     yardsticks (K4 against one index_add_, K3+K4 against one
     F.embedding_bag, gather_grads beside K1).
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.random_data import HostBatch, ragged_multihot_batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.native import stream_native
from dlrm_tpu_torch.ops.stream_kernels import (
    LAUNCHES,
    gather_grads,
    kernel_library,
    stream_rows,
    stream_rows_plain,
    stream_update,
    stream_update_plain,
    window_grads,
    window_grads_plain,
    window_pool,
    window_pool_plain,
)
from dlrm_tpu_torch.ops.stream_plan import SENTINEL_ROW, make_stream_plan
from dlrm_tpu_torch.train.stream_step import (
    cast_emb,
    init_stream_opt_state,
    make_stream_eval_step,
    make_stream_train_step,
    pad_params,
    plan_for_model,
)

KERNELS = ("window_grads", "stream_update", "stream_rows", "window_pool")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM published fp32 rate outside the tensor cores
V2_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                12, 100, 27, 10, 3, 1, 1)
BATCH = 16384
# the mid-size ragged plan of phases 2 and 2b
MID_TABLES = (40_000, 3_000, 120_000, 500, 70_000, 20_000, 9_000, 150_000)
MID_HOTS = (3, 1, 20, 2, 8, 5, 1, 12)
MID_B = 2048
WARMUP = 3
STEPS = 20
LR = 0.01


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call of fn over `reps` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_update(name, ref, got, acc_ref=None, acc_got=None):
    """Kernel vs plain: fp32 tables within rtol 1e-5 / atol 1e-6, bf16
    tables at most 1 ulp apart; accumulators (fp32) within rtol 1e-5."""
    out = {"max_abs": float((got.float() - ref.float()).abs().max())}
    if ref.dtype == torch.bfloat16:
        a = ref.view(torch.int16).int()
        b = got.view(torch.int16).int()
        ulps = (a - b).abs()
        out["ulp_max"] = int(ulps.max())
        out["ulp_diff_elems"] = int((ulps > 0).sum())
        check(out["ulp_max"] <= 1, f"{name}: bf16 table {out['ulp_max']} ulps apart")
    else:
        check(torch.allclose(got, ref, rtol=1e-5, atol=1e-6),
              f"{name}: fp32 table max abs diff {out['max_abs']}")
    if acc_ref is not None:
        out["acc_max_abs"] = float((acc_got - acc_ref).abs().max())
        check(torch.allclose(acc_got, acc_ref, rtol=1e-5, atol=1e-6),
              f"{name}: accumulator max abs diff {out['acc_max_abs']}")
    return out


def make_acc(optimizer, plan, table, gen):
    if optimizer == "sgd":
        return None
    shape = (plan.acc_rows, 128) if optimizer == "rwsadagrad" else table.shape
    return torch.rand(shape, generator=gen, device=table.device) * 0.1


def phase_build():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)  # name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    def timed(fn):
        t0 = time.perf_counter()
        r = fn()
        return r, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as ex:
        builds = {k: ex.submit(timed, functools.partial(kernel_library, k))
                  for k in KERNELS}
        native = ex.submit(timed, stream_native.available)
        build_s = {k: f.result()[1] for k, f in builds.items()}
        native_ok, native_s = native.result()
    check(native_ok, "native stream-work builder did not build")
    log("build (in parallel): " + ", ".join(
        f"{k} (nvcc sm_90a) {t:.1f} s" for k, t in build_s.items())
        + f", native builder (g++) {native_s:.1f} s")


def phase_k2_vs_plain():
    dev = torch.device("cuda")
    tables, hots, b, d = MID_TABLES, MID_HOTS, MID_B, 128
    plan = make_stream_plan(tables, d, b, hots, block_rows=2048)
    hb = ragged_multihot_batch(np.random.default_rng(1), 13, tables, hots, b)
    hb = dataclasses.replace(hb, wt=None)
    lists = {
        "full": hb.with_stream_work(plan, unit_weights=True),
        "touched": hb.with_stream_work(plan, unit_weights=True,
                                       update_touched_only=True),
    }
    log(f"phase 2: plan {len(tables)} tables, {plan.padded_rows} padded rows, "
        f"u_total {plan.u_total}, items {plan.max_items}; touched list "
        f"{lists['touched'].stream.num_real_items} of "
        f"{lists['full'].stream.num_real_items} items")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    dly = (torch.randn((len(tables), b, d), generator=gen, device=dev)
           ).to(torch.bfloat16)
    base32 = torch.randn((plan.padded_rows, d), generator=gen,
                         device=dev) * 0.05
    cases = []
    for opt in ("sgd", "rwsadagrad", "adagrad"):
        acc0 = make_acc(opt, plan, base32, gen)
        for tdt, sr in ((torch.float32, False), (torch.bfloat16, False),
                        (torch.bfloat16, True)):
            mm = torch.bfloat16 if tdt == torch.bfloat16 else torch.float32
            kernel_tables = {}
            for lname, h in lists.items():
                sw = h.to_device(dev, flat_hots=plan.hot).stream
                wts = (sw.rows_u != -1).float()
                g_u = gather_grads(dly, sw.vals_u, wts, sw.w2t)
                args = (g_u, sw.rows_u, sw.item_block, sw.item_row0,
                        sw.item_u, 0.05)
                kw = dict(mm_dtype=mm, stochastic_round=sr, seed=7)
                t_k = base32.to(tdt).clone()
                a_k = None if acc0 is None else acc0.clone()
                stream_update(opt, plan, t_k, a_k, *args, **kw)
                t_p = base32.to(tdt).clone()
                a_p = None if acc0 is None else acc0.clone()
                stream_update_plain(opt, plan, t_p, a_p, *args, **kw)
                torch.cuda.synchronize()
                name = f"{opt}/{str(tdt)[6:]}/sr={int(sr)}/{lname}"
                r = compare_update(name, t_p, t_k, a_p, a_k)
                changed = int((t_k != base32.to(tdt)).any(1).sum())
                check(changed > 0, f"{name}: kernel changed no row")
                kernel_tables[lname] = t_k
                cases.append(name)
                log(f"  {name}: max_abs {r['max_abs']:.3e}"
                    + (f" ulp_max {r['ulp_max']} ulp_diff_elems "
                       f"{r['ulp_diff_elems']}" if "ulp_max" in r else "")
                    + (f" acc_max_abs {r['acc_max_abs']:.3e}"
                       if "acc_max_abs" in r else "")
                    + f" rows_changed {changed}")
            # the touched-only list must give the full list's bits exactly
            check(torch.equal(kernel_tables["full"].view(torch.uint8),
                              kernel_tables["touched"].view(torch.uint8)),
                  f"{opt}/{tdt}/sr={sr}: touched-only list differs from full")
    log(f"phase 2: {len(cases)} K2 cases agree with the plain version")


def overrun_items(plan, sw):
    """Items of real blocks whose 256-slot chunk holds another block's
    hits (the chunks the TPU kernel relied on grid order for)."""
    br = plan.block_rows
    slots = (sw.item_u.long()[:, None]
             + torch.arange(256, device=sw.item_u.device))
    r = sw.rows_u.reshape(-1).long()[slots]
    row0 = sw.item_row0.long()[:, None]
    foreign = (r != SENTINEL_ROW) & ((r < row0) | (r >= row0 + br))
    return int((foreign.any(1) & (sw.item_block < plan.num_blocks)).sum())


def expected_rows(plan, sw, table, mm):
    """R_u by its definition: table[padded_offsets[t] + rows_u] rounded to
    mm at real slots, 0 at sentinels."""
    rows = sw.rows_u.reshape(-1).long()
    off = torch.tensor(plan.padded_offsets, device=table.device)[
        sw.w2t.long().repeat_interleave(1024)]
    real = rows != SENTINEL_ROW
    want = torch.zeros((plan.u_total, table.shape[1]), device=table.device)
    want[real] = table[(off + rows)[real]].to(mm).float()
    return want


def check_rows(name, plan, sw, table, mm):
    """K3 kernel against its plain version and against expected_rows, both
    bit for bit; every slot written."""
    args = (plan, table, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    got = stream_rows(*args, mm_dtype=mm)
    want = stream_rows_plain(*args, mm_dtype=mm)
    torch.cuda.synchronize()
    check(not bool(torch.isnan(want).any()), f"{name}: a slot left unwritten")
    check(torch.equal(got, want), f"{name}: K3 differs from its plain version "
          f"(max abs {float((got - want).abs().nan_to_num(1e30).max())})")
    check(torch.equal(got, expected_rows(plan, sw, table, mm)),
          f"{name}: K3 rows differ from table[padded_offsets[t] + rows_u]")
    return got, float((got - want).abs().max())


def phase_new_kernels_vs_plain():
    dev = torch.device("cuda")
    d = 128
    plan = make_stream_plan(MID_TABLES, d, MID_B, MID_HOTS, block_rows=2048)
    rng = np.random.default_rng(4)
    hb = ragged_multihot_batch(rng, 13, MID_TABLES, MID_HOTS, MID_B)
    real = hb.wt != 0
    hb.wt[real] = rng.uniform(0.5, 1.5, int(real.sum())).astype(np.float32)
    sw = hb.with_stream_work(plan).to_device(dev, flat_hots=plan.hot).stream
    wts = {"unit": (sw.rows_u != SENTINEL_ROW).float(), "random": sw.wts_u}
    n_real = int((sw.item_block < plan.num_blocks).sum())
    log(f"phase 2b: the phase-2 plan, full list: {n_real} real-block items, "
        f"{overrun_items(plan, sw)} of them overrun into the next block's run")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    # fp32 cotangent as autograd gives it: [B, T, d], passed transposed
    dly = torch.randn((MID_B, len(MID_TABLES), d), generator=gen,
                      device=dev).transpose(0, 1)
    n = 0
    for mm in (torch.float32, torch.bfloat16):
        for wname, w in wts.items():
            args = (dly, sw.vals_u, w, sw.w2t)
            got = window_grads(*args, mm_dtype=mm)
            want = window_grads_plain(*args, mm_dtype=mm)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"K1 mm={mm} weights={wname}: differs from its plain version")
            n += 1
    table32 = torch.randn((plan.padded_rows, d), generator=gen,
                          device=dev) * 0.05
    r_u = None
    for tdt in (torch.float32, torch.bfloat16):
        for mm in (torch.float32, torch.bfloat16):
            got, _ = check_rows(f"K3 table={tdt} mm={mm}", plan, sw,
                                table32.to(tdt), mm)
            if tdt == torch.float32 and mm == torch.float32:
                r_u = got
            n += 1
    pool_err = 0.0
    for mm in (torch.float32, torch.bfloat16):
        for wname, w in wts.items():
            args = (plan, r_u, sw.vals_u, w, sw.w2t)
            got = window_pool(*args, mm_dtype=mm)
            want = window_pool_plain(*args, mm_dtype=mm)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            pool_err = max(pool_err, err)
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"K4 mm={mm} weights={wname}: max abs diff {err}")
            n += 1
    # a block whose run is exactly 128 slots: its one 256-slot item reads
    # the next block's run too, which the item must not write
    oplan = make_stream_plan((512,), d, 128, 2, block_rows=128)
    idx = np.stack([np.arange(128), 128 + np.arange(128)], axis=1)[None]
    ohb = HostBatch(np.zeros((128, 13), np.float32), idx.astype(np.int32),
                    None, np.zeros((128, 1), np.float32))
    osw = ohb.with_stream_work(oplan).to_device(dev).stream
    check(overrun_items(oplan, osw) > 0, "overrun plan has no overrunning item")
    for tdt in (torch.float32, torch.bfloat16):
        check_rows(f"K3 overrun table={tdt}", oplan, osw,
                   torch.randn((oplan.padded_rows, d), generator=gen,
                               device=dev).to(tdt), torch.float32)
        n += 1
    log(f"phase 2b: {n} cases agree with the plain versions (K1 and K3 "
        f"bit-identical, K4 max abs diff {pool_err:.3e})")


def host_batch(rng, plan, cfg, timing, touched=True):
    """One fresh host batch as bench.py builds it: draw, U-layout build
    (native), then the flat per-hit layout with unit weights."""
    t0 = time.perf_counter()
    hb = ragged_multihot_batch(rng, cfg.num_dense, cfg.table_sizes,
                               V2_HOT_SIZES, BATCH)
    hb = dataclasses.replace(hb, wt=None)
    t1 = time.perf_counter()
    hb = hb.with_stream_work(plan, unit_weights=True,
                             update_touched_only=touched)
    t2 = time.perf_counter()
    timing["read"] += t1 - t0
    timing["build"] += t2 - t1
    return hb


def to_dev(hb, plan, timing):
    t0 = time.perf_counter()
    b = hb.to_device("cuda", flat_hots=plan.hot)
    timing["h2d"] += time.perf_counter() - t0
    return b


def profile_steps(tag, step, params, opt_state, batch, n=3):
    """torch.profiler over n steps on one resident batch: device time by
    kernel and the device's busy share of the window."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(params, opt_state, batch, LR)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    if busy == 0:
        log(f"{tag} profile: no device time recorded (not measured)")
        return
    log(f"{tag} profile ({n} steps, one resident batch): device busy "
        f"{busy / n / 1e3:.2f} ms/step of {wall_us / n / 1e3:.2f} ms wall "
        f"({busy / wall_us:.1%} busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"    {e.self_device_time_total / n / 1e3:8.3f} ms/step "
            f"{e.self_device_time_total / busy:6.1%}  x{e.count // n:<4d} "
            f"{e.key[:90]}")


def full_width_setup(fwd_impl, grad_impl):
    cfg = DLRMConfig(
        embedding_dim=128,
        table_sizes=tuple([200_000] * 26),
        mlp_bot=(13, 512, 256, 128),
        mlp_top=(1024, 1024, 512, 256, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=max(V2_HOT_SIZES),
        compute_dtype="bfloat16",
    )
    model = DLRMModel(cfg)
    plan = plan_for_model(model, BATCH, block_rows=2048,
                          hot_sizes=V2_HOT_SIZES)
    params = cast_emb(pad_params(model.init_params(seed=0), model, plan),
                      torch.bfloat16)
    opt_state = init_stream_opt_state("rwsadagrad", params, plan)
    step = make_stream_train_step(
        model, "rwsadagrad", plan, fwd_impl=fwd_impl, grad_impl=grad_impl,
        mm_dtype=torch.bfloat16, stochastic_round=True,
    )
    return cfg, model, plan, params, opt_state, step


def run_steps(tag, step, params, opt_state, plan, cfg, touched):
    """WARMUP + STEPS train steps at full width, a fresh host batch per
    step, built while the card works. Every launch count is set to 0 just
    before and read just after. Returns the last batch (host and device)
    and the launch counts."""
    rng = np.random.default_rng(0)
    timing = {"read": 0.0, "build": 0.0, "h2d": 0.0}
    hb = host_batch(rng, plan, cfg, timing, touched)
    batch = to_dev(hb, plan, timing)
    torch.cuda.synchronize()

    total = WARMUP + STEPS
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        LAUNCHES[k] = 0
    losses = []
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(total)]
    t_start = None
    for i in range(total):
        if i == WARMUP:
            torch.cuda.synchronize()
            timing = {k: 0.0 for k in timing}
            t_start = time.perf_counter()
        ev[i][0].record()
        if i == WARMUP - 1:  # does a step wait on the device anywhere?
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    params, opt_state, loss, _ = step(params, opt_state,
                                                      batch, LR)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sorted({str(w.message).splitlines()[0] for w in caught
                            if "prototype" not in str(w.message)})
        else:
            params, opt_state, loss, _ = step(params, opt_state, batch, LR)
        ev[i][1].record()
        losses.append(loss)
        if i + 1 < total:  # the next batch, built while the card works
            hb = host_batch(rng, plan, cfg, timing, touched)
            batch = to_dev(hb, plan, timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu().tolist()
    log(f"{tag} losses: " + " ".join(f"{x:.6f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss")
    dev_ms = [ev[i][0].elapsed_time(ev[i][1]) for i in range(WARMUP, total)]
    step_ms = wall / STEPS * 1e3
    log(f"{tag}: {STEPS} timed steps: wall {step_ms:.2f} ms/step "
        f"({BATCH * STEPS / wall:.0f} ex/s, host pipeline included); "
        f"device span per step median {float(np.median(dev_ms)):.2f} ms "
        f"(min {min(dev_ms):.2f}, max {max(dev_ms):.2f}); host per step: "
        f"draw {timing['read'] / STEPS * 1e3:.1f} ms, U-build "
        f"{timing['build'] / STEPS * 1e3:.1f} ms, H2D enqueue "
        f"{timing['h2d'] / STEPS * 1e3:.1f} ms")
    log(f"{tag}: launches in {total} steps: "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    log(f"{tag}: synchronizing calls in one step (sync debug mode): "
        f"{len(syncs)} distinct" + "".join(f"\n    {m}" for m in syncs))
    profile_steps(tag, step, params, opt_state, batch)
    return params, opt_state, hb, batch, launches


def bound(nbytes, nops):
    """The least time for the work: the larger of its bytes over the memory
    rate and its fp32 operations over the fp32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_OPS_PER_S * 1e3
    return max((bytes_ms, "bytes"), (ops_ms, "operations"))


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 nbytes, nops, library_ms):
    bound_ms, bound_by = bound(nbytes, nops)
    log(f"  {name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        + ("null" if library_ms is None else f"{library_ms:.3f} ms")
        + f", bound {bound_ms:.3f} ms by {bound_by} ({nbytes} B, {nops} "
        f"fp32 ops); {bound_ms / ms:.1%} of the bound; launches {launches}; "
        f"max abs err vs plain {err:.3e}")
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def touched_rows(hb):
    return sum(np.unique(hb.idx[t, :, :h]).size
               for t, h in enumerate(V2_HOT_SIZES))


def phase_gather_path():
    cfg, model, plan, params, opt_state, step = full_width_setup(
        "gather", "gather")
    log(f"phase 3: fwd_impl=gather grad_impl=gather, touched-only items; "
        f"plan padded_rows {plan.padded_rows}, u_total {plan.u_total}, "
        f"max_items {plan.max_items}, blocks {plan.num_blocks}; top MLP "
        f"{cfg.ln_top}")
    params, opt_state, hb, batch, launches = run_steps(
        "phase 3", step, params, opt_state, plan, cfg, touched=True)
    total = WARMUP + STEPS
    check(launches["stream_update"] == total,
          f"K2 launched {launches['stream_update']} times in {total} steps")

    # K2 alone at this shape, on the last step's work and a random dly
    sw = batch.stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    dly = torch.randn((len(cfg.table_sizes), BATCH, 128), generator=gen,
                      device="cuda").to(torch.bfloat16)
    g_u = gather_grads(dly, sw.vals_u, (sw.rows_u != -1).float(), sw.w2t)
    table = params["emb"]["stacked"]
    acc = opt_state["accum"]["emb"]["stacked"]
    args = (g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u, LR)
    kw = dict(mm_dtype=torch.bfloat16, stochastic_round=True, seed=11)
    t_k, a_k = table.clone(), acc.clone()
    t_p, a_p = table.clone(), acc.clone()
    stream_update("rwsadagrad", plan, t_k, a_k, *args, **kw)
    stream_update_plain("rwsadagrad", plan, t_p, a_p, *args, **kw)
    torch.cuda.synchronize()
    r = compare_update("full-width rwsadagrad/bf16/sr", t_p, t_k, a_p, a_k)
    log(f"phase 3: full-width K2 vs plain: max_abs {r['max_abs']:.3e} "
        f"ulp_max {r['ulp_max']} ulp_diff_elems {r['ulp_diff_elems']} "
        f"acc_max_abs {r['acc_max_abs']:.3e}")
    del t_p, a_p
    k2_ms = cuda_ms(lambda: stream_update("rwsadagrad", plan, t_k, a_k,
                                          *args, **kw), 10)
    plain_ms = cuda_ms(lambda: stream_update_plain(
        "rwsadagrad", plan, t_k, a_k, *args, **kw), 3)
    # bytes the function must move once: each real hit's G row (fp32),
    # rows_u and the item arrays, and each touched row's bf16 table row and
    # its fp32 accumulator, read and written
    n_hits = int((sw.rows_u != -1).sum())
    touched = touched_rows(hb)
    nbytes = (n_hits * 128 * 4 + sw.rows_u.numel() * 4
              + 3 * sw.item_block.numel() * 4
              + touched * (128 * 2 * 2 + 4 * 2))
    # fp32 operations: one add per hit element; per touched element the
    # rwsadagrad epilogue's square, row-sum add, lr product, divide, subtract
    nops = n_hits * 128 + touched * 128 * 5
    log(f"phase 3: K2 at full width ({n_hits} hits, {touched} touched rows):")
    k2 = kernel_entry(
        "stream_update", "dlrm_tpu_torch/csrc/stream_update.cu",
        "dlrm_tpu/ops/stream_kernels.py:438", launches["stream_update"],
        r["max_abs"], k2_ms, plain_ms, nbytes, nops, None)
    del t_k, a_k, g_u

    ev_step = make_stream_eval_step(model, plan)
    timing = {"read": 0.0, "build": 0.0, "h2d": 0.0}
    eb = to_dev(host_batch(np.random.default_rng(1), plan, cfg, timing),
                plan, timing)
    probs = ev_step(params, eb)
    torch.cuda.synchronize()
    check(tuple(probs.shape) == (BATCH, 1), f"eval probs shape {probs.shape}")
    check(bool(torch.isfinite(probs).all()), "non-finite eval probs")
    check(bool(((probs >= 0) & (probs <= 1)).all()), "eval probs outside [0, 1]")
    log(f"phase 3: eval step probs mean {float(probs.float().mean()):.4f} "
        f"min {float(probs.min()):.4f} max {float(probs.max()):.4f}")
    return k2


def phase_kernel_path():
    cfg, model, plan, params, opt_state, step = full_width_setup(
        "stream", "onehot")
    t_, d = len(cfg.table_sizes), cfg.embedding_dim
    log("phase 4: fwd_impl=stream grad_impl=onehot, full item list")
    params, opt_state, hb, batch, launches = run_steps(
        "phase 4", step, params, opt_state, plan, cfg, touched=False)
    total = WARMUP + STEPS
    for k in KERNELS:
        check(launches[k] == total,
              f"phase 4: {k} launched {launches[k]} times in {total} steps")

    sw = batch.stream
    emb = params["emb"]["stacked"]
    wts = (sw.rows_u != SENTINEL_ROW).float()
    mm = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    # fp32 cotangent as autograd gives it on this path: [B, T, d], transposed
    dly = torch.randn((BATCH, t_, d), generator=gen,
                      device="cuda").transpose(0, 1)
    k1_args = (dly, sw.vals_u, wts, sw.w2t)
    k3_args = (plan, emb, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)

    # one full-width call of each against its plain version
    g_k = window_grads(*k1_args, mm_dtype=mm)
    g_p = window_grads_plain(*k1_args, mm_dtype=mm)
    torch.cuda.synchronize()
    check(torch.equal(g_k, g_p), "full-width K1 differs from its plain version")
    k1_err = float((g_k - g_p).abs().max())
    del g_k, g_p
    r_u, k3_err = check_rows("full-width K3", plan, sw, emb, mm)
    k4_args = (plan, r_u, sw.vals_u, wts, sw.w2t)
    p_k = window_pool(*k4_args, mm_dtype=mm)
    p_p = window_pool_plain(*k4_args, mm_dtype=mm)
    torch.cuda.synchronize()
    k4_err = float((p_k - p_p).abs().max())
    check(torch.allclose(p_k, p_p, rtol=1e-5, atol=1e-6),
          f"full-width K4 max abs diff {k4_err}")
    del p_k, p_p
    log("phase 4: full-width K1 and K3 bit-identical to their plain versions, "
        f"K4 max abs diff {k4_err:.3e}")

    # times: each kernel, its plain version, the library yardsticks
    k1_ms = cuda_ms(lambda: window_grads(*k1_args, mm_dtype=mm), 10)
    k1_plain = cuda_ms(lambda: window_grads_plain(*k1_args, mm_dtype=mm), 3)
    gg_ms = cuda_ms(lambda: gather_grads(*k1_args), 10)
    k3_ms = cuda_ms(lambda: stream_rows(*k3_args, mm_dtype=mm), 10)
    k3_plain = cuda_ms(lambda: stream_rows_plain(*k3_args, mm_dtype=mm), 3)
    k4_ms = cuda_ms(lambda: window_pool(*k4_args, mm_dtype=mm), 10)
    k4_plain = cuda_ms(lambda: window_pool_plain(*k4_args, mm_dtype=mm), 3)
    idx = (sw.w2t.long()[:, None, None] * BATCH + sw.vals_u.long()).reshape(-1)
    k4_lib = cuda_ms(lambda: torch.zeros((t_ * BATCH, d), device="cuda")
                     .index_add_(0, idx, r_u), 10)
    k34_ms = cuda_ms(lambda: window_pool(plan, stream_rows(
        *k3_args, mm_dtype=mm), sw.vals_u, wts, sw.w2t, mm_dtype=mm), 10)
    # the gather path's forward as one F.embedding_bag over the flat hits
    hot = torch.tensor(V2_HOT_SIZES, device="cuda")
    tid = torch.repeat_interleave(torch.arange(t_, device="cuda"),
                                  hot * BATCH)
    rows = batch.idx.long() + torch.tensor(
        plan.padded_offsets, device="cuda")[tid]
    bag_len = torch.repeat_interleave(hot, BATCH)
    bag_off = torch.cumsum(bag_len, 0) - bag_len
    eb_ms = cuda_ms(lambda: F.embedding_bag(rows, emb, bag_off, mode="sum"),
                    10)
    log(f"phase 4: K3+K4 {k34_ms:.3f} ms against one F.embedding_bag "
        f"{eb_ms:.3f} ms on the same batch; gather_grads {gg_ms:.3f} ms "
        f"beside K1 {k1_ms:.3f} ms")

    n_slots = plan.u_total
    n_hits = int((sw.rows_u != SENTINEL_ROW).sum())
    touched = touched_rows(hb)
    items = sw.item_block.numel()
    log(f"phase 4: kernels at full width ({n_slots} slots, {n_hits} hits, "
        f"{touched} touched rows, {items} items):")
    entries = {
        # G_u written; dly (fp32) read once; vals_u, wts_u, w2t read;
        # one multiply per G element
        "window_grads": kernel_entry(
            "window_grads", "dlrm_tpu_torch/csrc/window_grads.cu",
            "dlrm_tpu/ops/stream_kernels.py:96", launches["window_grads"],
            k1_err, k1_ms, k1_plain,
            n_slots * d * 4 + t_ * BATCH * d * 4 + n_slots * 8
            + sw.w2t.numel() * 4, n_slots * d, None),
        # R_u written; each touched bf16 table row, rows_u and the items
        # read; no arithmetic beyond the bf16 -> fp32 conversion
        "stream_rows": kernel_entry(
            "stream_rows", "dlrm_tpu_torch/csrc/stream_rows.cu",
            "dlrm_tpu/ops/stream_kernels.py:613", launches["stream_rows"],
            k3_err, k3_ms, k3_plain,
            n_slots * d * 4 + touched * d * 2 + n_slots * 4 + items * 12,
            0, None),
        # each hit's R row, vals_u, wts_u and w2t read; pooled written;
        # a multiply and an add per hit element
        "window_pool": kernel_entry(
            "window_pool", "dlrm_tpu_torch/csrc/window_pool.cu",
            "dlrm_tpu/ops/stream_kernels.py:679", launches["window_pool"],
            k4_err, k4_ms, k4_plain,
            n_hits * d * 4 + n_slots * 8 + sw.w2t.numel() * 4
            + t_ * BATCH * d * 4, n_hits * d * 2, k4_lib),
    }
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    try:
        phase_build()
        phase_k2_vs_plain()
        phase_new_kernels_vs_plain()
        k2 = phase_gather_path()
        new = phase_kernel_path()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [new["window_grads"], k2, new["stream_rows"],
               new["window_pool"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
