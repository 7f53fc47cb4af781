"""On-card smoke of the PyTorch/H100 port (dlrm_tpu_torch): builds its
kernel, holds it against its plain version, and drives the port's main path
-- the single-device DLRM-v2 streamed train step -- at the full width of
bench.py's configuration.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and "ok" is printed only when all pass):
  1. card and build: the card's name and power limit; K2 (nvcc, sm_90a) and
     the native stream-work builder (g++) built in parallel from the sources
     in the checkout; TF32 off.
  2. K2 against its plain version on a mid-size ragged plan: sgd,
     rwsadagrad, adagrad; fp32 tables, bf16 tables with stochastic rounding
     off and on (the same hash on both sides); the full and the touched-only
     item list. Limits: fp32 rtol 1e-5 / atol 1e-6, bf16 at most 1 ulp apart
     -- the kernel and the plain version differ only in summation order.
  3. the main path at full width: 26 tables x 200,000 rows, d = 128, the
     ragged v2 hot sizes (214 hits/sample), batch 16,384, MLPs 13-512-256-128
     and 479-1024-1024-512-256-1, dot interaction, BCE, bf16 compute, bf16
     tables with stochastic rounding, rwsadagrad, block_rows 2048, flat
     layout, unit weights, touched-only items. A fresh host batch per step
     (ragged_multihot_batch, the native builder, pinned H2D); 3 warm-up and
     20 timed steps; K2's own time, its plain version's and its bytes bound
     at this shape; one full-width K2 step against its plain version; the
     eval step on one batch.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.native import stream_native
from dlrm_tpu_torch.ops.stream_kernels import (
    LAUNCHES,
    gather_grads,
    k2_library,
    stream_update,
    stream_update_plain,
)
from dlrm_tpu_torch.ops.stream_plan import make_stream_plan
from dlrm_tpu_torch.train.stream_step import (
    cast_emb,
    init_stream_opt_state,
    make_stream_eval_step,
    make_stream_train_step,
    pad_params,
    plan_for_model,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM published fp32 rate outside the tensor cores
V2_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                12, 100, 27, 10, 3, 1, 1)
BATCH = 16384
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

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        k2 = ex.submit(timed, k2_library)
        native = ex.submit(timed, stream_native.available)
        _, k2_s = k2.result()
        native_ok, native_s = native.result()
    check(native_ok, "native stream-work builder did not build")
    log(f"build: K2 (nvcc sm_90a) {k2_s:.1f} s, native builder (g++) "
        f"{native_s:.1f} s")


def phase_k2_vs_plain():
    dev = torch.device("cuda")
    tables = (40_000, 3_000, 120_000, 500, 70_000, 20_000, 9_000, 150_000)
    hots = (3, 1, 20, 2, 8, 5, 1, 12)
    b, d = 2048, 128
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


def host_batch(rng, plan, cfg, timing):
    """One fresh host batch as bench.py builds it: draw, U-layout build
    (native), then the flat per-hit layout with unit weights."""
    t0 = time.perf_counter()
    hb = ragged_multihot_batch(rng, cfg.num_dense, cfg.table_sizes,
                               V2_HOT_SIZES, BATCH)
    hb = dataclasses.replace(hb, wt=None)
    t1 = time.perf_counter()
    hb = hb.with_stream_work(plan, unit_weights=True,
                             update_touched_only=True)
    t2 = time.perf_counter()
    timing["read"] += t1 - t0
    timing["build"] += t2 - t1
    return hb


def to_dev(hb, plan, timing):
    t0 = time.perf_counter()
    b = hb.to_device("cuda", flat_hots=plan.hot)
    timing["h2d"] += time.perf_counter() - t0
    return b


def profile_steps(step, params, opt_state, batch, n=3):
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
        log("phase 3 profile: no device time recorded (not measured)")
        return
    log(f"phase 3 profile ({n} steps, one resident batch): device busy "
        f"{busy / n / 1e3:.2f} ms/step of {wall_us / n / 1e3:.2f} ms wall "
        f"({busy / wall_us:.1%} busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / n / 1e3:8.3f} ms/step "
            f"{e.self_device_time_total / busy:6.1%}  x{e.count // n:<4d} "
            f"{e.key[:90]}")


def phase_main_path():
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
        model, "rwsadagrad", plan, mm_dtype=torch.bfloat16,
        stochastic_round=True,
    )
    log(f"phase 3: plan padded_rows {plan.padded_rows}, u_total "
        f"{plan.u_total}, max_items {plan.max_items}, blocks "
        f"{plan.num_blocks}; top MLP {cfg.ln_top}")
    rng = np.random.default_rng(0)
    timing = {"read": 0.0, "build": 0.0, "h2d": 0.0}

    hb = host_batch(rng, plan, cfg, timing)
    batch = to_dev(hb, plan, timing)
    torch.cuda.synchronize()

    total = WARMUP + STEPS
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES["stream_update"] = 0
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
            hb = host_batch(rng, plan, cfg, timing)
            batch = to_dev(hb, plan, timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = LAUNCHES["stream_update"]
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu().tolist()
    log("phase 3 losses: " + " ".join(f"{x:.6f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(launches == total, f"K2 launched {launches} times in {total} steps")
    dev_ms = [ev[i][0].elapsed_time(ev[i][1]) for i in range(WARMUP, total)]
    step_ms = wall / STEPS * 1e3
    log(f"phase 3: {STEPS} timed steps: wall {step_ms:.2f} ms/step "
        f"({BATCH * STEPS / wall:.0f} ex/s, host pipeline included); "
        f"device span per step median {float(np.median(dev_ms)):.2f} ms "
        f"(min {min(dev_ms):.2f}, max {max(dev_ms):.2f}); host per step: "
        f"draw {timing['read'] / STEPS * 1e3:.1f} ms, U-build "
        f"{timing['build'] / STEPS * 1e3:.1f} ms, H2D enqueue "
        f"{timing['h2d'] / STEPS * 1e3:.1f} ms")
    log(f"phase 3: K2 launches {launches} in {total} steps; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    log(f"phase 3: synchronizing calls in one step (sync debug mode): "
        f"{len(syncs)} distinct" + "".join(f"\n    {m}" for m in syncs))
    profile_steps(step, params, opt_state, batch)

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
    touched = sum(np.unique(hb.idx[t, :, :h]).size
                  for t, h in enumerate(V2_HOT_SIZES))
    nbytes = (n_hits * 128 * 4 + sw.rows_u.numel() * 4
              + 3 * sw.item_block.numel() * 4
              + touched * (128 * 2 * 2 + 4 * 2))
    # fp32 operations: one add per hit element; per touched element the
    # rwsadagrad epilogue's square, row-sum add, lr product, divide, subtract
    nops = n_hits * 128 + touched * 128 * 5
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    log(f"phase 3: K2 {k2_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms by {bound_by} ({nbytes} B: {n_hits} hits, "
        f"{touched} touched rows -> {bytes_ms:.3f} ms; {nops} fp32 ops -> "
        f"{ops_ms:.4f} ms); {bound_ms / k2_ms:.1%} of the bound")
    del t_k, a_k, g_u

    ev_step = make_stream_eval_step(model, plan)
    eb = to_dev(host_batch(rng, plan, cfg, timing), plan, timing)
    probs = ev_step(params, eb)
    torch.cuda.synchronize()
    check(tuple(probs.shape) == (BATCH, 1), f"eval probs shape {probs.shape}")
    check(bool(torch.isfinite(probs).all()), "non-finite eval probs")
    check(bool(((probs >= 0) & (probs <= 1)).all()), "eval probs outside [0, 1]")
    log(f"phase 3: eval step probs mean {float(probs.float().mean()):.4f} "
        f"min {float(probs.min()):.4f} max {float(probs.max()):.4f}")
    return {
        "name": "stream_update",
        "route": "cuda",
        "source": "dlrm_tpu_torch/csrc/stream_update.cu",
        "replaces": "dlrm_tpu/ops/stream_kernels.py:438",
        "launches": launches,
        "max_abs_err": r["max_abs"],
        "ms": k2_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    try:
        phase_build()
        phase_k2_vs_plain()
        k2 = phase_main_path()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [k2]}))
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
