"""On-card smoke of the PyTorch/H100 port (dlrm_tpu_torch): builds its
kernels, holds each against its plain version, and drives the port's two
paths of the single-device DLRM-v2 streamed train step at the full width of
bench.py's configuration: the gather path (K2) and the streamed-forward,
one-hot-grads path (K3, K4, K1 and K2); then the probes, the DLRM-v2
trainer (v2_main.main) from disk and on random data, and the trainer's
other single-device paths: the fused coalesce+scatter step (coalesce_rows
and row_scatter_add) that --embedding_impl auto picks on large tables, the
dense autograd step, and weighted pooling on the stream path; then the v1
trainer (cli.main) on the reference's scripts.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and "ok" is printed only when all pass):
  1. card and build: the card's name and power limit; K1-K4 (one nvcc
     sm_90a build per source) and the native stream-work builder (g++),
     all built in parallel from the sources in the checkout; TF32 off.
  2. K2 against its plain version, bit for bit, on a mid-size ragged plan:
     sgd, rwsadagrad, adagrad; fp32 tables, bf16 tables with stochastic
     rounding off and on (the same hash on both sides); the full and the
     touched-only item list (which must also give the full list's bits), a
     row with 2,048 hits whose run spans several items, three one-block
     tables whose last and first rows coincide across each segment boundary,
     and a skewed batch with one row of 20,480 hits (K2 timed on it and on
     the plain batch). 45 cases.
  2b. K1, K3 and K4 against their plain versions, bit for bit, on the same
     plan and the full item list: K1 with mm_dtype fp32 / bf16 and unit /
     random weights, K3 with fp32 / bf16 tables and mm_dtype, K4 as K1 and
     on its edge cases (30 % weight-0 slots, a budgeted table whose
     weight-0 hits are dropped from U, leaving bags with no slot, bags
     hitting one row twice), each K4 case called twice with the same bits;
     K3 also on a plan whose first block's 128-slot run makes its 256-slot
     item overrun into the next block's run.
  3. the gather path at full width: 26 tables x 200,000 rows, d = 128, the
     ragged v2 hot sizes (214 hits/sample), batch 16,384, MLPs 13-512-256-128
     and 479-1024-1024-512-256-1, dot interaction, BCE, bf16 compute, bf16
     tables with stochastic rounding, rwsadagrad, block_rows 2048, flat
     layout, unit weights, touched-only items, fwd_impl="gather" and
     grad_impl="gather". A fresh host batch per step (ragged_multihot_batch,
     the native builder, pinned H2D); 3 warm-up and 20 timed steps; K2's
     own time, its plain version's and its bound at this shape; one
     full-width K2 step against its plain version, bit for bit; the eval
     step on one batch.
  4. the kernel path at full width: the same model and batch with
     fwd_impl="stream" (K3 then K4) and grad_impl="onehot" (K1) on the full
     item list (so K2 runs on it too); 3 warm-up and 20 timed steps, each
     kernel launched once per step; the profile; one full-width K1, K3,
     K4 (twice) and K2 (full list) call against its plain version, bit for
     bit; each kernel's time, its plain version's and its bound from this
     run's data, K2's on the full list, and the library
     yardsticks (K3 against one index_select of the slots' rows, K4
     against one index_add_, K3+K4 against one F.embedding_bag,
     gather_grads beside K1).
  5. the probes (dlrm_tpu_torch/probes/, the port of bench_scripts/'s
     Pallas probes P1-P6): each probe kernel against its plain version at a
     small size and at its probe's own size (row_gather, row_scatter_add,
     block_stream, t3_reshape_add and the k2_bisect skeletons bit-identical;
     k2_bisect V1/V2/V5/V6 within rtol 1e-5 / atol 1e-6 of the plain sgd
     update and bit-identical to K2; t2_contract and t4_onehot_accumulate
     rtol 1e-5 / atol 1e-4; t6_revolve_accumulate atol 1e-5); then every
     launch count set to 0, the six probes' main() at their own sizes (K2's
     bisection also at the main-path shape, with one index_add_ as V1's
     library call and K2 itself on a ladder of configurations from V1's sgd
     on fp32 to the train step's rwsadagrad on bf16), the counts read, and
     the card's copy, revolve, gather and scatter figures and each probe
     kernel's time, plain time, bound and library yardstick.
  6. the trainer, dlrm_tpu_torch/v2_main.py: (a) processed Criteo days drawn
     from a numpy seed for bench.py's tables (3 days, 262,144 rows), made
     multi-hot with V2_HOT_SIZES by materialize_multihot_dataset (224 MB of
     sparse .npy in a temporary directory of the checkout), then main() at
     phase 3's width and options through --embedding_impl stream,
     --embedding_dtype bfloat16 and --adagrad, 12 train steps from the
     files through the prefetcher, val and test 2 batches each: its own
     samples/s, loss and AUROC; each step's device span (CUDA events) and
     synchronizing calls; the spans' share of the loop's device window;
     peak memory; K2 launched once per step and nothing else; then a
     separate pass timing the host's read, U-build and H2D per batch, K2 on
     the first from-disk batch bit for bit against its plain version, and
     a prefetched batch equal to the synchronous copy. (b) main() on random
     data through Multihot at batch 1,024, 3 steps.
  7. the trainer's other single-device paths. C1: each bf16 layer of the
     v2 dense tower rounds once (its fp32 sum plus the bias, bit for bit;
     within the accumulation bound of an fp32 recompute). (a) 3 days drawn
     at the Criteo Kaggle counts (33.76 M rows, 17.3 GB of fp32 tables) and
     materialized with V2_HOT_SIZES, then main() with --embedding_impl
     auto, the MLPerf DLRM-v2 DCN (3 layers, rank 512), --adagrad, batch
     16,384, 12 steps and 2 + 2 eval batches: auto must choose the fused
     step; coalesce_rows and row_scatter_add launched once per step and
     nothing else; 0 synchronizing calls past the first step; the fused
     step's cost per hit; then both kernels on the first from-disk batch
     against their plain versions, bit for bit, timed beside them, their
     bounds and library yardsticks; coalesce_rows against its plain
     version, bit for bit and called twice for the same bits, on runs of
     C - 1, C, C + 1 and 3C + 17 hits (C its chunk length) and of 65,275
     and 262,144 hits at d 8 to 512, weighted and not, and timed on the two
     long runs; the fused step twice from the same state, the same bits;
     its profile.
     On phase 6's days: (b) the dense step with the projection interaction
     (no kernel of the port), (c) the stream path with bf16 tables and
     learned v_w (K2 once per step), each with 0 syncs past the first step;
     (d) one fused and one dense step from the same params within atol
     3e-6, and the dense step's profile.
  8. the v1 trainer, dlrm_tpu_torch/cli.py, through cli.main (the harness's
     train step probed: CUDA events and syncs per step; every launch count
     set to 0 before each run). (a) bench_scripts/dlrm_tpu_benchmark.sh's
     shape at mini-batch 2,048: 8 tables x 1,000,000 rows, d 64, MLPs
     512-512-64 and 1024-1024-1024-1, 100 indices per lookup (fixed), bf16
     compute, random data, 20 steps: the harness's ms/it, the spans, 0
     syncs past the first step, coalesce_rows and row_scatter_add once per
     step, the host's draw of one batch. (b) bench_scripts/run_and_time.sh
     (d 128, MLPs 13-512-256-128 and 1024-1024-512-256-1, sgd lr 1.0, batch
     2,048, test batch 16,384, --mlperf-logging) on 24 Criteo-format raw
     days of 8,192 rows drawn from a seed with a planted signal, through the
     port's preprocessing (the g++ parser), bins and CriteoBinFile: 92 steps
     with evaluations after steps 46 and 92 (AUC lines, the MLPerf events
     from cache_clear to run_stop), a --save-model checkpoint, then a
     --load-model run from step 46's checkpoint whose losses for steps
     47-92 equal the first run's bit for bit; both kernels once per step.
     (c) QR (mult, add, concat) and MD tables at the Criteo Kaggle counts
     and bench_scripts/dlrm_criteo_kaggle.sh's widths (d 16, MLPs
     13-512-256-64-16 and 512-256-1), batch 128, random data: 3 dense steps
     each with finite losses and 0 syncs past the first; then on tables of
     at most 100,000 rows the same 3 steps on the card and on the CPU from
     one init, losses within rtol 1e-5 and parameters within rtol 1e-4 /
     atol 1e-5. (d) the four golden configs of test_scripts/dlrm_tpu_test.sh
     on the card: every loss line within 5e-6 of its golden log. In 8a
     (one trainer step on a batch of the run's shape, after the run, so
     that the copies do not count in its peak memory) and 8d (every step)
     each call of coalesce_rows and row_scatter_add is copied and its plain
     version run on the same inputs: equal bit for bit.
The last two lines are the kernels JSON (14 kernels: phase 7 adds
coalesce_rows and row_scatter_add at the fused step's shape; their
`launches` are phase 7a's, and `launches_by_path` gives 7a's and each
phase-8 run's, each read just after its own reset to 0) and {"ok": true,
"device": ...}. The whole
run takes about 3-4 minutes on one H100, builds included.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dlrm_tpu_torch import cli, v2_main
from dlrm_tpu_torch.config import DCNConfig, DLRMConfig
from dlrm_tpu_torch.configs.presets import CRITEO_KAGGLE_COUNTS
from dlrm_tpu_torch.data.multi_hot_criteo import (
    MultiHotCriteoDataset,
    materialize_multihot_dataset,
)
from dlrm_tpu_torch.data.random_data import (
    V2_HOT_SIZES,
    HostBatch,
    RandomDataset,
    ragged_multihot_batch,
)
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.native import stream_native
from dlrm_tpu_torch.ops import mlp
from dlrm_tpu_torch.ops import probe_kernels as pk
from dlrm_tpu_torch.ops import sparse_update as su
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
from dlrm_tpu_torch.ops.stream_plan import (
    SENTINEL_ROW,
    build_stream_work,
    make_stream_plan,
)
from dlrm_tpu_torch.probes import (
    k2_bisect as p3,
    kernel_feasibility as p6,
    pallas_probe as p5,
    revolve_probe as p4,
    scan_probe as p1,
    stream_variants as p2,
)
from dlrm_tpu_torch.optim.optimizers import (
    init_opt_state,
    tree_leaves,
    tree_map,
)
from dlrm_tpu_torch.probes.common import time_ms
from dlrm_tpu_torch.train import harness
from dlrm_tpu_torch.train.fused_step import make_fused_train_step
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
from dlrm_tpu_torch.train.step import make_train_step
from dlrm_tpu_torch.train.stream_step import (
    cast_emb,
    init_stream_opt_state,
    make_stream_eval_step,
    make_stream_train_step,
    pad_params,
    plan_for_model,
)

KERNELS = ("window_grads", "stream_update", "stream_rows", "window_pool")
CUDA = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM published fp32 rate outside the tensor cores
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


def compare_update(name, ref, got, acc_ref=None, acc_got=None):
    """Kernel vs plain, bit for bit (the same sums in the same order, the
    same epilogue): table and accumulator. Returns the max abs differences
    (0 when the check passes) and, for bf16 tables, how many elements
    differ."""
    out = {"max_abs": float((got.float() - ref.float()).abs().max())}
    check(torch.equal(got.view(torch.uint8), ref.view(torch.uint8)),
          f"{name}: table differs from the plain version "
          f"(max abs {out['max_abs']:.3e}, "
          f"{int((got != ref).sum())} elements)")
    if acc_ref is not None:
        out["acc_max_abs"] = float((acc_got - acc_ref).abs().max())
        check(torch.equal(acc_got, acc_ref),
              f"{name}: accumulator differs (max abs {out['acc_max_abs']})")
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

    sources = KERNELS + pk.SOURCES + su.SOURCES
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as ex:
        builds = {k: ex.submit(timed, functools.partial(kernel_library, k))
                  for k in sources}
        native = ex.submit(timed, stream_native.available)
        build_s = {k: f.result()[1] for k, f in builds.items()}
        native_ok, native_s = native.result()
    check(native_ok, "native stream-work builder did not build")
    log("build (in parallel): " + ", ".join(
        f"{k} (nvcc sm_90a) {t:.1f} s" for k, t in build_s.items())
        + f", native builder (g++) {native_s:.1f} s")


def device_work(work):
    """A numpy StreamWork's arrays on the card."""
    return dataclasses.replace(work, **{
        k: torch.from_numpy(v).to(CUDA) for k, v in vars(work).items()
        if isinstance(v, np.ndarray)})


def boundary_work():
    """Three one-block tables of 5 rows whose last and first hit rows
    coincide across each segment boundary (table 0 ends with row 2, table 1
    starts with it; table 1 ends with row 4, table 2 holds only row 4)."""
    plan = make_stream_plan((5, 5, 5), 128, 4, 2, block_rows=2048)
    idx = np.array([[[0, 2], [2, 1], [0, 0], [1, 2]],
                    [[2, 4], [4, 3], [2, 2], [3, 4]],
                    [[4, 4], [4, 4], [4, 4], [4, 4]]], np.int32)
    work = build_stream_work(plan, idx, np.ones(idx.shape, np.float32),
                             prefer_native=False)
    rows = work.rows_u.reshape(-1)
    for t in (1, 2):
        prev = rows[plan.u_base[t - 1]:plan.u_base[t]]
        check(rows[plan.u_base[t]] == prev[prev >= 0][-1],
              "boundary plan: rows do not coincide across the boundary")
    return plan, device_work(work)


def phase_k2_vs_plain():
    """K2 against its plain version, bit for bit: every optimizer, table
    type and rounding on the mid-size plan's full and touched-only lists,
    on a row whose run spans several items, on equal rows across table
    boundaries, and on one skewed row with 20,480 hits (timed)."""
    tables, hots, b, d = MID_TABLES, MID_HOTS, MID_B, 128
    plan = make_stream_plan(tables, d, b, hots, block_rows=2048)

    def mid(rng_seed, edit=None, touched=False):
        hb = ragged_multihot_batch(np.random.default_rng(rng_seed), 13,
                                   tables, hots, b)
        if edit is not None:
            edit(hb.idx)
        hb = dataclasses.replace(hb, wt=None).with_stream_work(
            plan, unit_weights=True, update_touched_only=touched)
        return hb.to_device(CUDA, flat_hots=plan.hot).stream

    def long_run(idx):  # 2,048 hits of row 7 of table 0: 8 items' worth
        idx[0, :, 0] = 7

    def skew(idx):  # 20,480 hits of row 11 of table 2 (hot 20)
        idx[2, :, :10] = 11

    bplan, bsw = boundary_work()
    lists = {
        "full": (plan, mid(1)),
        "touched": (plan, mid(1, touched=True)),
        "long run": (plan, mid(1, long_run)),
        "skewed": (plan, mid(1, skew)),
        "boundary": (bplan, bsw),
    }
    hot_hits = int((lists["skewed"][1].rows_u.reshape(-1)[
        plan.u_base[2]:plan.u_base[3]] == 11).sum())
    check(hot_hits == 20 * b // 2, f"skewed plan: {hot_hits} hits of row 11")
    log(f"phase 2: plan {len(tables)} tables, {plan.padded_rows} padded rows, "
        f"u_total {plan.u_total}, items {plan.max_items}; touched list "
        f"{lists['touched'][1].item_block.lt(plan.num_blocks).sum()} of "
        f"{lists['full'][1].item_block.lt(plan.num_blocks).sum()} real items; "
        f"long run 2048 hits, skewed row {hot_hits} hits; boundary plan "
        f"{bplan.table_sizes}")
    gen = torch.Generator(device=CUDA)
    gen.manual_seed(2)
    inputs = {}  # per plan: dly, the fp32 table, each optimizer's acc
    for pl in (plan, bplan):
        dly = torch.randn((len(pl.table_sizes), pl.batch, d), generator=gen,
                          device=CUDA).to(torch.bfloat16)
        base32 = torch.randn((pl.padded_rows, d), generator=gen,
                             device=CUDA) * 0.05
        inputs[pl] = (dly, base32, {opt: make_acc(opt, pl, base32, gen)
                                    for opt in ("sgd", "rwsadagrad",
                                                "adagrad")})
    cases, timed, kernel_tables = [], {}, {}
    for lname, (pl, sw) in lists.items():
        dly, base32, accs = inputs[pl]
        wts = (sw.rows_u != -1).float()
        g_u = gather_grads(dly, sw.vals_u, wts, sw.w2t)
        args = (g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u, 0.05)
        for opt, acc0 in accs.items():
            for tdt, sr in ((torch.float32, False), (torch.bfloat16, False),
                            (torch.bfloat16, True)):
                mm = torch.bfloat16 if tdt == torch.bfloat16 else torch.float32
                kw = dict(mm_dtype=mm, stochastic_round=sr, seed=7)
                t_k = base32.to(tdt).clone()
                a_k = None if acc0 is None else acc0.clone()
                stream_update(opt, pl, t_k, a_k, *args, **kw)
                t_p = base32.to(tdt).clone()
                a_p = None if acc0 is None else acc0.clone()
                stream_update_plain(opt, pl, t_p, a_p, *args, **kw)
                torch.cuda.synchronize()
                name = f"{opt}/{str(tdt)[6:]}/sr={int(sr)}/{lname}"
                compare_update(name, t_p, t_k, a_p, a_k)
                changed = int((t_k != base32.to(tdt)).any(1).sum())
                check(changed > 0, f"{name}: kernel changed no row")
                cases.append(name)
                kernel_tables[name] = t_k
                if opt == "rwsadagrad" and sr and lname in ("full", "skewed"):
                    t_t, a_t = t_k.clone(), a_k.clone()
                    timed[lname] = time_ms(lambda: stream_update(
                        opt, pl, t_t, a_t, *args, **kw), CUDA, 10)
                log(f"  {name}: bit-identical, rows_changed {changed}")
    for name in cases:  # the touched-only list gives the full list's bits
        if name.endswith("/full"):
            check(torch.equal(kernel_tables[name].view(torch.uint8),
                              kernel_tables[name[:-4] + "touched"].view(
                                  torch.uint8)),
                  f"{name[:-5]}: touched-only list differs from full")
    log(f"phase 2: {len(cases)} K2 cases bit-identical to the plain version")
    log(f"phase 2: K2 rwsadagrad/bf16/sr on the mid-size full list "
        f"{timed['full']:.3f} ms; with one row of {hot_hits} hits (summed "
        f"serially by one warp) {timed['skewed']:.3f} ms")


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


def check_pool(name, args, mm):
    """K4 twice and its plain version on args: all three bit for bit.
    Returns K4's output and its max abs difference from the plain one."""
    first = window_pool(*args, mm_dtype=mm)
    again = window_pool(*args, mm_dtype=mm)
    want = window_pool_plain(*args, mm_dtype=mm)
    torch.cuda.synchronize()
    err = float((first - want).abs().max())
    check(torch.equal(first, want),
          f"{name}: K4 differs from its plain version (max abs {err:.3e})")
    check(torch.equal(first.view(torch.int32), again.view(torch.int32)),
          f"{name}: two K4 calls differ")
    return first, err


def pool_cases(rng):
    """K4's edge cases on the mid-size plan, full item lists: random weights
    with 30 % of them 0; table 1 (one hit per bag) budgeted, its weight-0
    hits dropped from U, so its bags of weight 0 have no slot; every bag
    hitting its first row twice (tables of hot >= 2)."""
    def batch():
        hb = ragged_multihot_batch(rng, 13, MID_TABLES, MID_HOTS, MID_B)
        real = hb.wt != 0
        hb.wt[real] = rng.uniform(0.5, 1.5, int(real.sum())).astype(
            np.float32)
        return hb

    plan = make_stream_plan(MID_TABLES, 128, MID_B, MID_HOTS, block_rows=2048)
    out = {}
    hb = batch()
    hb.wt[rng.random(hb.wt.shape) < 0.3] = 0.0
    out["weight0"] = plan, hb
    hb = batch()
    hb.wt[1][rng.random(hb.wt[1].shape) < 0.5] = 0.0
    budget = [None] * len(MID_TABLES)
    budget[1] = int((hb.wt[1] != 0).sum()) + 64
    out["budgeted"] = make_stream_plan(MID_TABLES, 128, MID_B, MID_HOTS,
                                       block_rows=2048, u_budget=budget), hb
    hb = batch()
    hb.idx[:, :, 1] = hb.idx[:, :, 0]  # the builder reads hot[t] columns
    out["repeat row"] = plan, hb
    return {k: (p, device_work(build_stream_work(p, h.idx, h.wt,
                                                 prefer_native=False)))
            for k, (p, h) in out.items()}


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
    for mm in (torch.float32, torch.bfloat16):
        for wname, w in wts.items():
            check_pool(f"K4 mm={mm} weights={wname}",
                       (plan, r_u, sw.vals_u, w, sw.w2t), mm)
            n += 1
    for cname, (cplan, csw) in pool_cases(rng).items():
        c_r = stream_rows(cplan, table32, csw.rows_u, csw.item_block,
                          csw.item_row0, csw.item_u)
        for mm in (torch.float32, torch.bfloat16):
            got, _ = check_pool(f"K4 {cname} mm={mm}",
                                (cplan, c_r, csw.vals_u, csw.wts_u, csw.w2t),
                                mm)
            n += 1
        if cname == "budgeted":  # table 1's bags whose every hit was dropped
            dropped = csw.wts_u.new_ones(MID_B, dtype=torch.bool)
            kept = csw.vals_u.reshape(-1)[cplan.u_base[1]:cplan.u_base[2]]
            dropped[kept[csw.wts_u.reshape(-1)[
                cplan.u_base[1]:cplan.u_base[2]] != 0].long()] = False
            check(int(dropped.sum()) > 0, "budgeted case drops no bag")
            check(not bool(got[1][dropped].view(torch.int32).any()),
                  "K4: a bag with every hit dropped is not a +0 row")
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
    log(f"phase 2b: {n} cases bit-identical to the plain versions (K4 "
        "called twice in each, with the same bits)")


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
    # kernels and copies only: a record_function range shows on the device
    # too (a user annotation), and its time overlaps its kernels'
    labels = {e.key for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in labels]
    busy = sum(e.self_device_time_total for e in kernels)
    if busy == 0:
        log(f"{tag} profile: no device time recorded (not measured)")
        return
    log(f"{tag} profile ({n} steps, one resident batch): device busy "
        f"{busy / n / 1e3:.2f} ms/step of {wall_us / n / 1e3:.2f} ms wall "
        f"({busy / wall_us:.1%} busy)")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the top 14, and every other pass of the port's kernels (K4's count,
    # scan and place passes among them)
    shown = ranked[:14] + [e for e in ranked[14:] if e.key.startswith(
        ("void (anonymous namespace)::k", "(anonymous namespace)::k"))]
    for e in shown:
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
    launches = {k: LAUNCHES[k] for k in KERNELS}
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
    log("phase 3: full-width K2 bit-identical to its plain version (table "
        "and accumulator)")
    del t_p, a_p
    k2_ms = time_ms(lambda: stream_update("rwsadagrad", plan, t_k, a_k,
                                          *args, **kw), CUDA, 10,
                    warmup=0)
    plain_ms = time_ms(lambda: stream_update_plain(
        "rwsadagrad", plan, t_k, a_k, *args, **kw), CUDA, 3, warmup=0)
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
    _, k4_err = check_pool("full-width K4", k4_args, mm)
    log("phase 4: full-width K1, K3 and K4 bit-identical to their plain "
        "versions; two K4 calls give the same bits")

    # K2 on this path's full item list: bits against the plain version, and
    # its time beside phase 3's touched-only list
    acc = opt_state["accum"]["emb"]["stacked"]
    g_u = window_grads(*k1_args, mm_dtype=mm)
    k2_args = (g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u, LR)
    kw = dict(mm_dtype=mm, stochastic_round=True, seed=12)
    t_k, a_k = emb.clone(), acc.clone()
    t_p, a_p = emb.clone(), acc.clone()
    stream_update("rwsadagrad", plan, t_k, a_k, *k2_args, **kw)
    stream_update_plain("rwsadagrad", plan, t_p, a_p, *k2_args, **kw)
    torch.cuda.synchronize()
    compare_update("full-width K2, full list", t_p, t_k, a_p, a_k)
    del t_p, a_p
    k2_full_ms = time_ms(lambda: stream_update(
        "rwsadagrad", plan, t_k, a_k, *k2_args, **kw), CUDA, 10, warmup=0)
    del t_k, a_k, g_u
    log(f"phase 4: K2 on the full item list bit-identical to its plain "
        f"version; {k2_full_ms:.3f} ms")

    # times: each kernel, its plain version, the library yardsticks
    k1_ms = time_ms(lambda: window_grads(*k1_args, mm_dtype=mm), CUDA, 10,
                    warmup=0)
    k1_plain = time_ms(lambda: window_grads_plain(*k1_args, mm_dtype=mm),
                       CUDA, 3, warmup=0)
    gg_ms = time_ms(lambda: gather_grads(*k1_args), CUDA, 10, warmup=0)
    k3_ms = time_ms(lambda: stream_rows(*k3_args, mm_dtype=mm), CUDA, 10,
                    warmup=0)
    k3_plain = time_ms(lambda: stream_rows_plain(*k3_args, mm_dtype=mm),
                       CUDA, 3, warmup=0)
    # K3's library yardstick: one index_select of every slot's global row.
    # It differs from K3 at the sentinel slots (row 0, not zeros) and in
    # its output type (the bf16 table's, not fp32).
    slot_rows = torch.where(
        sw.rows_u.reshape(-1) != SENTINEL_ROW,
        torch.tensor(plan.padded_offsets, device="cuda")[
            sw.w2t.long().repeat_interleave(1024)] + sw.rows_u.reshape(-1),
        0)
    k3_lib = time_ms(lambda: torch.index_select(emb, 0, slot_rows), CUDA,
                     10, warmup=0)
    k4_ms = time_ms(lambda: window_pool(*k4_args, mm_dtype=mm), CUDA, 10,
                    warmup=0)
    k4_plain = time_ms(lambda: window_pool_plain(*k4_args, mm_dtype=mm),
                       CUDA, 3, warmup=0)
    idx = (sw.w2t.long()[:, None, None] * BATCH + sw.vals_u.long()).reshape(-1)
    k4_lib = time_ms(lambda: torch.zeros((t_ * BATCH, d), device="cuda")
                     .index_add_(0, idx, r_u), CUDA, 10, warmup=0)
    k34_ms = time_ms(lambda: window_pool(plan, stream_rows(
        *k3_args, mm_dtype=mm), sw.vals_u, wts, sw.w2t, mm_dtype=mm), CUDA,
        10, warmup=0)
    # the gather path's forward as one F.embedding_bag over the flat hits
    hot = torch.tensor(V2_HOT_SIZES, device="cuda")
    tid = torch.repeat_interleave(torch.arange(t_, device="cuda"),
                                  hot * BATCH)
    rows = batch.idx.long() + torch.tensor(
        plan.padded_offsets, device="cuda")[tid]
    bag_len = torch.repeat_interleave(hot, BATCH)
    bag_off = torch.cumsum(bag_len, 0) - bag_len
    eb_ms = time_ms(lambda: F.embedding_bag(rows, emb, bag_off, mode="sum"),
                    CUDA, 10, warmup=0)
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
            0, k3_lib),
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


# ------------------------------------------------------------- phase 5
# probe kernel -> (its source, the TPU kernel it stands in for first; the
# others are in PERF.md's table)
PROBE_KERNELS = {
    "row_gather": ("dlrm_tpu_torch/csrc/probe_rows.cu",
                   "bench_scripts/scan_probe.py:86"),
    "row_scatter_add": ("dlrm_tpu_torch/csrc/probe_rows.cu",
                        "bench_scripts/pallas_probe.py:141"),
    "block_stream": ("dlrm_tpu_torch/csrc/block_stream.cu",
                     "bench_scripts/revolve_probe.py:31"),
    "k2_bisect": ("dlrm_tpu_torch/csrc/k2_bisect.cu",
                  "bench_scripts/k2_bisect.py:178"),
    "t2_contract": ("dlrm_tpu_torch/csrc/feasibility.cu",
                    "bench_scripts/kernel_feasibility.py:62"),
    "t3_reshape_add": ("dlrm_tpu_torch/csrc/feasibility.cu",
                       "bench_scripts/kernel_feasibility.py:83"),
    "t4_onehot_accumulate": ("dlrm_tpu_torch/csrc/feasibility.cu",
                             "bench_scripts/kernel_feasibility.py:99"),
    "t6_revolve_accumulate": ("dlrm_tpu_torch/csrc/feasibility.cu",
                              "bench_scripts/kernel_feasibility.py:162"),
}


def _gen(seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


def _held(name, got, want, rtol=0.0, atol=0.0):
    """got against want: bit for bit when rtol = atol = 0, else within
    them; returns the max abs difference."""
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    ok = (torch.equal(got, want) if rtol == 0 and atol == 0
          else torch.allclose(got, want, rtol=rtol, atol=atol))
    check(ok, f"{name}: kernel differs from its plain version (max abs "
          f"{err:.3e}, rtol {rtol}, atol {atol})")
    return err


def _randint(hi, shape, seed):
    return torch.randint(0, hi, shape, generator=_gen(seed), device="cuda",
                         dtype=torch.int32)


def _perm(n, seed):
    return torch.randperm(n, generator=_gen(seed), device="cuda").int()


def rows_vs_plain():
    """row_gather and row_scatter_add_: small, then P1's and P5's inputs."""
    t = torch.randn((3000, 128), generator=_gen(20), device="cuda")
    i = _randint(256, (1000,), 21)
    gather_errs = []
    for name, tab, idx in (("rows", t, i),
                           ("transposed view", t[:256].T.contiguous().T, i),
                           ("2-D idx", t, i.view(125, 8))):
        gather_errs.append(_held(f"row_gather small {name}",
                                 pk.row_gather(tab, idx),
                                 pk.row_gather_plain(tab, idx)))
    u = _perm(3000, 22)[:1200]
    delta = torch.randn((1200, 128), generator=_gen(23), device="cuda")
    scatter_errs = [_held(
        "row_scatter_add small",
        pk.row_scatter_add_(t.clone(), u, delta, check_unique=True),
        pk.row_scatter_add_plain(t.clone(), u, delta))]
    table, _, idx0, idx_sorted, _, _ = p1.inputs("cuda")
    for name, idx in (("random", idx0), ("sorted", idx_sorted)):
        gather_errs.append(_held(f"row_gather P1 {name}",
                                 pk.row_gather(table, idx),
                                 pk.row_gather_plain(table, idx)))
    gather_plain = time_ms(lambda: pk.row_gather_plain(table, idx0), CUDA,
                           3, warmup=0)
    del table
    table, _, idx_u, delta = p5.inputs("cuda")
    scatter_errs.append(_held(
        "row_scatter_add P5",
        pk.row_scatter_add_(table.clone(), idx_u, delta),
        pk.row_scatter_add_plain(table.clone(), idx_u, delta)))
    scatter_plain = time_ms(
        lambda: pk.row_scatter_add_plain(table, idx_u, delta), CUDA, 3,
        warmup=0)
    log(f"phase 5: row_gather ({len(gather_errs) - 2} small cases, P1 random "
        "and sorted) and row_scatter_add (small, P5) bit-identical to their "
        "plain versions")
    return {"row_gather": {"err": max(gather_errs), "plain_ms": gather_plain},
            "row_scatter_add": {"err": max(scatter_errs),
                                "plain_ms": scatter_plain}}


def block_stream_vs_plain():
    """block_stream on every kind of walk: small, then P4's and P2's
    shapes; bit for bit."""
    errs = []
    for nblk, br, tag in ((10, 48, "small"), (p4.NBLK, p4.BR, "P4")):
        t = torch.randn((nblk * br, 128), generator=_gen(24), device="cuda")
        perm = _perm(nblk, 25)
        kw = dict(scale=1.0, shift=1.0, block_rows=br)
        walks = (("S", None, False, 1), ("D", perm, False, 1),
                 ("M", perm, True, 1), ("N", None, True, 1),
                 ("P", None, False, 2), ("Q", None, False, 4),
                 ("D depth 4", perm[: nblk // 2], False, 4))
        for name, ib, in_place, depth in walks:
            out = None if in_place else torch.full_like(t, -7.0)
            want = pk.block_stream_plain(
                t.clone(), ib, out=None if out is None else out.clone(),
                depth=depth, **kw)
            got = pk.block_stream(t.clone(), ib, out=out, depth=depth, **kw)
            errs.append(_held(f"block_stream {tag} {name}", got, want))
            del got, want, out
    out = torch.empty_like(t)
    plain_ms = time_ms(lambda: pk.block_stream_plain(t, out=out, **kw), CUDA,
                       3, warmup=0)
    del t, out
    t = torch.randn((p2.R, 128), generator=_gen(26), device="cuda")
    kw = dict(scale=p2.SCALE, shift=p2.SHIFT, block_rows=p2.BR)
    want = pk.block_stream_plain(t.clone(), **kw)
    errs.append(_held("block_stream P2a aliased", pk.block_stream(t, **kw),
                      want))
    p2a_plain = time_ms(lambda: pk.block_stream_plain(t, **kw), CUDA, 3,
                        warmup=0)
    log(f"phase 5: block_stream bit-identical to its plain version in "
        f"{len(errs)} cases (static and data-dependent walks, in place and "
        "not, depth 1/2/4; P4's and P2a's shapes); plain version "
        f"{plain_ms:.3f} ms at P4's shape, {p2a_plain:.3f} ms at P2a's")
    return {"block_stream": {"err": max(errs), "plain_ms": plain_ms}}


def k2_bisect_vs_plain():
    """Every variant against its plain version (the sgd update within rtol
    1e-5 / atol 1e-6, the skeletons bit for bit) and the full variants
    against K2 bit for bit: phase 2's plan, the probe and the main-path
    shapes. Returns the plain version's time at the main-path shape."""
    def mid():
        plan = make_stream_plan(MID_TABLES, 128, MID_B, MID_HOTS,
                                block_rows=2048)
        hb = ragged_multihot_batch(np.random.default_rng(1), 13, MID_TABLES,
                                   MID_HOTS, MID_B)
        return plan, hb.with_stream_work(plan).stream

    err = 0.0
    for tag, make in (("mid", mid), ("probe", p3.probe_shape),
                      ("main-path", p3.main_path_shape)):
        plan, work = make()
        items = tuple(torch.from_numpy(a).cuda() for a in (
            work.rows_u, work.item_block, work.item_row0, work.item_u))
        gen = _gen(27)
        table = torch.randn((plan.padded_rows, 128), generator=gen,
                            device="cuda")
        g_u = torch.randn((plan.u_total, 128), generator=gen, device="cuda")
        args = (g_u, *items, 0.05)
        want = pk.k2_bisect_plain("V1", plan, table.clone(), *args)
        k2 = stream_update("sgd", plan, table.clone(), None, *args)[0]
        for v, sums in pk.K2_VARIANTS.items():
            got = pk.k2_bisect(v, plan, table.clone(), *args)
            if sums:
                err = max(err, _held(f"k2_bisect {tag} {v}", got, want,
                                     rtol=1e-5, atol=1e-6))
                _held(f"k2_bisect {tag} {v} against K2", got, k2)
            else:
                err = max(err, _held(f"k2_bisect {tag} {v} (skeleton)", got,
                                     table))
            del got
        log(f"phase 5: k2_bisect {tag}: V1-V6 hold (full variants max abs "
            f"{err:.3e} from the plain version, bit-identical to K2; "
            "skeletons leave the table unchanged)")
        del want, k2
    plain_ms = time_ms(lambda: pk.k2_bisect_plain("V1", plan, table, *args),
                       CUDA, 3, warmup=0)
    return {"k2_bisect": {"err": err, "plain_ms": plain_ms}}


def feasibility_vs_plain():
    """T2, T3, T4 and T6, small and at P6's sizes; at P6's sizes also the
    kernel's, the plain version's and the library call's time, the bytes
    and the operations."""
    def cases(small):
        gen = _gen(28)
        s, l, r, c = (2, 16, 32, 24) if small else (8, 128, 256, 128)
        a = torch.randn((s, l, r), generator=gen, device="cuda")
        b = torch.randn((s, l, c), generator=gen, device="cuda")
        x3 = (_randint(1000, (3, 5), 29) if small else
              torch.arange(8 * 128, dtype=torch.int32,
                           device="cuda").reshape(8, 128))
        cap, rows, d = (40, 30, 8) if small else (256, 512, 128)
        idx = _randint(rows, (cap, 1), 30)
        g = torch.randn((cap, d), generator=gen, device="cuda")
        zeros = torch.zeros((rows, d), device="cuda")
        nb, steps, br, d6 = (2, 3, 5, 8) if small else (4, 3, 256, 128)
        x6 = torch.randn((nb * steps * br, d6), generator=gen, device="cuda")
        return {
            "t2_contract": (
                lambda: pk.t2_contract(a, b),
                lambda: pk.t2_contract_plain(a, b),
                lambda: torch.einsum("slr,sld->rd", a, b), (1e-5, 1e-4),
                4 * (a.numel() + b.numel() + r * c), 2 * s * l * r * c),
            "t3_reshape_add": (
                lambda: pk.t3_reshape_add(x3),
                lambda: pk.t3_reshape_add_plain(x3),
                lambda: torch.add(x3, 1), (0, 0), 8 * x3.numel(),
                x3.numel()),
            "t4_onehot_accumulate": (
                lambda: pk.t4_onehot_accumulate(idx, g, rows),
                lambda: pk.t4_onehot_accumulate_plain(idx, g, rows),
                lambda: torch.index_add(zeros, 0, idx.view(-1), g),
                (1e-5, 1e-4), 4 * (cap + g.numel() + rows * d), g.numel()),
            "t6_revolve_accumulate": (
                lambda: pk.t6_revolve_accumulate(x6, steps, br),
                lambda: pk.t6_revolve_accumulate_plain(x6, steps, br),
                lambda: torch.sum(x6.view(nb, steps, br, d6), dim=1),
                (0, 1e-5), 4 * (x6.numel() + nb * br * d6), x6.numel()),
        }

    out = {}
    for small in (True, False):
        for name, (kern, plain, lib, (rtol, atol), nbytes,
                   nops) in cases(small).items():
            err = _held(f"{name} {'small' if small else 'P6'}", kern(),
                        plain(), rtol=rtol, atol=atol)
            if not small:
                out[name] = {"err": err, "ms": time_ms(kern, CUDA, 20, warmup=0),
                             "plain_ms": time_ms(plain, CUDA, 20, warmup=0),
                             "library_ms": time_ms(lib, CUDA, 20, warmup=0),
                             "nbytes": nbytes, "nops": nops}
    log("phase 5: t2_contract, t3_reshape_add, t4_onehot_accumulate and "
        "t6_revolve_accumulate hold against their plain versions, small and "
        "at P6's sizes (max abs " + ", ".join(
            f"{k} {v['err']:.3e}" for k, v in out.items()) + ")")
    return out


def p2b_takes():
    """P2b's two takes at their own [256, 128] shape (stream_variants.py
    t1_variants), each through row_gather: its time, its plain version's,
    the library call's (one indexing) and its bound (each gathered row read
    and written once, the index read once). Launched after the probe path's
    counts are read."""
    dly = torch.randn((256, 128), generator=_gen(31), device="cuda")
    idx = _randint(256, (8, 128), 32)
    dly_t = dly.T.contiguous()  # [128, 256]: T1v2 takes its lanes
    takes = {
        "T1v1 take 2D idx": (lambda: pk.row_gather(dly, idx),
                             lambda: pk.row_gather_plain(dly, idx),
                             lambda: dly[idx.long()], idx.numel()),
        "T1v2 take lanes": (lambda: pk.row_gather(dly_t.T, idx[0]),
                            lambda: pk.row_gather_plain(dly_t.T, idx[0]),
                            lambda: dly_t[:, idx[0].long()], idx[0].numel()),
    }
    for name, (kern, plain, lib, rows) in takes.items():
        _held(f"P2b {name}", kern(), plain())
        nbytes = 2 * rows * 128 * 4 + rows * 4
        bound_ms, _ = bound(nbytes, 0)
        log(f"  P2b {name} at [256, 128]: row_gather "
            f"{time_ms(kern, CUDA, 20):.4f} ms, plain "
            f"{time_ms(plain, CUDA, 20):.4f} ms, library "
            f"{time_ms(lib, CUDA, 20):.4f} ms, bound {bound_ms:.5f} ms by "
            f"bytes ({nbytes} B)")


def phase_probes():
    """Phase 5: the probe kernels against their plain versions, then the six
    probes' entry points (counted launches) and the card's figures."""
    held = {}
    for fn in (rows_vs_plain, block_stream_vs_plain, k2_bisect_vs_plain,
               feasibility_vs_plain):
        held.update(fn())
        torch.cuda.empty_cache()

    for k in pk.KERNELS:
        LAUNCHES[k] = 0
    log("phase 5: the probes' entry points")
    r1 = p1.main()
    r5 = p5.main()
    r2 = p2.main()
    r4 = p4.main()
    r3 = p3.main()
    r6 = p6.main()
    launches = {k: LAUNCHES[k] for k in pk.KERNELS}
    torch.cuda.empty_cache()
    log("phase 5: launches on the probe path: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    for k, v in launches.items():
        check(v > 0, f"phase 5: {k} was not launched by the probes")
    for name, status in {**r2["t1"], **r6}.items():
        check(status == "OK", f"phase 5: {name}: {status}")
    p2b_takes()

    st = r2["stream"]
    log("phase 5: figures of this card (GB/s counts each byte read and "
        "written once):")
    log(f"  copy: Tensor.copy_ {st['torch copy_ (device to device)']['gbps']:.1f}"
        f" GB/s (P2, 2.66 GB), {r4['C']['gbps']:.1f} GB/s (P4, 1 GiB); "
        f"block_stream in place {st['stream alias donate']['gbps']:.1f}, "
        f"out of place {st['stream no-alias donate']['gbps']:.1f} GB/s (P2)")
    log(f"  revolve (P4): static depth 1/2/4 {r4['S']['gbps']:.1f} / "
        f"{r4['P']['gbps']:.1f} / {r4['Q']['gbps']:.1f} GB/s; dynamic "
        f"{r4['D']['gbps']:.1f} GB/s; in place static/dynamic "
        f"{r4['N']['gbps']:.1f} / {r4['M']['gbps']:.1f} GB/s; plain loop "
        f"(X) {r4['X']['gbps']:.1f} GB/s")
    log(f"  gather: row_gather {r1['row_gather random']['ns_per_row']:.3f} "
        f"ns/row random, {r1['row_gather sorted']['ns_per_row']:.3f} sorted "
        f"(P1), {r5['row_gather']['ns_per_row']:.3f} (P5); index_select "
        f"{r1['torch index_select random fp32']['ns_per_row']:.3f}")
    log(f"  scatter-add: row_scatter_add "
        f"{r5['row_scatter_add']['ns_per_row']:.3f} ns/row, index_add_ "
        f"{r5['torch index_add_ (unique)']['ns_per_row']:.3f} ns/row (P5)")
    main3 = r3["main-path"]
    geo = main3["geometry"]
    log(f"  K2 at the main-path shape: V1 {main3['V1']['ms']:.3f} ms, revolve "
        f"floor V4 {main3['V4']['ms']:.3f} ms, {p3.LIBRARY} "
        f"{main3[p3.LIBRARY]['ms']:.3f} ms; K2 ladder "
        + ", ".join(f"{k[3:]} {main3[k]['ms']:.3f}" for k in p3.K2_LADDER)
        + " ms")

    d = 128
    timed = {
        "row_gather": (r1["row_gather random"],
                       r1["torch index_select random fp32"]["ms"], 0),
        # one add per scattered element
        "row_scatter_add": (r5["row_scatter_add"],
                            r5["torch index_add_ (unique)"]["ms"],
                            r5["row_scatter_add"]["rows"] * d),
        # a multiply and an add per element (nbytes: 8 per element)
        "block_stream": (r4["S"], r4["E"]["ms"], r4["S"]["nbytes"] // 4),
        # an add per hit element; a multiply and a subtract per touched one
        "k2_bisect": (main3["V1"], main3[p3.LIBRARY]["ms"],
                      geo["hits"] * d + 2 * geo["touched"] * d),
    }
    log("phase 5: probe kernels:")
    entries = []
    for name, (source, replaces) in PROBE_KERNELS.items():
        h = held[name]
        if name in timed:
            rec, lib_ms, nops = timed[name]
            ms, nbytes = rec["ms"], rec["nbytes"]
        else:
            ms, lib_ms, nbytes, nops = (h["ms"], h["library_ms"],
                                        h["nbytes"], h["nops"])
        entries.append(kernel_entry(name, source, replaces, launches[name],
                                    h["err"], ms, h["plain_ms"], nbytes,
                                    nops, lib_ms))
    return entries


# ------------------------------------------------------------- phase 6
# the v2 trainer (dlrm_tpu_torch/v2_main.py) at bench.py's full width
V2_TABLES = (200_000,) * 26
V2_DAY_ROWS = (98_304, 98_304, 65_536)  # 12 train batches; val, test 2 each
V2_LIMITS = {"train": 12, "val": 2, "test": 2}
V2_HOST_PASS = 4  # batches in the separate host-timing pass


STREAM_BF16 = ("--embedding_impl", "stream", "--embedding_dtype", "bfloat16")


def v2_argv(batch, limits, data_path=None, tables=V2_TABLES,
            path=STREAM_BF16):
    argv = [
        "--embedding_dim", "128",
        "--num_embeddings_per_feature", ",".join(map(str, tables)),
        "--multi_hot_sizes", ",".join(map(str, V2_HOT_SIZES)),
        "--dense_arch_layer_sizes", "512,256,128",
        "--over_arch_layer_sizes", "1024,1024,512,256,1",
        "--adagrad", *path, "--batch_size", str(batch),
        "--learning_rate", str(LR),
    ]
    for stage, n in limits.items():
        argv += [f"--limit_{stage}_batches", str(n)]
    if data_path is not None:
        argv += ["--synthetic_multi_hot_criteo_path", data_path]
    return argv


def write_v2_dataset(root, tables=V2_TABLES, tag="phase 6"):
    """Processed Criteo days (y, X_int, X_cat) drawn from a numpy seed for
    the given tables (bench.py's 26 x 200,000 rows by default), then
    materialized to the multi-hot layout by the port with V2_HOT_SIZES. The
    label follows the first dense feature, so that the evaluation has
    something to rank."""
    rng = np.random.default_rng(6)
    high = tables[0] if len(set(tables)) == 1 else np.asarray(tables)
    days = []
    for d, n in enumerate(V2_DAY_ROWS):
        x_int = rng.integers(0, 1000, (n, 13), dtype=np.int32)
        y = (rng.random(n) < x_int[:, 0] / 1000.0).astype(np.int32)
        x_cat = rng.integers(0, high, (n, 26), dtype=np.int32)
        path = os.path.join(root, f"day_{d}.npz")
        np.savez(path, y=y, X_int=x_int, X_cat=x_cat)
        days.append(path)
    out = os.path.join(root, "multi_hot")
    t0 = time.perf_counter()
    materialize_multihot_dataset(days, out, tables, V2_HOT_SIZES)
    sparse = sum(os.path.getsize(os.path.join(out, f"day_{d}_sparse.npy"))
                 for d in range(len(days)))
    log(f"{tag}: {len(days)} days of {V2_DAY_ROWS} rows materialized in "
        f"{time.perf_counter() - t0:.1f} s ({sparse / 1e6:.0f} MB of sparse "
        ".npy)")
    return out


class StepProbe:
    """Wraps the train step that `factory` of `module` builds (a v2_main
    factory by default; the harness's pick_train_step for the v1 trainer):
    CUDA events around each call on the current stream, the synchronizing
    calls each call makes on the calling thread in sync debug mode (the
    producer thread's own are not the step's), and each step's loss tensor,
    read only after the run."""

    def __init__(self, factory="make_stream_train_step", module=v2_main):
        self.spans, self.syncs, self.losses = [], [], []
        self.factory, self.module = factory, module
        self.real = getattr(module, factory)

    def __enter__(self):
        def make(*args, **kw):
            step = self.real(*args, **kw)

            def probed(params, opt_state, batch, lr):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                caught = []
                ev[0].record()
                with main_thread_syncs(caught):
                    out = step(params, opt_state, batch, lr)
                ev[1].record()
                self.spans.append(ev)
                self.syncs.append(caught)
                self.losses.append(out[2])
                return out

            return probed

        setattr(self.module, self.factory, make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.factory, self.real)


@contextlib.contextmanager
def main_thread_syncs(out):
    """Sync debug mode; each warning raised on this thread is appended to
    `out` as its first line and the innermost line of the port that made
    the call."""
    me = threading.get_ident()
    with warnings.catch_warnings():
        warnings.simplefilter("always")

        def show(message, *args, **kw):
            if threading.get_ident() == me and "prototype" not in str(message):
                port = [f for f in traceback.extract_stack()
                        if "dlrm_tpu_torch" in f.filename]
                where = (f"{port[-1].filename.split('dlrm_tpu_torch')[-1]}:"
                         f"{port[-1].lineno}" if port else "outside the port")
                out.append(f"{str(message).splitlines()[0][:60]} at {where}")

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_v2_main(tag, argv, factory="make_stream_train_step",
                per_step=("stream_update",)):
    """v2_main.main(argv) on the card with every launch count set to 0 just
    before and read just after: its printed output, the step probe (around
    the step that `factory` builds), the launch counts and the peak device
    memory. Fails unless it returns 0 with a finite final loss and val and
    test AUROC in [0, 1], each kernel of `per_step` launched once per train
    step and no other kernel launched. Returns the probe, the step count and
    the printed output."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with StepProbe(factory) as probe, contextlib.redirect_stdout(tee):
        rc = v2_main.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = tee.buf.getvalue()
    check(rc == 0, f"{tag}: v2_main.main returned {rc}")
    m = re.search(r"Epoch 0: (\d+) samples in \S+ \(([\d,]+) samples/s\), "
                  r"final loss (\S+)", out)
    check(m is not None, f"{tag}: no epoch line in the trainer's output")
    loss = float(m.group(3))
    check(math.isfinite(loss), f"{tag}: final loss {loss}")
    auroc = dict(re.findall(r"AUROC over (\w+) set: (\S+)", out))
    for stage in ("val", "test"):
        check(stage in auroc, f"{tag}: no {stage} AUROC printed")
        a = float(auroc[stage])
        check(0.0 <= a <= 1.0, f"{tag}: {stage} AUROC {a}")
    steps = len(probe.spans)
    for k in per_step:
        check(launches[k] == steps,
              f"{tag}: {k} launched {launches[k]} times in {steps} steps")
    others = {k: v for k, v in launches.items() if v and k not in per_step}
    check(not others, f"{tag}: kernels off this path launched: {others}")
    log(f"{tag}: main() returned 0 in {wall:.1f} s: {m.group(1)} samples, "
        f"{m.group(2)} samples/s as main prints it, final loss {loss:.6f}, "
        f"val AUROC {auroc['val']}, test AUROC {auroc['test']}; "
        + (", ".join(f"{k} launched {launches[k]} times" for k in per_step)
           or "no kernel of the port launched")
        + f" in {steps} train steps; max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    return probe, steps, out


def report_steps(tag, probe, steps, batch):
    """Device span per step, the spans' share of the training loop's device
    window (first step's start to last step's end; and from the second
    step, past the first step's warm-up, with the samples/s of that
    window), and the synchronizing calls per step."""
    spans = [a.elapsed_time(b) for a, b in probe.spans]
    window = probe.spans[0][0].elapsed_time(probe.spans[-1][1])
    warm = probe.spans[1][0].elapsed_time(probe.spans[-1][1])
    syncs = sorted({m for s in probe.syncs for m in s})
    n_sync = sum(len(s) for s in probe.syncs)
    per_step = [len(s) for s in probe.syncs]
    log(f"{tag}: device span per step median {float(np.median(spans)):.2f} "
        f"ms (min {min(spans):.2f}, max {max(spans):.2f}; first "
        f"{spans[0]:.2f}); the {steps} steps' spans cover "
        f"{sum(spans) / window:.1%} of the {window:.1f} ms from the first "
        f"step's start to the last one's end (steps 2-{steps}: "
        f"{sum(spans[1:]) / warm:.1%} of {warm:.1f} ms, "
        f"{(steps - 1) * batch / warm * 1e3:,.0f} samples/s)")
    log(f"{tag}: synchronizing calls per train step (sync debug mode): "
        f"{n_sync / steps:.2f} ({n_sync} in {steps} steps: {per_step}; "
        f"{len(syncs)} distinct)" + "".join(f"\n    {m}" for m in syncs))


def v2_host_pass(data_path, plan):
    """The host's time per batch by stage, in a pass of its own over the
    trainer's train loader: the padded read, the U-layout build, and the
    flat per-hit layout with its pinned H2D copies enqueued. Returns the
    first batch (host and device)."""
    ds = MultiHotCriteoDataset(data_path, BATCH, days=[0, 1])
    t = {"read": [], "build": [], "h2d": []}
    first = None
    for i in range(V2_HOST_PASS):
        t0 = time.perf_counter()
        hb = ds.read_batch(i)
        t1 = time.perf_counter()
        hb = hb.with_stream_work(plan, update_touched_only=True)
        t2 = time.perf_counter()
        batch = hb.to_device(CUDA, flat_hots=plan.hot)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        for k, a, b in (("read", t0, t1), ("build", t1, t2), ("h2d", t2, t3)):
            t[k].append((b - a) * 1e3)
        if first is None:
            first = (hb, batch)
    log(f"phase 6a: host per batch ({V2_HOST_PASS} batches, a separate pass, "
        "median): " + ", ".join(
            f"{k} {float(np.median(v)):.1f} ms" for k, v in (
                ("padded read", t["read"]), ("U-build", t["build"]),
                ("flat layout + pinned H2D enqueue", t["h2d"])))
        + f"; in all {sum(float(np.median(v)) for v in t.values()):.1f} ms")
    return first


def phase_v2_trainer(data):
    """Phase 6: the trainer from disk at full width (6a; the days written
    to `data` by write_v2_dataset), then on random data through Multihot
    (6b)."""
    t_phase = time.perf_counter()
    cfg = DLRMConfig(
        embedding_dim=128, table_sizes=V2_TABLES, mlp_bot=(13, 512, 256, 128),
        mlp_top=(1024, 1024, 512, 256, 1), interaction="dot", loss="bce",
        num_indices_per_lookup=max(V2_HOT_SIZES), compute_dtype="bfloat16")
    plan = plan_for_model(DLRMModel(cfg), BATCH, hot_sizes=V2_HOT_SIZES)
    probe, steps, _ = run_v2_main(
        "phase 6a", v2_argv(BATCH, V2_LIMITS, data))
    check(steps == V2_LIMITS["train"],
          f"phase 6a: {steps} train steps, not {V2_LIMITS['train']}")
    report_steps("phase 6a", probe, steps, BATCH)

    def to_device(hb):  # the trainer's own
        return hb.with_stream_work(
            plan, update_touched_only=True).to_device(
                CUDA, flat_hots=plan.hot)

    hb, batch = v2_host_pass(data, plan)

    # K2 on the first from-disk batch against its plain version
    sw = batch.stream
    check(sw.wts_u is not None and sw.touched_only,
          "phase 6a: the from-disk batch lacks its weights or list")
    gen = _gen(40)
    dly = torch.randn((len(V2_TABLES), BATCH, 128), generator=gen,
                      device="cuda").to(torch.bfloat16)
    g_u = gather_grads(dly, sw.vals_u, sw.wts_u, sw.w2t)
    table = (torch.randn((plan.padded_rows, 128), generator=gen,
                         device="cuda") * 0.05).to(torch.bfloat16)
    acc = torch.rand((plan.acc_rows, 128), generator=gen,
                     device="cuda") * 0.1
    args = (g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u, LR)
    kw = dict(mm_dtype=torch.bfloat16, stochastic_round=True, seed=13)
    t_k, a_k = table.clone(), acc.clone()
    stream_update("rwsadagrad", plan, t_k, a_k, *args, **kw)
    stream_update_plain("rwsadagrad", plan, table, acc, *args, **kw)
    torch.cuda.synchronize()
    compare_update("phase 6a K2, from-disk batch 0", table, t_k, acc, a_k)
    log("phase 6a: K2 on the first from-disk batch bit-identical to its "
        "plain version (table and accumulator)")
    del t_k, a_k, table, acc, g_u, dly

    # a prefetched batch against the same batch copied synchronously
    hosts = [MultiHotCriteoDataset(data, BATCH, days=[0, 1]).read_batch(i)
             for i in range(2)]
    pre = next(iter(DevicePrefetcher(hosts, to_device, device=CUDA)))
    same = [torch.equal(pre.dense, batch.dense),
            torch.equal(pre.idx, batch.idx),
            torch.equal(pre.wt, batch.wt),
            torch.equal(pre.labels, batch.labels)] + [
        torch.equal(getattr(pre.stream, k), getattr(sw, k))
        for k in ("rows_u", "vals_u", "wts_u", "w2t", "item_block",
                  "item_row0", "item_u")]
    check(all(same), f"phase 6a: a prefetched batch differs from the "
          f"synchronous copy ({same})")
    log("phase 6a: a prefetched batch (side stream) equals the same batch "
        "copied synchronously on the current stream, every tensor")
    del pre, batch, sw, hosts

    probe, steps, _ = run_v2_main(
        "phase 6b", v2_argv(1024, {"train": 3, "val": 1, "test": 1}))
    check(steps == 3, f"phase 6b: {steps} train steps, not 3")
    report_steps("phase 6b", probe, steps, 1024)
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- phase 7
# the trainer's other single-device paths: the fused step that
# --embedding_impl auto picks at the Criteo Kaggle counts (7a), the dense
# autograd step (7b), weighted pooling on the stream path (7c), the fused
# step against the dense one (7d), and the bf16 tower's one rounding (C1)
KAGGLE = tuple(CRITEO_KAGGLE_COUNTS)
DCN = ("--interaction_type", "dcn", "--dcn_num_layers", "3",
       "--dcn_low_rank_dim", "512")


def dcn_model(tables):
    """The MLPerf DLRM-v2 DCN model as the trainer builds it from DCN."""
    return DLRMModel(DLRMConfig(
        embedding_dim=128, table_sizes=tables, mlp_bot=(13, 512, 256, 128),
        mlp_top=(1024, 1024, 512, 256, 1), interaction="dcn",
        dcn=DCNConfig(3, 512), loss="bce",
        num_indices_per_lookup=max(V2_HOT_SIZES), compute_dtype="bfloat16"))


def bf16_ulps(a, b):
    """|a - b| counted in bf16 steps (adjacent bf16 numbers differ by 1)."""
    def order(x):
        v = x.view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return (order(a) - order(b)).abs()


def phase_c1_tower():
    """Each bf16 layer of the v2 dense tower (random weights, batch 16,384)
    rounds once: its output is its own fp32 sum plus the bias rounded to
    bf16, bit for bit. Against an fp32 recompute (x.float() @ w.float() +
    b, TF32 off): the two fp32 sums agree within the accumulation bound
    of the two sums (k * 2^-22 of the sum of |terms|, k * 2^-23 each; the
    tensor cores align and truncate their addends), and where they are
    bit-equal the outputs are too."""
    gen = _gen(70)
    widths = (13, 512, 256, 128)
    x = (torch.randn((BATCH, 13), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    for i, layer in enumerate(mlp.init_mlp(gen, widths, CUDA)):
        pre = mlp.matmul_f32(x, layer["w"], layer["b"])
        out = mlp.apply_mlp([layer], x)
        check(torch.equal(out, torch.relu(pre.to(torch.bfloat16))),
              f"phase 7 C1 layer {i}: not one rounding of its fp32 sum")
        w16 = layer["w"].to(torch.bfloat16).float()
        ref = x.float() @ w16 + layer["b"]
        scale = x.float().abs() @ w16.abs() + layer["b"].abs()
        rel = float(((pre - ref).abs() / scale).max())
        ref_out = torch.relu(ref.to(torch.bfloat16))
        same = pre.view(torch.int32) == ref.view(torch.int32)
        ulps = bf16_ulps(out, ref_out)
        k = widths[i]
        check(rel <= k * 2.0**-22 and not bool(ulps[same].any()),
              f"phase 7 C1 layer {i}: fp32 sums {rel:.3e} of their terms "
              f"apart (bound {k * 2.0**-22:.3e}); "
              f"{int((ulps[same] > 0).sum())} outputs differ where they agree")
        log(f"phase 7 C1: layer {widths[i]}->{widths[i + 1]}: one rounding "
            f"of its fp32 sum on every element; against the fp32 recompute "
            f"the fp32 sums within {rel:.3e} of the sum of |terms| (bound "
            f"{k * 2.0**-22:.3e}), {float(same.float().mean()):.4%} of them "
            f"bit-equal, {float((ulps == 0).float().mean()):.4%} of the "
            f"outputs bit-equal (the rest up to {int(ulps.max())} bf16 ulp, "
            "near zero)")
        x = out


def device_busy_ms(fn, n):
    """Device time a call of fn over n calls (torch.profiler, the sum of
    its kernels' times); 0.0 where the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3


def check_no_late_syncs(tag, probe):
    late = [len(s) for s in probe.syncs[1:]]
    check(not any(late), f"{tag}: synchronizing calls past the first step: "
          f"{late}")


def fused_kernels_vs_plain(data, model, launches):
    """The fused step's two kernels on the first from-disk batch of 7a's
    data and a random cotangent: each against its plain version, bit for
    bit, then its time, its plain version's, its bound and its library
    yardstick (coalesce_rows: one F.embedding_bag over the sorted hits
    with the runs as bags; row_scatter_add: one index_add_ of the touched
    rows)."""
    hb = MultiHotCriteoDataset(data, BATCH, days=[0, 1]).read_batch(0)
    batch = hb.to_device(CUDA, flat_hots=V2_HOT_SIZES)
    gen = _gen(71)
    t, d = len(KAGGLE), 128
    dly = torch.randn((BATCH * t, d), generator=gen, device="cuda") * 1e-3
    rows, bag, wt = su.hit_rows(batch.idx, batch.wt, model.offsets(CUDA),
                                BATCH, V2_HOT_SIZES)
    r_s, seg, bag_s, w_s = su.sorted_hits(rows, bag, wt)
    n, total = r_s.numel(), model.total_rows
    G, urows = su.coalesce_rows(r_s, seg, bag_s, w_s, dly, total)
    G_p, urows_p = su.coalesce_rows_plain(r_s, seg, bag_s, w_s, dly, total)
    err_c = _held("phase 7a coalesce_rows", G, G_p)
    check(torch.equal(urows, urows_p), "phase 7a coalesce_rows: rows differ")
    del G_p, urows_p
    runs = int(seg[-1]) + 1
    longest = int(torch.bincount(seg).max())
    head = torch.ones(n, dtype=torch.bool, device="cuda")
    head[1:] = r_s[1:] != r_s[:-1]
    starts = torch.nonzero(head).flatten().int()

    def library():
        return F.embedding_bag(bag_s, dly, starts, mode="sum",
                               per_sample_weights=w_s)

    split = int((torch.bincount(seg) > su.COALESCE_CHUNK).sum())
    lib_err = float((library() - G[:runs]).abs().max())
    ms = time_ms(lambda: su.coalesce_rows(r_s, seg, bag_s, w_s, dly, total),
                 CUDA, 10)
    plain_ms = time_ms(lambda: su.coalesce_rows_plain(
        r_s, seg, bag_s, w_s, dly, total), CUDA, 1)
    lib_ms = time_ms(library, CUDA, 10)
    dev_ms = device_busy_ms(
        lambda: su.coalesce_rows(r_s, seg, bag_s, w_s, dly, total), 10)
    log(f"phase 7a: coalesce_rows {ms:.4f} ms a call (events), "
        f"{dev_ms:.4f} ms of device time (profiler)")
    log(f"phase 7a: coalesce_rows on the first from-disk batch ({n} hits, "
        f"{runs} touched rows, the longest run {longest} hits, {split} runs "
        f"longer than C = {su.COALESCE_CHUNK} summed in chunks) "
        f"bit-identical to its plain version; F.embedding_bag over the same "
        f"runs within {lib_err:.3e}")
    # bytes: rows, runs, bags and weights read once, every dly row once,
    # G and the row ids written once; operations: a multiply (weights
    # present) and an add per hit element
    weighted = w_s is not None
    entries = [kernel_entry(
        "coalesce_rows", "dlrm_tpu_torch/csrc/coalesce_rows.cu",
        "dlrm_tpu/ops/sparse_update.py:87", launches, err_c, ms, plain_ms,
        (16 if weighted else 12) * n + dly.numel() * 4 + n * d * 4 + 4 * n,
        (2 if weighted else 1) * n * d, lib_ms)]

    valid = torch.arange(n, device="cuda") < runs
    delta = ((-LR * G) * valid[:, None]).contiguous()
    del G
    table = torch.randn((total, d), generator=gen, device="cuda") * 0.05
    t_k = table.clone()
    pk.row_scatter_add_(t_k, urows, delta)
    pk.row_scatter_add_plain(table, urows, delta)
    torch.cuda.synchronize()
    check(torch.equal(t_k, table),
          "phase 7a row_scatter_add: the table differs from the plain "
          "version's")
    del t_k
    log(f"phase 7a: row_scatter_add of the coalesced triple ({n} slots, "
        f"{n - runs} past the table) into the {total}-row fp32 table "
        "bit-identical to its plain version")
    uv, dv = urows[:runs].long(), delta[:runs]
    ms = time_ms(lambda: pk.row_scatter_add_(table, urows, delta), CUDA, 10)
    plain_ms = time_ms(lambda: pk.row_scatter_add_plain(table, urows, delta),
                       CUDA, 3)
    lib_ms = time_ms(lambda: table.index_add_(0, uv, dv), CUDA, 10)
    # bytes: the row ids, each touched row's delta read, its table row read
    # and written; operations: one add per touched element
    entries.append(kernel_entry(
        "row_scatter_add (fused step)", "dlrm_tpu_torch/csrc/probe_rows.cu",
        "bench_scripts/pallas_probe.py:141", launches, 0.0, ms, plain_ms,
        4 * n + 3 * runs * d * 4, runs * d, lib_ms))
    del table, delta
    return batch, entries


def long_run_hits(lengths, d, weighted, seed):
    """Sorted hits (r_s, seg, bag_s, w_s) and a [4096, d] dly on the card:
    before each run of lengths[i] hits of one row, short runs of C hits in
    all (so the first long run starts at slot C) or 37 hits (an odd
    start). Rows are below 1,000 * len(lengths)."""
    c = su.COALESCE_CHUNK
    rng = np.random.default_rng(seed)
    parts = []
    for i, length in enumerate(lengths):
        parts.append(rng.integers(1000 * i, 1000 * i + 90, 37 if i else c))
        parts.append(np.full(length, 1000 * i + 500))
    r = np.sort(np.concatenate(parts)).astype(np.int32)
    head = np.ones(r.size, bool)
    head[1:] = r[1:] != r[:-1]
    seg = (np.cumsum(head) - 1).astype(np.int32)
    bag = rng.integers(0, 4096, r.size).astype(np.int32)
    w = rng.uniform(0.5, 1.5, r.size).astype(np.float32)
    dly = rng.normal(size=(4096, d)).astype(np.float32)
    on = lambda a: torch.from_numpy(a).to(CUDA)  # noqa: E731
    return on(r), on(seg), on(bag), on(w) if weighted else None, on(dly)


def long_runs_vs_plain():
    """coalesce_rows against its plain version, bit for bit, and called
    twice for the same bits, on runs around the chunk length C (two runs
    each, one starting at a multiple of C, one at an odd slot) and on one
    run of 65,275 hits (7a's longest) and one of 262,144; d 8, 128, 256,
    512; weighted and not. Then its time on the two long runs (d = 128,
    weighted), by CUDA events and by device time, beside each call's
    bytes bound."""
    c = su.COALESCE_CHUNK
    cases = 0
    for lengths in ((c - 1,) * 2, (c,) * 2, (c + 1,) * 2,
                    (3 * c + 17,) * 2, (65_275,), (262_144,)):
        for d in (8, 128, 256, 512):
            for weighted in (True, False):
                args = long_run_hits(lengths, d, weighted, lengths[0] + d)
                total = 1000 * len(lengths)
                g1, u1 = su.coalesce_rows(*args, total)
                g2, u2 = su.coalesce_rows(*args, total)
                gp, up = su.coalesce_rows_plain(*args, total)
                tag = f"phase 7a coalesce_rows runs {lengths} d {d} " \
                      f"weighted {weighted}"
                _held(tag, g1, gp)
                check(torch.equal(g1, g2) and torch.equal(u1, u2)
                      and torch.equal(u1, up),
                      f"{tag}: two calls or the rows differ")
                cases += 1
    log(f"phase 7a: coalesce_rows bit-identical to its plain version and "
        f"to itself on a second call in {cases} cases (runs of C - 1, C, "
        f"C + 1 and 3C + 17 hits with C = {c}, and of 65,275 and 262,144; "
        f"d 8-512; weighted and not)")
    times = {}
    for length in (65_275, 262_144):
        args = long_run_hits((length,), 128, True, 7)
        call = functools.partial(su.coalesce_rows, *args, 1000)
        times[length] = (time_ms(call, CUDA, 20), device_busy_ms(call, 20))
        n = args[0].numel()
        nbytes = 16 * n + args[4].numel() * 4 + n * 128 * 4 + 4 * n
        log(f"phase 7a: coalesce_rows on one run of {length:,} hits ({n} "
            f"slots, d 128, weighted): {times[length][0]:.4f} ms a call "
            f"(CUDA events over 20 calls, the wrapper's host time included), "
            f"{times[length][1]:.4f} ms of device time a call (profiler); "
            f"bytes bound {bound(nbytes, 2 * n * 128)[0]:.4f} ms")
    (a, da), (b, db) = times[65_275], times[262_144]
    log(f"phase 7a: coalesce_rows at 262,144 hits over 65,275: {b / a:.2f}x "
        f"(events), {db / da:.2f}x (device time), for 4.02x the hits")


def same_bits_twice(model, batch):
    """Two fused steps from the same init on the same batch: every
    parameter and accumulator bit-equal. Then the step's profile."""
    outs = []
    step = make_fused_train_step(model, "rwsadagrad", eps=1e-8,
                                 hot_sizes=V2_HOT_SIZES)
    for _ in range(2):
        p = model.init_params(seed=0, device=CUDA)
        s = init_opt_state("rwsadagrad", p)
        step(p, s, batch, LR)
        outs.append(tree_leaves((p, s["accum"])))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*outs)),
          "phase 7a: a repeated fused step gives other bits")
    log(f"phase 7a: the fused step twice from the same state on the same "
        f"batch: all {len(outs[0])} parameter and accumulator tensors "
        "bit-equal")
    del outs
    profile_steps("phase 7a", step, p, s, batch)


def fused_vs_dense(data):
    """7d: one full-width batch of phase 6's data, the 7a model on its 26 x
    200,000 tables, one fused and one dense step from the same params:
    every parameter and accumulator within atol 3e-6."""
    model = dcn_model(V2_TABLES)
    hb = MultiHotCriteoDataset(data, BATCH, days=[0, 1]).read_batch(0)
    batch = hb.to_device(CUDA, flat_hots=V2_HOT_SIZES)
    outs, losses = [], []
    for make in (make_fused_train_step, make_train_step):
        p = model.init_params(seed=0, device=CUDA)
        s = init_opt_state("rwsadagrad", p)
        step = make(model, "rwsadagrad", eps=1e-8, hot_sizes=V2_HOT_SIZES)
        _, _, loss, _ = step(p, s, batch, LR)
        losses.append(float(loss))
        outs.append(tree_leaves((p, s["accum"])))
    errs = [float((a - b).abs().max()) for a, b in zip(*outs)]
    del outs
    profile_steps("phase 7d dense step", step, p, s, batch)
    check(max(errs) <= 3e-6 and math.isclose(*losses, rel_tol=1e-6),
          f"phase 7d: fused and dense steps differ (max abs {max(errs):.3e}, "
          f"losses {losses})")
    log(f"phase 7d: one full-width step, fused against dense: losses "
        f"{losses[0]:.6f} and {losses[1]:.6f}, {len(errs)} tensors within "
        f"{max(errs):.3e} (atol 3e-6)")


def phase_other_paths(root, data_v2):
    """Phase 7: C1 on the card; then 7a, the fused step at the Criteo
    Kaggle counts from its own days (a directory under `root`); 7b and 7c
    on phase 6's days `data_v2`; 7d."""
    t_phase = time.perf_counter()
    phase_c1_tower()
    kaggle = os.path.join(root, "kaggle")
    os.makedirs(kaggle)
    data = write_v2_dataset(kaggle, KAGGLE, "phase 7a")
    argv = v2_argv(BATCH, V2_LIMITS, data, tables=KAGGLE,
                   path=("--embedding_impl", "auto", *DCN))
    probe, steps, out = run_v2_main(
        "phase 7a", argv, "make_fused_train_step",
        ("coalesce_rows", "row_scatter_add"))
    check("embedding update: fused coalesce+scatter step" in out,
          "phase 7a: --embedding_impl auto did not choose the fused step")
    log(f"phase 7a: --embedding_impl auto chose the fused coalesce+scatter "
        f"step at the Criteo Kaggle counts ({sum(KAGGLE)} rows, "
        f"{sum(KAGGLE) * 128 * 4 / 1e9:.1f} GB in fp32)")
    report_steps("phase 7a", probe, steps, BATCH)
    span = float(np.median([a.elapsed_time(b) for a, b in probe.spans]))
    hits = BATCH * sum(V2_HOT_SIZES)
    log(f"phase 7a: the fused step's cost per hit: median span {span:.3f} "
        f"ms over {hits} hits a step, {span / hits * 1e6:.3f} ns a hit "
        f"(the cost model's SCATTER_S_PER_HIT: "
        f"{v2_main.SCATTER_S_PER_HIT * 1e9:.2f} ns)")
    check_no_late_syncs("phase 7a", probe)
    torch.cuda.empty_cache()
    model = dcn_model(KAGGLE)
    batch, entries = fused_kernels_vs_plain(data, model, steps)
    torch.cuda.empty_cache()
    long_runs_vs_plain()
    same_bits_twice(model, batch)
    del batch
    torch.cuda.empty_cache()

    for tag, path, factory, per_step, named in (
            ("phase 7b", ("--embedding_impl", "dense", "--interaction_type",
                          "projection"), "make_train_step", (),
             "embedding update: dense autograd step"),
            ("phase 7c", (*STREAM_BF16, "--weighted_pooling", "learned"),
             "make_stream_train_step", ("stream_update",), None)):
        probe, steps, out = run_v2_main(
            tag, v2_argv(BATCH, V2_LIMITS, data_v2, path=path), factory,
            per_step)
        check(named is None or named in out, f"{tag}: not the {factory} path")
        report_steps(tag, probe, steps, BATCH)
        check_no_late_syncs(tag, probe)
        torch.cuda.empty_cache()
    fused_vs_dense(data_v2)
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    return entries


# ------------------------------------------------------------- phase 8
# the v1 trainer (dlrm_tpu_torch/cli.py) on the reference's scripts: the
# benchmark shape (8a), the MLPerf run from Criteo-format days with a
# checkpoint and its resume (8b), QR and MD tables at the Kaggle widths
# (8c), the four golden configs (8d)
FUSED = ("coalesce_rows", "row_scatter_add")
V1_BENCH = [  # bench_scripts/dlrm_tpu_benchmark.sh at mini-batch 2,048
    "--arch-sparse-feature-size=64",
    "--arch-embedding-size=" + "-".join(["1000000"] * 8),
    "--arch-mlp-bot=512-512-64", "--arch-mlp-top=1024-1024-1024-1",
    "--data-generation=random", "--num-indices-per-lookup=100",
    "--num-indices-per-lookup-fixed=1", "--num-batches=20",
    "--print-freq=10", "--print-time", "--compute-dtype=bfloat16",
    "--mini-batch-size=2048",
]
V1_DAYS, V1_DAY_ROWS = 24, 8192
V1_BATCH = 2048
# 92 train batches of 2,048 (days 0-22); evaluations after steps 46 and 92
V1_STEPS = -(-(V1_DAYS - 1) * V1_DAY_ROWS // V1_BATCH)
V1_TEST_FREQ = V1_STEPS // 2
V1_KAGGLE = [  # bench_scripts/dlrm_criteo_kaggle.sh's widths, random data
    "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16",
    "--arch-mlp-top=512-256-1", "--data-generation=random",
    "--loss-function=bce", "--round-targets=True", "--learning-rate=0.1",
    "--mini-batch-size=128", "--num-batches=3", "--num-indices-per-lookup=10",
    "--print-time",
]
V1_TRICKS = {"qr mult": ["--qr-flag", "--qr-operation=mult"],
             "qr add": ["--qr-flag", "--qr-operation=add"],
             "qr concat": ["--qr-flag", "--qr-operation=concat"],
             "md": ["--md-flag"]}
GOLDEN = {  # test_scripts/dlrm_tpu_test.sh
    "tiny1": ["--mini-batch-size=1", "--data-size=1"],
    "tiny2": ["--mini-batch-size=2", "--data-size=4", "--nepochs=2"],
    "tiny3": ["--mini-batch-size=2", "--data-size=5", "--nepochs=3",
              "--debug-mode"],
    "tiny4": ["--mini-batch-size=2", "--data-size=6", "--loss-function=bce",
              "--round-targets=True"],
}
TRAIN_LINE = re.compile(r"Finished training it (\d+)/(\d+) of epoch (\d+), "
                        r"(\S+) ms/it, loss (\S+)")


class FusedHold:
    """Patches the fused step's two kernel wrappers, as ops/sparse_update
    calls them, to copy the inputs and results of every call; each launch
    stays the wrapper's own, so the launch counts are unchanged. hold()
    then runs each plain version on the copied inputs and fails unless its
    result equals the kernel's bit for bit."""

    def __init__(self, tag):
        self.tag = tag
        self.calls = {k: [] for k in FUSED}
        self.depth = 0  # coalesce_rows calls itself on rows padded to 4

    def __enter__(self):
        self.real = real_c, real_s = su.coalesce_rows, su.row_scatter_add_

        def coalesce(r_s, seg, bag_s, w_s, dly, total_rows):
            if self.depth:
                return real_c(r_s, seg, bag_s, w_s, dly, total_rows)
            args = [None if t is None else t.clone()
                    for t in (r_s, seg, bag_s, w_s, dly)]
            self.depth += 1
            try:
                G, urows = real_c(r_s, seg, bag_s, w_s, dly, total_rows)
            finally:
                self.depth -= 1
            self.calls["coalesce_rows"].append(
                (*args, total_rows, G.clone(), urows.clone()))
            return G, urows

        def scatter(table, idx, delta, **kw):
            before = table.clone()
            out = real_s(table, idx, delta, **kw)
            self.calls["row_scatter_add"].append(
                (before, idx.clone(), delta.clone(), table.clone()))
            return out

        su.coalesce_rows, su.row_scatter_add_ = coalesce, scatter
        return self

    def __exit__(self, *exc):
        su.coalesce_rows, su.row_scatter_add_ = self.real

    def hold(self):
        for k in FUSED:
            check(self.calls[k], f"{self.tag}: no call of {k} copied")
        shapes = []
        for r_s, seg, bag_s, w_s, dly, total, G, urows in \
                self.calls["coalesce_rows"]:
            G_p, urows_p = su.coalesce_rows_plain(r_s, seg, bag_s, w_s, dly,
                                                  total)
            check(torch.equal(G, G_p) and torch.equal(urows, urows_p),
                  f"{self.tag} coalesce_rows: {r_s.numel()} hits at d "
                  f"{dly.shape[1]} differ from the plain version "
                  f"(max abs {float((G - G_p).abs().max()):.3e})")
            shapes.append(f"{r_s.numel()} hits"
                          + ("" if w_s is None else " weighted")
                          + f" d {dly.shape[1]}")
        for before, idx, delta, after in self.calls["row_scatter_add"]:
            pk.row_scatter_add_plain(before, idx, delta)
            check(torch.equal(before, after),
                  f"{self.tag} row_scatter_add: {idx.numel()} slots into "
                  f"{tuple(after.shape)} differ from the plain version")
        sc = self.calls["row_scatter_add"][0]
        log(f"{self.tag}: {len(shapes)} coalesce_rows calls "
            f"({', '.join(sorted(set(shapes)))}) and "
            f"{len(self.calls['row_scatter_add'])} row_scatter_add calls "
            f"(the first {sc[1].numel()} slots into a {tuple(sc[3].shape)} "
            "fp32 table) bit-identical to their plain versions on the same "
            "inputs")


def run_cli(tag, argv, per_step=FUSED, quiet=False, hold=None):
    """cli.main(argv) on the card with every launch count set to 0 just
    before and read just after, the harness's train step probed. Fails
    unless it returns 0 with finite losses, each kernel of `per_step`
    launched once per train step and no other kernel launched. Returns the
    probe, the printed output, the launch counts and the losses (fp32, on
    the host). With `hold` (a FusedHold), its copies are held to the plain
    versions after the run."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout) if not quiet else Tee(io.StringIO())
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with StepProbe("pick_train_step", harness) as probe, \
            hold or contextlib.nullcontext(), \
            contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = tee.buf.getvalue()
    check(rc == 0, f"{tag}: cli.main returned {rc}")
    steps = len(probe.spans)
    check(steps > 0, f"{tag}: no train step ran")
    losses = torch.stack(probe.losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"{tag}: non-finite loss")
    for k in per_step:
        check(launches[k] == steps,
              f"{tag}: {k} launched {launches[k]} times in {steps} steps")
    others = {k: v for k, v in launches.items() if v and k not in per_step}
    check(not others, f"{tag}: kernels off this path launched: {others}")
    log(f"{tag}: main() returned 0 in {wall:.1f} s: {steps} train steps, "
        f"last loss {float(losses[-1]):.6f}; "
        + (", ".join(f"{k} launched {launches[k]} times" for k in per_step)
           or "no kernel of the port launched")
        + f"; max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    if hold is not None:
        hold.hold()
    return probe, out, launches, losses


def v1_bench():
    """8a: the reference benchmark's shape through cli.main, 20 steps; the
    harness's ms/it, each step's device span and syncs, both fused-step
    kernels once per step, and the host's draw of one batch timed apart."""
    tag = "phase 8a"
    probe, out, launches, _ = run_cli(tag, V1_BENCH)
    ms_it = [float(m[3]) for m in TRAIN_LINE.findall(out)]
    check(len(ms_it) == 2 and all(x > 0 for x in ms_it),
          f"{tag}: expected two ms/it lines, got {ms_it}")
    log(f"{tag}: the harness's ms/it over steps 1-10 and 11-20: "
        f"{ms_it[0]:.2f}, {ms_it[1]:.2f} (host time around each step call)")
    report_steps(tag, probe, len(probe.spans), 2048)
    check_no_late_syncs(tag, probe)
    model_cfg, train_cfg = cli.configs_from_args(
        cli.build_parser().parse_args(V1_BENCH))
    ds = RandomDataset(model_cfg, train_cfg)
    ds[0]
    t0 = time.perf_counter()
    hb = ds[1]
    draw_ms = (time.perf_counter() - t0) * 1e3
    spans = [a.elapsed_time(b) for a, b in probe.spans]
    span = float(np.median(spans))
    log(f"{tag}: the host draws one batch ({hb.idx.size} slots, "
        f"{int((hb.wt > 0).sum())} real hits; the reference's per-sample "
        f"draw loop) in {draw_ms:.1f} ms against a median device span of "
        f"{span:.2f} ms ({draw_ms / span:.1f}x)")
    # where the device time goes: the trainer's step on that batch
    model = DLRMModel(model_cfg)
    params = model.init_params(seed=0, device=CUDA)
    opt_state = init_opt_state(train_cfg.optimizer, params)
    step = harness.pick_train_step(model, train_cfg)
    batch = hb.to_device(CUDA)
    with FusedHold(f"{tag} (one step on batch 1, after the run)") as fh:
        step(params, opt_state, batch, LR)
    fh.hold()
    del fh
    profile_steps(tag, step, params, opt_state, batch)
    return {tag: launches}


def write_raw_days(root):
    """V1_DAYS Criteo-format raw tsv days of V1_DAY_ROWS rows (label, 13
    ints, 26 hex) from a numpy seed, with the planted signal of
    scripts/mlperf_proxy_run.py::generate_raw_days: the label is
    Bernoulli(sigmoid(s)), s mixing a linear function of log1p(dense) with
    per-value effects of the first two categorical columns."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1.0, 13)
    eff0, eff1 = rng.normal(0, 1.2, 40), rng.normal(0, 1.2, 40)
    for d in range(V1_DAYS):
        rng = np.random.default_rng(1000 + d)
        n = V1_DAY_ROWS
        dense = rng.integers(0, 200, size=(n, 13))
        z = (np.log1p(dense) - 3.7) @ w / np.sqrt(13)
        c0, c1 = rng.integers(0, 40, n), rng.integers(0, 40, n)
        other = rng.integers(0, 1 << 20, size=(n, 24))
        s = 1.5 * z + eff0[c0] + eff1[c1]
        label = (rng.random(n) < 1.0 / (1.0 + np.exp(-s))).astype(int)
        cats = np.concatenate([c0[:, None], c1[:, None], other], axis=1)
        with open(os.path.join(root, f"day_{d}"), "w") as f:
            for i in range(n):
                f.write(f"{label[i]}\t" + "\t".join(map(str, dense[i]))
                        + "\t" + "\t".join(format(v, "x") for v in cats[i])
                        + "\n")


def v1_mlperf_argv(root, extra=()):
    """bench_scripts/run_and_time.sh on `root`'s days: every printed loss
    per step, an evaluation every V1_TEST_FREQ steps, and an AUC threshold
    of 1.0 (unreachable), so that the run evaluates twice and ends with
    RUN_STOP aborted."""
    return [
        "--arch-sparse-feature-size=128", "--arch-mlp-bot=13-512-256-128",
        "--arch-mlp-top=1024-1024-512-256-1", "--max-ind-range=40000000",
        "--data-generation=dataset", "--data-set=terabyte",
        f"--raw-data-file={root}/day",
        f"--processed-data-file={root}/proc/ready",
        "--loss-function=bce", "--round-targets=True", "--learning-rate=1.0",
        f"--mini-batch-size={V1_BATCH}", "--print-freq=1", "--print-time",
        f"--test-freq={V1_TEST_FREQ}", "--test-mini-batch-size=16384",
        "--mlperf-logging", "--mlperf-auc-threshold=1.0",
        "--mlperf-bin-loader", *extra,
    ]


def mlperf_events(out):
    return [json.loads(line.split(":::MLLOG ", 1)[1])
            for line in out.splitlines() if line.startswith(":::MLLOG")]


def v1_mlperf(tmp):
    """8b: the MLPerf v1 run through cli.main: the days drawn, preprocessed
    (the port's g++ parser), binned and read by CriteoBinFile; 92 steps
    with two evaluations and a --save-model checkpoint at each new best;
    then a --load-model run from the first evaluation's checkpoint, whose
    losses for the steps after it must equal the first run's bit for
    bit."""
    tag = "phase 8b"
    root = os.path.join(tmp, "v1_mlperf")
    os.makedirs(root)
    t0 = time.perf_counter()
    write_raw_days(root)
    log(f"{tag}: {V1_DAYS} raw days of {V1_DAY_ROWS} rows drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    ck = os.path.join(root, "ckpt")
    saves = []
    real_save = harness.Trainer.save

    def save(self, state, path):  # keep each save's directory apart
        real_save(self, state, path)
        snap = f"{path}_{state.total_iter}"
        shutil.copytree(path, snap)
        saves.append((state.total_iter, snap))

    harness.Trainer.save = save
    try:
        probe, out, launches, losses = run_cli(
            tag, v1_mlperf_argv(root, [f"--save-model={ck}"]), quiet=True)
    finally:
        harness.Trainer.save = real_save
    parsers = set(re.findall(r"criteo: parsed \S+ with the (\w+) parser",
                             out))
    check(parsers == {"native"}, f"{tag}: parsers {parsers}, not native")
    steps, half = len(probe.spans), V1_TEST_FREQ
    check(steps == V1_STEPS, f"{tag}: {steps} train steps, not {V1_STEPS}")
    aucs = re.findall(rf"Testing at - (\d+)/{steps} of epoch 0, accuracy "
                      r"(\S+) %, best \S+ %, auc (\S+), best auc (\S+)", out)
    check([int(a[0]) for a in aucs] == [half, steps],
          f"{tag}: evaluations {aucs}, not after steps {half} and {steps}")
    keys = [e["key"] for e in mlperf_events(out)]
    check(keys[:4] == ["cache_clear", "init_start", "init_stop", "run_start"]
          and keys.count("eval_accuracy") == 2 and keys[-1] == "run_stop",
          f"{tag}: MLPerf events {keys}")
    check(saves and saves[0][0] == V1_TEST_FREQ,
          f"{tag}: no checkpoint at the first evaluation ({saves})")
    log(f"{tag}: the {V1_DAYS} days parsed by the native parser")
    shown = ("Testing at", "Saved model", f"Finished training it {half}/",
             f"Finished training it {steps}/")
    for line in out.splitlines():
        if line.startswith(shown):
            log(f"{tag}: | {line}")
    events = mlperf_events(out)
    log(f"{tag}: {len(keys)} MLPerf events: " + " ".join(keys))
    log(f"{tag}: | :::MLLOG {json.dumps(events[-1])}")
    log(f"{tag}: checkpoints saved after steps {[s[0] for s in saves]}")
    report_steps(tag, probe, steps, V1_BATCH)
    check_no_late_syncs(tag, probe)

    probe2, out2, launches2, losses2 = run_cli(
        f"{tag} resumed", v1_mlperf_argv(root, [f"--load-model={saves[0][1]}"]),
        quiet=True)
    check(f"Loaded model from {saves[0][1]}: epoch 0 iteration {half}"
          in out2, f"{tag}: the resumed run did not load the checkpoint")
    first = {m[0]: m[4] for m in TRAIN_LINE.findall(out)}
    second = {m[0]: m[4] for m in TRAIN_LINE.findall(out2)}
    after = [str(i) for i in range(half + 1, steps + 1)]
    check(sorted(second, key=int) == after,
          f"{tag}: the resumed run printed iterations {sorted(second)}")
    check([first[i] for i in after] == [second[i] for i in after]
          and torch.equal(losses[half:], losses2),
          f"{tag}: the resumed run's losses differ from the uninterrupted "
          "run's")
    log(f"{tag}: resumed from the checkpoint of step {half}: the losses of "
        f"steps {half + 1}-{steps} equal the uninterrupted run's bit for "
        f"bit (printed and as fp32 tensors; last {float(losses2[-1]):.6f})")
    return {tag: launches, f"{tag} resumed": launches2}


def cpu_card_agree(tag, argv):
    """The trainer's 3 steps from one init, on the card and on the CPU:
    losses within rtol 1e-5, every parameter within rtol 1e-4 / atol 1e-5
    (the CPU tests' value and gradient tolerances)."""
    model_cfg, train_cfg = cli.configs_from_args(
        cli.build_parser().parse_args(argv))
    model = DLRMModel(model_cfg)
    runs = {}
    init = None
    for dev in ("cpu", "cuda"):
        trainer = harness.Trainer(model, train_cfg,
                                  RandomDataset(model_cfg, train_cfg),
                                  device=dev)
        if init is None:  # the CPU's init, copied before a step moves it
            init = tree_map(torch.clone, trainer.init_state().params)
        params = tree_map(lambda t: t.clone().to(trainer.device), init)
        state = harness.TrainState(params, init_opt_state(
            train_cfg.optimizer, params))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = trainer.train(state)
        runs[dev] = ([float(m[4]) for m in TRAIN_LINE.findall(
            buf.getvalue())], tree_leaves(state.params))
    (l_c, p_c), (l_g, p_g) = runs["cpu"], runs["cuda"]
    check(len(l_c) == 3 and np.allclose(l_g, l_c, rtol=1e-5, atol=0),
          f"{tag}: losses on the card {l_g} and the CPU {l_c}")
    errs = [float(((g.cpu() - c).abs() - 1e-4 * c.abs()).max())
            for g, c in zip(p_g, p_c)]
    check(max(errs) <= 1e-5, f"{tag}: parameters differ beyond rtol 1e-4 "
          f"+ atol 1e-5 ({max(errs):.3e})")
    return l_g, l_c, max(float((g.cpu() - c).abs().max())
                         for g, c in zip(p_g, p_c))


def v1_tricks():
    """8c: QR (mult, add, concat) and MD tables at the Criteo Kaggle counts
    and widths, 3 dense steps each on the card with finite losses and no
    synchronizing call past the first step; then each on tables of at most
    100,000 rows, the card against the CPU."""
    tag = "phase 8c"
    counts = "--arch-embedding-size=" + "-".join(map(str, KAGGLE))
    capped = "--arch-embedding-size=" + "-".join(
        str(min(n, 100_000)) for n in KAGGLE)
    for name, extra in V1_TRICKS.items():
        t = f"{tag} {name}"
        probe, out, _, losses = run_cli(t, V1_KAGGLE + [counts, *extra], ())
        check(len(probe.spans) == 3, f"{t}: {len(probe.spans)} steps")
        check_no_late_syncs(t, probe)
        spans = [a.elapsed_time(b) for a, b in probe.spans]
        log(f"{t}: {sum(KAGGLE)} rows; losses "
            + " ".join(f"{x:.6f}" for x in losses.tolist())
            + f"; device span per step {' '.join(f'{x:.2f}' for x in spans)}"
            f" ms; synchronizing calls past the first step: 0")
        l_g, l_c, err = cpu_card_agree(t, V1_KAGGLE + [capped, *extra])
        log(f"{t}: on tables of at most 100,000 rows, 3 steps on the card "
            f"and on the CPU: losses {' '.join(f'{x:.6f}' for x in l_g)} "
            f"and {' '.join(f'{x:.6f}' for x in l_c)}, parameters within "
            f"{err:.3e}")


def v1_goldens():
    """8d: the four golden configs of test_scripts/dlrm_tpu_test.sh through
    cli.main on the card (TF32 off): every loss line within 5e-6 of the
    golden log."""
    counts = {}
    here = os.path.dirname(os.path.abspath(__file__))
    for name, argv in GOLDEN.items():
        tag = f"phase 8d {name}"
        _, out, launches, _ = run_cli(tag, argv, quiet=True,
                                      hold=FusedHold(f"{tag} (every step)"))
        with open(os.path.join(here, "test_scripts", "golden",
                               f"{name}.log")) as f:
            want = [float(x) for x in re.findall(r"loss (\d+\.\d+)", f.read())]
        got = [float(x) for x in re.findall(r"loss (\d+\.\d+)", out)]
        err = max(abs(a - b) for a, b in zip(got, want))
        check(len(got) == len(want) and err <= 5e-6,
              f"phase 8d {name}: losses {got}, golden {want}")
        log(f"phase 8d {name}: {len(got)} loss lines within {err:.1e} of "
            "the golden log (limit 5e-6)")
        counts[tag] = launches
    return counts


def phase_v1_trainer(tmp):
    """Phase 8: 8a-8d; returns each fused-step run's launches of
    coalesce_rows and row_scatter_add, by run ("8a", "8b", ...), each read
    just after its own reset to 0."""
    t_phase = time.perf_counter()
    counts = {**v1_bench(), **v1_mlperf(tmp)}
    v1_tricks()
    counts.update(v1_goldens())
    counts = {tag.removeprefix("phase "): {k: c[k] for k in FUSED}
              for tag, c in counts.items()}
    log("phase 8: launches of (coalesce_rows, row_scatter_add) by run, once "
        "per fused step: " + ", ".join(
            f"{t} ({c['coalesce_rows']}, {c['row_scatter_add']})"
            for t, c in counts.items())
        + f"; {time.perf_counter() - t_phase:.1f} s")
    return counts


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
        probes = phase_probes()
        root = os.path.dirname(os.path.abspath(__file__))
        with tempfile.TemporaryDirectory(prefix=".smoke_data_",
                                         dir=root) as tmp:
            data_v2 = write_v2_dataset(tmp)
            phase_v2_trainer(data_v2)
            fused = phase_other_paths(tmp, data_v2)
            v1 = phase_v1_trainer(tmp)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for entry in fused:  # launches: phase 7a's; by path: 7a's and phase 8's
        name = entry["name"].split(" ")[0]
        entry["launches_by_path"] = {
            "7a": entry["launches"], **{t: c[name] for t, c in v1.items()}}
    kernels = [new["window_grads"], k2, new["stream_rows"],
               new["window_pool"], *probes, *fused]
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
