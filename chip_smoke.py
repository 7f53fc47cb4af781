"""On-card smoke of the PyTorch/H100 port (dlrm_tpu_torch): builds its
kernels, holds each against its plain version, and drives the port's two
paths of the single-device DLRM-v2 streamed train step at the full width of
bench.py's configuration: the gather path (K2) and the streamed-forward,
one-hot-grads path (K3, K4, K1 and K2); then the probes, the DLRM-v2
trainer (v2_main.main) from disk and on random data, and the trainer's
other single-device paths: the fused coalesce+scatter step (coalesce_rows
and row_scatter_add) that --embedding_impl auto picks on large tables, the
dense autograd step, and weighted pooling on the stream path; then the v1
trainer (cli.main) on the reference's scripts; then the sharded stream path
over several ranks (K2 on every shard), and the fused butterfly over several
ranks (coalesce_rows and row_scatter_add on every shard) behind both
trainers; then serving: quantized inference on one card and over the
ranks, and the forward's export; then the tools, scripts and entry
points (the flagship forward, the multi-rank dry run, the MLPerf proxy, the
shell scripts' twins, visualize and the launcher); then GspmdDLRM's
row-sharded training of plain, QR and v_w models over several ranks.

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
     a skewed batch with one row of 20,480 hits and, at batch 16,384 on the
     touched-only list, one row of 262,144 hits as in the pareto cell (K2
     timed on both and on the plain batch); on the full, touched-only and
     long-run lists also with G_u in bf16 (the step's g_dtype). 81 cases.
  2b. K1, K3 and K4 against their plain versions, bit for bit, on the same
     plan and the full item list, each with its intermediate (G_u, R_u) in
     fp32 and in bf16: K1 with mm_dtype fp32 / bf16, unit / random weights
     and an fp32 or bf16 dly, K3 with fp32 / bf16 tables and mm_dtype, K4
     as K1 and on its edge cases (30 % weight-0 slots, a budgeted table
     whose weight-0 hits are dropped from U, leaving bags with no slot, bags
     hitting one row twice), each K4 case called twice with the same bits;
     K3 also on a plan whose first block's 128-slot run makes its 256-slot
     item overrun into the next block's run; gather_grads at bf16 its fp32
     result rounded once. 44 cases. Then the host's us to enqueue a call of
     K1-K4 and of the parts of a launch (host_us).
  3. the gather path at full width: 26 tables x 200,000 rows, d = 128, the
     ragged v2 hot sizes (214 hits/sample), batch 16,384, MLPs 13-512-256-128
     and 479-1024-1024-512-256-1, dot interaction, BCE, bf16 compute, bf16
     tables with stochastic rounding, rwsadagrad, block_rows 2048, flat
     layout, unit weights, touched-only items, fwd_impl="gather" and
     grad_impl="gather". A fresh host batch per step (ragged_multihot_batch,
     the native builder, pinned H2D); 3 warm-up and 20 timed steps; K2's
     own time, its plain version's and its bound at this shape; one
     full-width K2 step against its plain version, bit for bit; one step
     with g_dtype=bf16 from the same state on the same batch as an fp32-G_u
     step, bit for bit (dly is bf16 here and the weights 1); the eval step
     on one batch.
  4. the kernel path at full width: the same model and batch with
     fwd_impl="stream" (K3 then K4) and grad_impl="onehot" (K1) on the full
     item list (so K2 runs on it too); 3 warm-up and 20 timed steps, each
     kernel launched once per step; the profile; one full-width K1, K3,
     K4 (twice) and K2 (full list) call against its plain version, bit for
     bit; each kernel's time, its plain version's and its bound from this
     run's data, K2's on the full list, and the library
     yardsticks (K1 against one F.embedding_bag with one index a bag and
     the slot weights as per_sample_weights, in fp32 and in bf16, over a
     contiguous copy of dly; K3 against one index_select of the slots'
     rows, K4 against one index_add_, K3+K4 against one F.embedding_bag,
     gather_grads beside K1). Then the same 23 steps with g_dtype=bf16
     (G_u and R_u in bf16) from the same start on the same batches, which
     must give the fp32 set's losses and params bit for bit (mm_dtype is
     bf16, so no rounding changes), its launches, profile and device span
     beside the fp32 set's; the same full-width calls with bf16 G_u and
     R_u against their plain versions, bit for bit, timed, and their bounds
     at 2 B an intermediate element (each K1-K4 entry's g_bf16 record;
     K2's on the full list, its fp32 figures beside them).
  5. the probes (dlrm_tpu_torch/probes/, the port of bench_scripts/'s
     Pallas probes P1-P6): each probe kernel against its plain version at a
     small size and at its probe's own size (row_gather, row_scatter_add,
     block_stream, t3_reshape_add, t6_revolve_accumulate and the k2_bisect
     skeletons bit-identical; k2_bisect V1/V2/V5/V6 bit-identical to the
     plain sgd update and to K2;
     t4_onehot_accumulate bit-identical to its plain version on CPU copies,
     also with indices outside [0, rows), which both drop; t2_contract rtol
     1e-5 / atol 1e-4); T2-T6 and P2b's takes timed three ways beside their
     library calls (CUDA events around 20 calls; the card's us a call from
     100 calls in one CUDA graph; the host's us to enqueue a call behind a
     sleeping card); T3 and T6 also at a size past the L2 (T3_SCALE,
     T6_SCALE), T2 at K 16,384 (T2_SCALE) and T4 at cap 4,096 into 4,096
     rows (T4_SCALE): T3, T6 and T4 bit for bit against their plain
     versions, T2 within twice the plain version's error against an fp64
     product (plus 1e-5), their library calls beside them, with their share
     of the bound; then every
     launch count set to 0, the six probes' main() at their own sizes (K2's
     bisection also at the main-path shape, with one index_add_ as V1's
     library call and K2 itself on a ladder of configurations from V1's sgd
     on fp32 to the train step's rwsadagrad on bf16), the counts read, and
     the card's copy, revolve, gather and scatter figures and each probe
     kernel's time, plain time, bound and library yardstick.
     `python3 chip_smoke.py --device-times` builds and runs only phase 5's
     timings of T2-T6 and P2b, phase 2b's host us of K1-K4's launch path
     and the stream probes by CUDA events (P2a in place against copy_,
     P4's S, D, M, N, P, Q against t + 1 and copy_, P3's V1-V6 with
     index_add_ and K2's ladder at the main-path shape), with their
     checks; it prints no "ok" line.
     `python3 chip_smoke.py --k1` builds and runs only K1 on phase 4's
     work with G_u in fp32 and bf16, against its plain version and on dly
     cast to bf16 first (the same bits), then times K1, the cast with K1,
     gather_grads and K1's library call in three rounds (a K1 A/B of two
     trees in about 15 s each after the build); it prints no "ok" line.
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
  9. the DLRM-v2 trainer's sharded stream path (parallel/stream_butterfly.py)
     over W ranks, each a process of its own: NCCL over min(cards, 4)
     ranks, one card each, or, on one card, 2 ranks sharing it over gloo
     with every collective staged through host memory (printed on its own
     line with the card count). (a) bench.py's model on a data 1 x model W
     grid in three plans: table-wise only, striped (on 2 shards every one
     of the 26 equal tables: a capacity budget stripes them all or none),
     striped with the shared owner-bucket segment. In each: 2 steps with
     fp32 tables and an fp32 tower from init_params(seed=0) against the
     single-card stream step on the same global batches: with SGD at lr
     1.0 the losses within rtol 1e-5, every rank's table rows within rtol
     1e-5 / atol 1e-6 and its dense params within rtol 1e-4 / atol 1e-5
     (the port's step tests'; their grads sum the batch in another order);
     with rwsadagrad at lr 0.001 the
     losses within rtol 1e-5 and the tables' and dense params' differences
     reported (element-wise Adagrad turns a gradient's rounding into a
     whole lr step); then 2 steps
     with bf16 tables and stochastic rounding: finite losses, the same on
     every rank, K2 launched once per step on every rank and nothing else,
     each rank's span per step (CUDA events), synchronizing calls past the
     first step (0 under NCCL; the staged copies under gloo), shard_batch's
     host ms per batch and peak memory; K2's first call on every rank in
     both runs bit-identical to its plain version. (b) v2_main.main
     --sharded --rw_bucket shared over the W ranks on phase 6's days (2
     steps and 1 + 1 eval batches: its shared bucketing costs each host
     about 6.4 s a batch), with
     an --hbm_gb just under the per-shard load (and
     --allow_capacity_overflow: on 2 shards no plan meets it, so every
     table stripes): the plan line, rank 0's samples/s and AUROCs in
     [0, 1], K2 once per step on every rank, only rank 0 printing.
  10. the fused butterfly (parallel/butterfly.py) over the same W ranks:
     (a) bench.py's model on a data 1 x model W grid in three plans
     (table-wise; table-wise with tables 0 and 1 column-wise; every table
     striped, with per-table owner bucketing): 3 fp32 SGD steps (lr 1.0)
     against the single-card fused step on the same batches (losses rtol
     1e-5, each rank's table rows rtol 1e-5 / atol 1e-6, dense params rtol
     1e-4 / atol 1e-5), then 3 rwsadagrad steps with the bf16 tower
     (finite losses equal on every rank, both fused kernels once per step
     on every rank, twice with column-wise tables, spans, syncs,
     shard_batch's host ms, peak); the first calls of coalesce_rows and
     row_scatter_add on every rank of every run bit-identical to their
     plain versions. (b) 4 ranks, data 2 x model 2, batch 2,048, the
     column-wise plan: 3 fp32 SGD steps (lr 0.125, scaled with the batch
     so that a hit moves its row as much as in (a)) against the single
     card, within (a)'s tolerances, so the all-gathers over "data" run;
     reported beside it (ROADMAP C2): lr 1.0 on the 2 x 2 and 1 x 2 grids
     with the dense gap after each step, and the single card against
     itself with each batch's rows reordered (an order-only change of
     every sum), after each step, at lr 1.0 and 0.125. (c) v2_main.main --sharded
     --embedding_impl fused --column_wise_tables 0,1 on phase 6's days, 4
     steps and 1 + 1 eval batches: the plan line, rank 0's samples/s,
     AUROCs in [0, 1]. (d) cli.main --sharded at 8a's widths for 10 steps,
     evaluating after steps 5 and 10 through the histogram summed over the
     ranks, with a per-shard checkpoint; a --load-model run from step 5's
     checkpoint gives the same losses bit for bit; then
     --mlperf-grad-accum-iter 2 for 4 steps.
  11. serving (ATen work: no kernel of the port launches; every launch
     count must stay 0). (a) probes/infer_bench.py at bench.py's widths,
     batch 8,192, 8 hits a bag: fp32, bf16, int8, int4 and int4 group-16
     tables, int8 tables with int8 and with bf16 towers, each timed (CUDA
     events over 20 forwards, the batch rotated before each: ms a batch,
     examples/s, the forward's peak memory) and held: on 1,024 rows the
     card's forward against the CPU's (a quantized table's pooled rows bit
     for bit, probabilities within 1e-2 through the bf16 tower), a
     quantized table against its dequantized fp32 table on the card
     (pooled rtol 1e-5 / atol 1e-7, probabilities 1e-3) and its first
     100,000 packed rows against the numpy quantize_table's bytes,
     group-16 equal to rowwise int4, every int8 product's int32 sums equal
     to the CPU's.
     (b) probes/serve_flagship.py: the uncapped Criteo 1TB counts
     (204,184,588 rows) from int4 rowwise (14.70 GB), int4 group-16 and
     int8 rowwise (27.77 GB) tables filled on the card one at a time, batch
     8,192 with the MLPerf hot sizes: ms a batch, examples/s, peak. (c)
     cli.main --inference-only at 8a's widths (fp32 compute, 4 batches)
     with emb 8 + mlp 8, emb 4 + mlp 16 and emb 4 group-16 + mlp 16:
     group-16's accuracy line equal to rowwise's; each again with the tables capped at
     100,000 rows on the card and on the CPU, probabilities within rtol
     1e-4 / atol 1e-5 (1e-2 through the int8 and bf16 towers). (d) cli
     --sharded quantized serving over the ranks (as phase 9's), the tables capped:
     the single card's accuracy line. (e) --save-onnx after a train step
     and after quantized serving, each archive loaded back equal to the
     eager forward bit for bit; --plot-compute-graph's file.
  12. the tools, scripts and entry points (dlrm_tpu_torch/
     graft_entry.py, scripts/, tools/visualize.py), each subprocess run
     with DLRM_TORCH_LAUNCHES_TO so that its processes report their kernel
     launches. (a) graft_entry.entry()'s flagship forward at full width (26
     x 200,000 x 128 fp32 tables, batch 1,024, 8 hits a bag, bf16 compute):
     ms a forward (CUDA events), peak memory, and the same params' forward
     on the CPU within 1e-2 (the bf16 tower). (b) dryrun_multichip(4): the
     ten legs of __graft_entry__.py's dry run, one step each on 4 ranks
     (NCCL on 4 cards, else 4 ranks sharing the card over staged gloo), K2
     on the streamed legs and both fused kernels on the fused ones; each
     leg's loss, and a butterfly leg's loss after its step, within atol
     2e-3 of the same dry run on 4 CPU ranks, but v2_main's, whose init is
     drawn on the card. (c) python -m
     dlrm_tpu_torch.scripts.mlperf_proxy_run on 24 generated days of 800
     rows: v1 (fused step) stops on AUC 0.70 with a compliant log, checked
     again here and through the checker's CLI; v2 (DCN, streamed bf16
     tables, K2) stops on AUROC 0.70; v1 again on the CPU over the same
     bins, its first printed loss within atol 1e-4 and its first AUC within
     1e-3 of the card's, every printed loss and AUC of both printed. (d) the golden test's twin,
     dlrm_tpu_torch/scripts/dlrm_tpu_test.sh: four configs on the card,
     each log within 5e-6 of its golden. (e) the preprocessing twin,
     process_criteo_1tb.sh, on 12c's raw days: bins and counts equal to
     12c's byte for byte. (f) visualize.representations of 4,096 rows on
     the card against the CPU from one checkpoint (rtol 1e-4 / atol 1e-5);
     the plotting half is host-only and not run, which is printed. (g)
     python -m dlrm_tpu_torch.scripts.launch --nproc <cards> -m
     dlrm_tpu_torch.cli -- ... --sharded: exit code 0, its losses, both
     fused kernels once per step on every rank. (b)'s CPU run is a
     subprocess beside (a) and (b), (d) and (g) beside (c), (e) and (c)'s
     CPU run beside (f). `python3 chip_smoke.py
     --tools` builds and runs phase 12 alone; it prints no "ok" line.
  13. GspmdDLRM's training half (parallel/gspmd.py: every row-shardable
     leaf split by rows over the ranks, the model's own step with its
     lookups through parallel/row_sharded.py) on 2 ranks (NCCL on 2 cards,
     else 2 ranks sharing the card over staged gloo), at bench.py's widths
     (26 tables, d = 128, MLPs 13-512-256-128 and 479-1024-1024-512-256-1,
     dot, BCE, the v2 hot sizes) cut to 20,000 rows a table and batch
     2,048, fp32 tower, rwsadagrad at lr 1e-3, 3 steps in each of three
     variants: plain tables (flat per-hit layout), QR tables (4
     collisions, mult; padded layout) and learned v_w (flat), from one
     init drawn on the card. Each step against train/step.py's dense step
     on the card from the ranks' state before it (the init before the
     first) on the same global batch taken in the ranks' two slices
     (make_grad_accum_train_step: the tower's products in the ranks'
     shapes; in one product of 2,048 rows cuBLAS rounds a few samples'
     cotangents differently, and the rows that moves are printed): its
     loss on every rank rtol 1e-5; the
     ranks' unsharded params and accumulators after it: tables, QR's q and
     r and v_w rtol 1e-5 / atol 1e-6 (all but the rows that 2 samples'
     hits reach: a sample whose tower input, summed block by block, puts
     a ReLU on the other side of 0 moves the rows its hits dominate by a
     share of lr under rwsadagrad), dense params rtol 1e-4 / atol 1e-5,
     but an element under element-wise Adagrad whose accumulator stays
     below 1e-12 (rounding-level gradients, which Adagrad divides by
     themselves) held to |dw| <= lr, accumulators rtol 1e-4 / atol 1e-8; every padded row exactly 0 after the steps. The single card's
     own 3 steps, the whole batch at once: losses rtol 1e-5 of the ranks',
     the params' drift from the ranks' printed. The path is ATen work (the
     embedding bags, the dense gradient, the optimizer): every launch
     count stays 0 on every rank.
The last two lines are the kernels JSON (14 kernels: phase 7 adds
coalesce_rows and row_scatter_add at the fused step's shape; their
`launches` are phase 7a's, and `launches_by_path` gives 7a's, each
phase-8 run's, each phase-10 run's (summed over its ranks) and phase 12's
12b (summed over its legs and ranks), 12c and 12g, each read just after its
own reset to 0; K2's gives phase 3's, each phase-9 run's, summed over its
ranks, and 12b's and 12c's; K1-K4 carry phase 4's g_bf16 record) and
{"ok": true, "device": ...}. The script prints its total seconds before
them.
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
from dlrm_tpu_torch.config import DCNConfig, DLRMConfig, QRConfig
from dlrm_tpu_torch.configs.presets import CRITEO_KAGGLE_COUNTS
from dlrm_tpu_torch.data.multi_hot_criteo import (
    MultiHotCriteoDataset,
    materialize_multihot_dataset,
)
from dlrm_tpu_torch.data.batch import Batch
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
    _check,
    _device,
    _launch,
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
    K2_CHUNK,
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
    tree_map_with_path,
)
from dlrm_tpu_torch.probes.common import graph_us, host_us, time_ms
from dlrm_tpu_torch.train import harness
from dlrm_tpu_torch.train.fused_step import make_fused_train_step
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
from dlrm_tpu_torch.train.step import (
    make_grad_accum_train_step,
    make_train_step,
)
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
    boundaries, on one skewed row with 20,480 hits and, at batch 16,384, on
    one row with 262,144 hits as in the pareto cell (both timed)."""
    tables, hots, b, d = MID_TABLES, MID_HOTS, MID_B, 128
    plan = make_stream_plan(tables, d, b, hots, block_rows=2048)
    pplan = make_stream_plan(tables, d, BATCH, hots, block_rows=2048)

    def mid(rng_seed, edit=None, touched=False, pl=plan):
        hb = ragged_multihot_batch(np.random.default_rng(rng_seed), 13,
                                   tables, hots, pl.batch)
        if edit is not None:
            edit(hb.idx)
        hb = dataclasses.replace(hb, wt=None).with_stream_work(
            pl, unit_weights=True, update_touched_only=touched)
        return hb.to_device(CUDA, flat_hots=pl.hot).stream

    def long_run(idx):  # 2,048 hits of row 7 of table 0: 8 items' worth
        idx[0, :, 0] = 7

    def skew(idx):  # 20,480 hits of row 11 of table 2 (hot 20)
        idx[2, :, :10] = 11

    def pareto_row(idx):  # 262,144 hits of row 11 of table 2 at 16,384
        idx[2, :, :16] = 11

    bplan, bsw = boundary_work()
    lists = {
        "full": (plan, mid(1)),
        "touched": (plan, mid(1, touched=True)),
        "long run": (plan, mid(1, long_run)),
        "skewed": (plan, mid(1, skew)),
        "boundary": (bplan, bsw),
        "pareto row": (pplan, mid(1, pareto_row, True, pplan)),
    }
    hot_hits = int((lists["skewed"][1].rows_u.reshape(-1)[
        plan.u_base[2]:plan.u_base[3]] == 11).sum())
    check(hot_hits == 20 * b // 2, f"skewed plan: {hot_hits} hits of row 11")
    psw = lists["pareto row"][1]
    pareto_hits = int((psw.rows_u.reshape(-1)[
        pplan.u_base[2]:pplan.u_base[3]] == 11).sum())
    check(pareto_hits >= 16 * BATCH and psw.long_hits >= pareto_hits
          and psw.long_runs >= 1,
          f"pareto-row plan: {pareto_hits} hits of row 11, "
          f"{psw.long_runs} long runs")
    log(f"phase 2: plan {len(tables)} tables, {plan.padded_rows} padded rows, "
        f"u_total {plan.u_total}, items {plan.max_items}; touched list "
        f"{lists['touched'][1].item_block.lt(plan.num_blocks).sum()} of "
        f"{lists['full'][1].item_block.lt(plan.num_blocks).sum()} real items; "
        f"long run 2048 hits, skewed row {hot_hits} hits; boundary plan "
        f"{bplan.table_sizes}; at batch {BATCH} a row of {pareto_hits} hits "
        f"({psw.long_runs} runs of more than {K2_CHUNK} hits, "
        f"{psw.long_hits} of {psw.hits} hits)")
    gen = torch.Generator(device=CUDA)
    gen.manual_seed(2)
    inputs = {}  # per plan: dly, the fp32 table, each optimizer's acc
    for pl in (plan, bplan, pplan):
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
        g32 = gather_grads(dly, sw.vals_u, wts, sw.w2t)
        # G_u in bf16 too (the step's g_dtype) on the full, touched-only
        # and long-run lists
        g_dtypes = ((torch.float32, torch.bfloat16)
                    if lname in ("full", "touched", "long run")
                    else (torch.float32,))
        for gdt in g_dtypes:
            g_u = gather_grads(dly, sw.vals_u, wts, sw.w2t, out_dtype=gdt)
            check(torch.equal(g_u, g32.to(gdt)),
                  f"{lname}: gather_grads({gdt}) is not its fp32 result "
                  "rounded once")
            args = (g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u,
                    0.05)
            gtag = "/g=bf16" if gdt == torch.bfloat16 else ""
            for opt, acc0 in accs.items():
                for tdt, sr in ((torch.float32, False),
                                (torch.bfloat16, False),
                                (torch.bfloat16, True)):
                    mm = (torch.bfloat16 if tdt == torch.bfloat16
                          else torch.float32)
                    kw = dict(mm_dtype=mm, stochastic_round=sr, seed=7)
                    t_k = base32.to(tdt).clone()
                    a_k = None if acc0 is None else acc0.clone()
                    stream_update(opt, pl, t_k, a_k, *args, **kw)
                    t_p = base32.to(tdt).clone()
                    a_p = None if acc0 is None else acc0.clone()
                    stream_update_plain(opt, pl, t_p, a_p, *args, **kw)
                    torch.cuda.synchronize()
                    name = f"{opt}/{str(tdt)[6:]}/sr={int(sr)}{gtag}/{lname}"
                    compare_update(name, t_p, t_k, a_p, a_k)
                    changed = int((t_k != base32.to(tdt)).any(1).sum())
                    check(changed > 0, f"{name}: kernel changed no row")
                    cases.append(name)
                    kernel_tables[name] = t_k
                    if (opt == "rwsadagrad" and sr
                            and lname in ("full", "skewed", "pareto row")):
                        t_t, a_t = t_k.clone(), a_k.clone()
                        timed[lname + gtag] = time_ms(lambda: stream_update(
                            opt, pl, t_t, a_t, *args, **kw), CUDA, 10)
                    log(f"  {name}: bit-identical, rows_changed {changed}")
    for name in cases:  # the touched-only list gives the full list's bits
        if name.endswith("/full"):
            check(torch.equal(kernel_tables[name].view(torch.uint8),
                              kernel_tables[name[:-4] + "touched"].view(
                                  torch.uint8)),
                  f"{name[:-5]}: touched-only list differs from full")
    n_bf16 = sum("/g=bf16/" in c for c in cases)
    log(f"phase 2: {len(cases)} K2 cases ({n_bf16} of them on a bf16 G_u) "
        "bit-identical to the plain version")
    log(f"phase 2: K2 rwsadagrad/bf16/sr on the mid-size full list "
        f"{timed['full']:.3f} ms (bf16 G_u {timed['full/g=bf16']:.3f} ms); "
        f"with one row of {hot_hits} hits {timed['skewed']:.3f} ms; at "
        f"batch {BATCH} with one row of {pareto_hits} hits (touched-only "
        f"list) {timed['pareto row']:.3f} ms")


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


def expected_rows(plan, sw, table, mm, out=torch.float32):
    """R_u by its definition: table[padded_offsets[t] + rows_u] rounded to
    mm, then to out, at real slots; 0 at sentinels."""
    rows = sw.rows_u.reshape(-1).long()
    off = torch.tensor(plan.padded_offsets, device=table.device)[
        sw.w2t.long().repeat_interleave(1024)]
    real = rows != SENTINEL_ROW
    want = torch.zeros((plan.u_total, table.shape[1]), dtype=out,
                       device=table.device)
    want[real] = table[(off + rows)[real]].to(mm).to(out)
    return want


def check_rows(name, plan, sw, table, mm, out=torch.float32):
    """K3 kernel against its plain version and against expected_rows, both
    bit for bit; every slot written. out: R_u's dtype."""
    args = (plan, table, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    got = stream_rows(*args, mm_dtype=mm, out_dtype=out)
    want = stream_rows_plain(*args, mm_dtype=mm, out_dtype=out)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype == out, f"{name}: R_u is {got.dtype}")
    check(not bool(torch.isnan(want).any()), f"{name}: a slot left unwritten")
    err = float((got.float() - want.float()).abs().nan_to_num(1e30).max())
    check(torch.equal(got, want), f"{name}: K3 differs from its plain version "
          f"(max abs {err})")
    check(torch.equal(got, expected_rows(plan, sw, table, mm, out)),
          f"{name}: K3 rows differ from table[padded_offsets[t] + rows_u]")
    return got, err


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
    # fp32 cotangent as autograd gives it: [B, T, d], passed transposed;
    # the bf16 tower's bf16 one beside it for the bf16 G_u cases
    dly = torch.randn((MID_B, len(MID_TABLES), d), generator=gen,
                      device=dev).transpose(0, 1)
    bf16 = torch.bfloat16
    n = n_bf16 = 0
    for mm in (torch.float32, bf16):
        for wname, w in wts.items():
            for dl, out in ((dly, torch.float32), (dly, bf16),
                            (dly.to(bf16), bf16)):
                args = (dl, sw.vals_u, w, sw.w2t)
                got = window_grads(*args, mm_dtype=mm, out_dtype=out)
                want = window_grads_plain(*args, mm_dtype=mm, out_dtype=out)
                torch.cuda.synchronize()
                check(got.dtype == out and torch.equal(got, want),
                      f"K1 mm={mm} weights={wname} dly={dl.dtype} "
                      f"out={out}: differs from its plain version")
                n += 1
                n_bf16 += out == bf16
    # gather_grads (ATen, K1's alternative) at bf16: its fp32 result
    # rounded once
    for dl in (dly, dly.to(bf16)):
        args = (dl, sw.vals_u, wts["random"], sw.w2t)
        check(torch.equal(gather_grads(*args, out_dtype=bf16),
                          gather_grads(*args).to(bf16)),
              f"gather_grads dly={dl.dtype}: bf16 G_u is not its fp32 G_u "
              "rounded once")
    table32 = torch.randn((plan.padded_rows, d), generator=gen,
                          device=dev) * 0.05
    r_u = {}
    for tdt in (torch.float32, bf16):
        for mm in (torch.float32, bf16):
            for out in (torch.float32, bf16):
                got, _ = check_rows(f"K3 table={tdt} mm={mm} out={out}",
                                    plan, sw, table32.to(tdt), mm, out)
                if tdt == mm == torch.float32:
                    r_u[out] = got
                n += 1
                n_bf16 += out == bf16
    for mm in (torch.float32, bf16):
        for wname, w in wts.items():
            for out, r in r_u.items():
                check_pool(f"K4 mm={mm} weights={wname} r_u={out}",
                           (plan, r, sw.vals_u, w, sw.w2t), mm)
                n += 1
                n_bf16 += out == bf16
    for cname, (cplan, csw) in pool_cases(rng).items():
        for out in (torch.float32, bf16):
            c_r = stream_rows(cplan, table32, csw.rows_u, csw.item_block,
                              csw.item_row0, csw.item_u, out_dtype=out)
            for mm in (torch.float32, bf16):
                got, _ = check_pool(
                    f"K4 {cname} mm={mm} r_u={out}",
                    (cplan, c_r, csw.vals_u, csw.wts_u, csw.w2t), mm)
                n += 1
                n_bf16 += out == bf16
            if cname == "budgeted":  # table 1's bags that lost every hit
                dropped = csw.wts_u.new_ones(MID_B, dtype=torch.bool)
                kept = csw.vals_u.reshape(-1)[
                    cplan.u_base[1]:cplan.u_base[2]]
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
    for tdt in (torch.float32, bf16):
        otable = torch.randn((oplan.padded_rows, d), generator=gen,
                             device=dev).to(tdt)
        for out in (torch.float32, bf16):
            check_rows(f"K3 overrun table={tdt} out={out}", oplan, osw,
                       otable, torch.float32, out)
            n += 1
            n_bf16 += out == bf16
    log(f"phase 2b: {n} cases ({n_bf16} of them with a bf16 G_u or R_u) "
        "bit-identical to the plain versions (K4 called twice in each, with "
        "the same bits); gather_grads at bf16 its fp32 result rounded once")
    launch_path_host_us()


def launch_path_host_us():
    """The host's µs to enqueue one call (host_us) of K1-K4 through their
    wrappers on the phase-2 plan (K2 sgd at lr 0, which leaves the table
    as it is), and of the parts of t3_reshape_add's call at [8, 128]:
    _launch alone, the device switch and the two ways to the stream handle
    it could take, the wrapper's checks, an output's allocation, one ATen
    add beside them."""
    d = 128
    plan = make_stream_plan(MID_TABLES, d, MID_B, MID_HOTS, block_rows=2048)
    hb = ragged_multihot_batch(np.random.default_rng(4), 13, MID_TABLES,
                               MID_HOTS, MID_B)
    sw = hb.with_stream_work(plan).to_device(CUDA, flat_hots=plan.hot).stream
    gen = _gen(35)
    dly = torch.randn((MID_B, len(MID_TABLES), d), generator=gen,
                      device="cuda").transpose(0, 1)
    table = torch.randn((plan.padded_rows, d), generator=gen, device="cuda")
    k1 = (dly, sw.vals_u, sw.wts_u, sw.w2t)
    items = (sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    g_u = window_grads(*k1)
    r_u = stream_rows(plan, table, *items)
    x = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
    out = torch.empty_like(x)

    def device_switch():
        with torch.cuda.device(x.device):
            pass

    calls = {
        "window_grads": lambda: window_grads(*k1),
        "stream_update": lambda: stream_update("sgd", plan, table, None, g_u,
                                               *items, 0.0),
        "stream_rows": lambda: stream_rows(plan, table, *items),
        "window_pool": lambda: window_pool(plan, r_u, sw.vals_u, sw.wts_u,
                                           sw.w2t),
        "t3_reshape_add": lambda: pk.t3_reshape_add(x),
        "_launch": lambda: _launch("t3_reshape_add", x.device, x.data_ptr(),
                                   out.data_ptr(), 8, 128),
        "torch.cuda.device": device_switch,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "_cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_device": torch.cuda.current_device,
        "_check": lambda: _check("x", x, (torch.int32,)),
        "_device": lambda: _device("t3_reshape_add", x),
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.add": lambda: torch.add(x, 1),
    }
    us = {}
    for k, fn in calls.items():
        try:
            us[k] = host_us(fn, CUDA)
        except RuntimeError as e:
            raise SmokeFailure(f"phase 2b: {k}: {e}") from e
    log("phase 2b: host us to enqueue a call (1,000 enqueues behind a "
        "sleeping card): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))


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
    return (cfg, model, plan, params, opt_state,
            full_width_step(model, plan, fwd_impl, grad_impl))


def full_width_step(model, plan, fwd_impl, grad_impl, g_dtype=torch.float32):
    """The train step of phases 3 and 4: rwsadagrad, bf16 K1-K4 operands,
    stochastic rounding, G_u and R_u in g_dtype."""
    return make_stream_train_step(
        model, "rwsadagrad", plan, fwd_impl=fwd_impl, grad_impl=grad_impl,
        mm_dtype=torch.bfloat16, g_dtype=g_dtype, stochastic_round=True,
    )


def clone_tree(tree):
    return tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def same_bits(a, b):
    """Leaf by leaf, bit for bit: (all equal, elements that differ, their
    largest abs difference)."""
    n, worst = 0, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        if not isinstance(x, torch.Tensor):
            n += int(x != y)
            continue
        ne = (x.reshape(-1).view(torch.uint8).view(-1, x.element_size())
              != y.reshape(-1).view(torch.uint8).view(-1, y.element_size())
              ).any(1)
        n += int(ne.sum())
        if ne.any():
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return n == 0, n, worst


def run_steps(tag, step, params, opt_state, plan, cfg, touched):
    """WARMUP + STEPS train steps at full width, a fresh host batch per
    step, built while the card works (the same batches on every call).
    Every launch count is set to 0 just before and read just after.
    Returns the last batch (host and device), the launch counts, the losses
    and the median device span of a timed step."""
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
    return (params, opt_state, hb, batch, launches, losses,
            float(np.median(dev_ms)))


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


def kernel_work(plan, sw, hb, g_bytes, d=128):
    """{kernel: (bytes it must move once, fp32 operations)} of K1-K4 on one
    full-width step's work, with G_u and R_u at g_bytes an element (4 fp32,
    2 bf16): bf16 tables, fp32 dly, pooled and accumulator."""
    n_slots = plan.u_total
    n_hits = int((sw.rows_u != SENTINEL_ROW).sum())
    touched = touched_rows(hb)
    items = sw.item_block.numel()
    windows = sw.w2t.numel()
    pooled = len(plan.table_sizes) * BATCH * d * 4
    return {
        # G_u written; dly (fp32) read once; vals_u, wts_u, w2t read; one
        # multiply per G element
        "window_grads": (n_slots * d * g_bytes + pooled + n_slots * 8
                         + windows * 4, n_slots * d),
        # each real hit's G row, rows_u and the item arrays read, each
        # touched row's bf16 table row and fp32 accumulator read and
        # written; an add per hit element, and per touched element the
        # rwsadagrad epilogue's square, row-sum add, lr product, divide and
        # subtract
        "stream_update": (n_hits * d * g_bytes + n_slots * 4 + items * 12
                          + touched * (d * 2 * 2 + 4 * 2),
                          n_hits * d + touched * d * 5),
        # R_u written; each touched bf16 table row, rows_u and the items
        # read; no arithmetic beyond the conversions
        "stream_rows": (n_slots * d * g_bytes + touched * d * 2
                        + n_slots * 4 + items * 12, 0),
        # each hit's R row, vals_u, wts_u and w2t read; pooled written; a
        # multiply and an add per hit element
        "window_pool": (n_hits * d * g_bytes + n_slots * 8 + windows * 4
                        + pooled, n_hits * d * 2),
    }


def phase_gather_path():
    cfg, model, plan, params, opt_state, step = full_width_setup(
        "gather", "gather")
    log(f"phase 3: fwd_impl=gather grad_impl=gather, touched-only items; "
        f"plan padded_rows {plan.padded_rows}, u_total {plan.u_total}, "
        f"max_items {plan.max_items}, blocks {plan.num_blocks}; top MLP "
        f"{cfg.ln_top}")
    params, opt_state, hb, batch, launches, _, _ = run_steps(
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
    nbytes, nops = kernel_work(plan, sw, hb, 4)["stream_update"]
    log(f"phase 3: K2 at full width ({int((sw.rows_u != -1).sum())} hits, "
        f"{touched_rows(hb)} touched rows):")
    k2 = kernel_entry(
        "stream_update", "dlrm_tpu_torch/csrc/stream_update.cu",
        "dlrm_tpu/ops/stream_kernels.py:438", launches["stream_update"],
        r["max_abs"], k2_ms, plain_ms, nbytes, nops, None)
    del t_k, a_k, g_u

    # g_dtype=bf16: one step from the last state on the last batch beside an
    # fp32-G_u step. dly is bf16 here (the gather forward of a bf16 table)
    # and the weights are 1, so G_u is a bf16 value already (and K2 rounds
    # each G row to bf16 for mm_dtype bf16 anyway): the same bits
    outs = []
    for gdt in (torch.float32, torch.bfloat16):
        p, s = clone_tree(params), clone_tree(opt_state)
        loss = full_width_step(model, plan, "gather", "gather", gdt)(
            p, s, batch, LR)[2]
        outs.append((float(loss), p, s))
    torch.cuda.synchronize()
    (l32, p32, s32), (l16, p16, s16) = outs
    equal, n_diff, worst = same_bits((p16, s16), (p32, s32))
    check(equal and l16 == l32,
          f"phase 3: the g_dtype=bf16 step differs from the fp32-G_u step: "
          f"{n_diff} elements, max abs {worst:.3e}; losses {l16!r} / {l32!r}")
    log(f"phase 3: a g_dtype=bf16 step from the same state on the same batch "
        f"as an fp32-G_u step: params, accumulator and loss ({l16:.6f}) "
        "bit-identical")
    del outs, p32, s32, p16, s16

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


def full_width_kernels(tag, plan, sw, emb, acc, k1_args, gdt):
    """One full-width call of K1, K3, K4 (twice) and K2 (full item list, on
    K1's G_u) against its plain version, bit for bit, with G_u and R_u in
    gdt; then each one's ms (10 calls) and its plain version's (3).
    Returns {kernel: (max abs err, ms, plain ms)} and K3's R_u."""
    mm = torch.bfloat16
    k1_kw = dict(mm_dtype=mm, out_dtype=gdt)
    g_u = window_grads(*k1_args, **k1_kw)
    g_p = window_grads_plain(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    check(g_u.dtype == gdt and torch.equal(g_u, g_p),
          f"{tag}: full-width K1 differs from its plain version")
    err = {"window_grads": float((g_u.float() - g_p.float()).abs().max())}
    del g_p
    k3_args = (plan, emb, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    r_u, err["stream_rows"] = check_rows(f"{tag}: full-width K3", plan, sw,
                                         emb, mm, gdt)
    k4_args = (plan, r_u, sw.vals_u, k1_args[2], sw.w2t)
    _, err["window_pool"] = check_pool(f"{tag}: full-width K4", k4_args, mm)
    k2_args = (g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u, LR)
    k2_kw = dict(mm_dtype=mm, stochastic_round=True, seed=12)
    t_k, a_k = emb.clone(), acc.clone()
    t_p, a_p = emb.clone(), acc.clone()
    stream_update("rwsadagrad", plan, t_k, a_k, *k2_args, **k2_kw)
    stream_update_plain("rwsadagrad", plan, t_p, a_p, *k2_args, **k2_kw)
    torch.cuda.synchronize()
    err["stream_update"] = compare_update(
        f"{tag}: full-width K2, full list", t_p, t_k, a_p, a_k)["max_abs"]
    log(f"{tag}: full-width K1, K3, K4 and K2 (full item list) "
        "bit-identical to their plain versions; two K4 calls give the same "
        "bits")
    calls = {
        "window_grads": (lambda: window_grads(*k1_args, **k1_kw),
                         lambda: window_grads_plain(*k1_args, **k1_kw)),
        "stream_update": (
            lambda: stream_update("rwsadagrad", plan, t_k, a_k, *k2_args,
                                  **k2_kw),
            lambda: stream_update_plain("rwsadagrad", plan, t_p, a_p,
                                        *k2_args, **k2_kw)),
        "stream_rows": (
            lambda: stream_rows(*k3_args, mm_dtype=mm, out_dtype=gdt),
            lambda: stream_rows_plain(*k3_args, mm_dtype=mm, out_dtype=gdt)),
        "window_pool": (lambda: window_pool(*k4_args, mm_dtype=mm),
                        lambda: window_pool_plain(*k4_args, mm_dtype=mm)),
    }
    return {k: (err[k], time_ms(kern, CUDA, 10, warmup=0),
                time_ms(plain, CUDA, 3, warmup=0))
            for k, (kern, plain) in calls.items()}, r_u


def g_bf16_record(name, res, work, launches):
    """A K1-K4 entry's record of its run with G_u and R_u in bf16."""
    err, ms, plain_ms = res
    nbytes, nops = work
    bound_ms, bound_by = bound(nbytes, nops)
    log(f"  {name} (G_u, R_u bf16): {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms by {bound_by} ({nbytes} B, {nops} fp32 "
        f"ops); {bound_ms / ms:.1%} of the bound; launches {launches}; max "
        f"abs err vs plain {err:.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "launches": launches}


def k1_library_ms(k1_args, dtype):
    """K1's library yardstick: one F.embedding_bag, one index a bag
    (offsets arange(U)), mode sum, the slot weights as per_sample_weights,
    over a contiguous [T * B, d] copy of dly made before the timed calls.
    In fp32 it computes K1's function at mm_dtype fp32 with fp32 G_u; in
    bf16 on dly and the weights rounded to bf16, into bf16 G_u (its
    products are not K1's bits). ms a call, 10 calls."""
    dly, vals_u, wts_u, w2t = k1_args
    t, b, d = dly.shape
    flat = dly.to(dtype).reshape(t * b, d)  # a copy: dly is a view
    idx = (w2t.long()[:, None, None] * b + vals_u.long()).reshape(-1)
    offsets = torch.arange(idx.numel(), device=dly.device)
    psw = wts_u.reshape(-1).to(dtype)
    return time_ms(lambda: F.embedding_bag(idx, flat, offsets, mode="sum",
                                           per_sample_weights=psw),
                   CUDA, 10)


def phase_kernel_path():
    """Phase 4: the kernel path at full width, with G_u and R_u in fp32 and
    then in bf16 (g_dtype). Returns K1's, K3's and K4's entries, each with
    its g_bf16 record, and K2's g_bf16 record (on this path's full item
    list, its fp32 figures beside it)."""
    cfg, model, plan, params, opt_state, step = full_width_setup(
        "stream", "onehot")
    t_, d = len(cfg.table_sizes), cfg.embedding_dim
    log("phase 4: fwd_impl=stream grad_impl=onehot, full item list")
    start = clone_tree(params), clone_tree(opt_state)
    params, opt_state, hb, batch, launches, losses, span = run_steps(
        "phase 4", step, params, opt_state, plan, cfg, touched=False)
    total = WARMUP + STEPS
    for k in KERNELS:
        check(launches[k] == total,
              f"phase 4: {k} launched {launches[k]} times in {total} steps")

    sw = batch.stream
    emb = params["emb"]["stacked"]
    acc = opt_state["accum"]["emb"]["stacked"]
    wts = (sw.rows_u != SENTINEL_ROW).float()
    mm = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    # fp32 cotangent as autograd gives it on this path: [B, T, d], transposed
    dly = torch.randn((BATCH, t_, d), generator=gen,
                      device="cuda").transpose(0, 1)
    k1_args = (dly, sw.vals_u, wts, sw.w2t)
    k3_args = (plan, emb, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    res, r_u = full_width_kernels("phase 4", plan, sw, emb, acc, k1_args,
                                  torch.float32)
    log(f"phase 4: K2 on the full item list {res['stream_update'][1]:.3f} ms")

    # the library yardsticks
    gg_ms = time_ms(lambda: gather_grads(*k1_args), CUDA, 10, warmup=0)
    k1_lib = {gdt: k1_library_ms(k1_args, gdt)
              for gdt in (torch.float32, torch.bfloat16)}
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
    idx = (sw.w2t.long()[:, None, None] * BATCH + sw.vals_u.long()).reshape(-1)
    k4_lib = time_ms(lambda: torch.zeros((t_ * BATCH, d), device="cuda")
                     .index_add_(0, idx, r_u), CUDA, 10, warmup=0)
    del r_u
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
        f"and K1's library call (F.embedding_bag, one index a bag) "
        f"{k1_lib[torch.float32]:.3f} ms in fp32, "
        f"{k1_lib[torch.bfloat16]:.3f} ms in bf16 beside K1 "
        f"{res['window_grads'][1]:.3f} ms")

    work32 = kernel_work(plan, sw, hb, 4)
    log(f"phase 4: kernels at full width ({plan.u_total} slots, "
        f"{int((sw.rows_u != SENTINEL_ROW).sum())} hits, {touched_rows(hb)} "
        f"touched rows, {sw.item_block.numel()} items):")
    sources = {"window_grads": ("window_grads.cu", 96,
                                k1_lib[torch.float32]),
               "stream_rows": ("stream_rows.cu", 613, k3_lib),
               "window_pool": ("window_pool.cu", 679, k4_lib)}
    entries = {
        k: kernel_entry(k, f"dlrm_tpu_torch/csrc/{src}",
                        f"dlrm_tpu/ops/stream_kernels.py:{line}",
                        launches[k], *res[k], *work32[k], lib)
        for k, (src, line, lib) in sources.items()}

    # the same steps with g_dtype=bf16 from the same start on the same
    # batches. mm_dtype is bf16, so K1's products (unit weights) and K3's
    # rows are bf16 values already and K2 rounds each G row to bf16 anyway:
    # the bits cannot change, only the bytes G_u and R_u take
    step16 = full_width_step(model, plan, "stream", "onehot", torch.bfloat16)
    p16, s16, _, _, launches16, losses16, span16 = run_steps(
        "phase 4 g_dtype=bf16", step16, *start, plan, cfg, touched=False)
    del start
    for k in KERNELS:
        check(launches16[k] == total,
              f"phase 4 g_dtype=bf16: {k} launched {launches16[k]} times in "
              f"{total} steps")
    equal, n_diff, worst = same_bits((p16, s16), (params, opt_state))
    check(equal and losses16 == losses,
          f"phase 4: the g_dtype=bf16 steps part from the fp32-G_u steps: "
          f"{n_diff} elements, max abs {worst:.3e}")
    del p16, s16
    log(f"phase 4: g_dtype=bf16: {total} steps from the same start give the "
        f"fp32-G_u steps' losses and params bit for bit; device span per "
        f"step median {span16:.2f} ms (fp32 G_u {span:.2f} ms)")
    res16, _ = full_width_kernels("phase 4 g_dtype=bf16", plan, sw, emb, acc,
                                  k1_args, torch.bfloat16)
    work16 = kernel_work(plan, sw, hb, 2)
    for k, e in entries.items():
        e["g_bf16"] = g_bf16_record(k, res16[k], work16[k], launches16[k])
    entries["window_grads"]["g_bf16"]["library_ms"] = k1_lib[torch.bfloat16]
    k2 = g_bf16_record("stream_update (full list)", res16["stream_update"],
                       work16["stream_update"], launches16["stream_update"])
    k2_32_bound, _ = bound(*work32["stream_update"])
    k2.update(items="full list, phase 4", fp32_ms=res["stream_update"][1],
              fp32_plain_ms=res["stream_update"][2],
              fp32_bound_ms=k2_32_bound)
    log(f"  stream_update (full list, fp32 G_u): {k2['fp32_ms']:.3f} ms, "
        f"plain {k2['fp32_plain_ms']:.3f} ms, bound {k2_32_bound:.3f} ms")
    return entries, k2


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
    """got against want (on want's device: a plain version may run on CPU
    copies): bit for bit when rtol = atol = 0, else within them; returns
    the max abs difference."""
    torch.cuda.synchronize()
    got = got.to(want.device)
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
    """Every variant against its plain version (the sgd update or the
    unchanged table) and the full variants against K2, all bit for bit:
    phase 2's plan, the probe and the main-path shapes. Returns the plain
    version's time at the main-path shape."""
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
                err = max(err, _held(f"k2_bisect {tag} {v}", got, want))
                _held(f"k2_bisect {tag} {v} against K2", got, k2)
            else:
                err = max(err, _held(f"k2_bisect {tag} {v} (skeleton)", got,
                                     table))
            del got
        log(f"phase 5: k2_bisect {tag}: V1-V6 hold (full variants "
            "bit-identical to the plain version and to K2; skeletons leave "
            "the table unchanged)")
        del want, k2
    plain_ms = time_ms(lambda: pk.k2_bisect_plain("V1", plan, table, *args),
                       CUDA, 3, warmup=0)
    return {"k2_bisect": {"err": err, "plain_ms": plain_ms}}


def split_times(fn, calls=20):
    """A call's time three ways: CUDA events around `calls` back-to-back
    calls after one (ms; the host's enqueue where it is slower than the
    card), the card's µs a call (graph_us: 100 calls in one CUDA graph) and
    the host's µs a call to enqueue it (host_us: 1,000 enqueues with the
    card kept busy)."""
    return {"ms": time_ms(fn, CUDA, calls),
            "device_us": graph_us(fn, CUDA), "host_us": host_us(fn, CUDA)}


def _split_line(t):
    return (f"{t['ms']:.4f} ms a call, {t['device_us']:.2f} us on the card, "
            f"{t['host_us']:.2f} us on the host")


def feasibility_vs_plain():
    """T2, T3, T4 and T6, small and at P6's sizes; at P6's sizes also the
    kernel's and the library call's time three ways (split_times), the
    plain version's, the bytes and the operations. T4 is held bit for bit
    against its plain version on CPU copies of its inputs (on the card the
    plain version's index_add_ adds with atomics in no fixed order)."""
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
            # kernel, plain version, what it is held to, library call
            "t2_contract": (
                lambda: pk.t2_contract(a, b),
                lambda: pk.t2_contract_plain(a, b),
                lambda: pk.t2_contract_plain(a, b),
                lambda: torch.einsum("slr,sld->rd", a, b), (1e-5, 1e-4),
                4 * (a.numel() + b.numel() + r * c), 2 * s * l * r * c),
            "t3_reshape_add": (
                lambda: pk.t3_reshape_add(x3),
                lambda: pk.t3_reshape_add_plain(x3),
                lambda: pk.t3_reshape_add_plain(x3),
                lambda: torch.add(x3, 1), (0, 0), 8 * x3.numel(),
                x3.numel()),
            "t4_onehot_accumulate": (
                lambda: pk.t4_onehot_accumulate(idx, g, rows),
                lambda: pk.t4_onehot_accumulate_plain(idx, g, rows),
                lambda: pk.t4_onehot_accumulate_plain(idx.cpu(), g.cpu(),
                                                      rows),
                lambda: torch.index_add(zeros, 0, idx.view(-1), g),
                (0, 0), 4 * (cap + g.numel() + rows * d), g.numel()),
            "t6_revolve_accumulate": (
                lambda: pk.t6_revolve_accumulate(x6, steps, br),
                lambda: pk.t6_revolve_accumulate_plain(x6, steps, br),
                lambda: pk.t6_revolve_accumulate_plain(x6, steps, br),
                lambda: torch.sum(x6.view(nb, steps, br, d6), dim=1),
                (0, 0), 4 * (x6.numel() + nb * br * d6), x6.numel()),
        }

    out = {}
    for small in (True, False):
        for name, (kern, plain, want, lib, (rtol, atol), nbytes,
                   nops) in cases(small).items():
            err = _held(f"{name} {'small' if small else 'P6'}", kern(),
                        want(), rtol=rtol, atol=atol)
            if not small:
                k, lb = split_times(kern), split_times(lib)
                out[name] = {"err": err, "ms": k["ms"],
                             "plain_ms": time_ms(plain, CUDA, 20, warmup=0),
                             "library_ms": lb["ms"], "nbytes": nbytes,
                             "nops": nops, "extra": {
                                 "device_us": k["device_us"],
                                 "host_us": k["host_us"],
                                 "library_device_us": lb["device_us"],
                                 "library_host_us": lb["host_us"]}}
                log(f"phase 5: {name} at P6's size: kernel {_split_line(k)}; "
                    f"library {_split_line(lb)}")
    log("phase 5: t2_contract, t3_reshape_add, t4_onehot_accumulate and "
        "t6_revolve_accumulate hold against their plain versions, small and "
        "at P6's sizes (max abs " + ", ".join(
            f"{k} {v['err']:.3e}" for k, v in out.items()) + ")")
    return out


# T3 and T6 at a size where the card's time shows, both far beyond the
# 50 MB L2: T3 [rows, cols] int32 (268 MB in, 268 MB out); T6 nb output
# blocks of steps input blocks of [br, d] fp32 (805 MB in, 268 MB out).
# T2 [S, L, R] x [S, L, C] with K = S * L = 16,384: 1.074 GFLOP, a 16.03 us
# operations bound (25.3 MB read). T4 cap hits into rows rows of d: where
# its rows x cap / 32 ballots stop being cheap (no target).
T3_SCALE = (16_384, 4_096)
T6_SCALE = (2_048, 3, 256, 128)
T2_SCALE = (8, 2_048, 256, 128)
T4_SCALE = (4_096, 4_096, 128)


def _t2_within_fp32(a, b, got):
    """T2's criterion at scale: the kernel's max abs error against an fp64
    product is no more than twice the fp32 plain version's, plus 1e-5.
    Returns (kernel's, plain version's, einsum's) errors."""
    exact = a.double().reshape(-1, a.shape[-1]).T @ b.double().reshape(
        -1, b.shape[-1])
    errs = tuple(float((t.double() - exact).abs().max()) for t in (
        got, pk.t2_contract_plain(a, b), torch.einsum("slr,sld->rd", a, b)))
    check(errs[0] <= 2 * errs[1] + 1e-5,
          f"t2_contract at scale: max abs error {errs[0]:.3e} against fp64, "
          f"over twice the plain version's {errs[1]:.3e} plus 1e-5")
    log(f"phase 5: t2_contract at scale: max abs error against an fp64 "
        f"product {errs[0]:.3e} (plain fp32 {errs[1]:.3e}, einsum "
        f"{errs[2]:.3e})")
    return errs


def t4_drops_out_of_range():
    """T4 with indices outside [0, rows) (below 0 and past the last row),
    every hit on one row, d % 4 != 0 and a g that starts 4 bytes past a
    16-byte boundary: bit for bit against its plain version on CPU copies,
    which drops such a hit as the reference's one-hot does."""
    errs = []
    for cap, rows, d, spread, offset in ((256, 512, 128, True, 0),
                                         (256, 512, 129, True, 1),
                                         (37, 30, 3, True, 0),
                                         (256, 30, 128, False, 1)):
        idx = (_randint(rows + 10, (cap, 1), 40) - 5 if spread else
               torch.full((cap, 1), rows // 2, dtype=torch.int32,
                          device="cuda"))
        buf = torch.randn((cap * d + offset,), generator=_gen(41),
                          device="cuda")
        g = buf[offset:].view(cap, d)
        errs.append(_held(f"t4_onehot_accumulate cap {cap} rows {rows} d {d}",
                          pk.t4_onehot_accumulate(idx, g, rows),
                          pk.t4_onehot_accumulate_plain(idx.cpu(), g.cpu(),
                                                        rows)))
    log("phase 5: t4_onehot_accumulate drops indices outside [0, rows), bit "
        "for bit against its plain version on CPU copies (4 cases, max abs "
        f"{max(errs):.3e})")


def feasibility_at_scale():
    """T3, T6, T2 and T4 at T3_SCALE, T6_SCALE, T2_SCALE and T4_SCALE: T3,
    T6 and T4 bit for bit against their plain versions (T4's on CPU copies)
    and their library calls within the reference's tolerance (T3 exact, T6
    atol 1e-5, T4 atol 1e-4); T2 by _t2_within_fp32. Each timed three ways
    (split_times) beside its bound, also where its check failed (an A/B
    reads the parent's times); any failed check fails the phase at the
    end. Returns name -> the at-scale figures."""
    rows, cols = T3_SCALE
    x3 = _randint(2**31 - 1, (rows, cols), 33)
    nb, steps, br, d = T6_SCALE
    x6 = torch.randn((nb * steps * br, d), generator=_gen(34), device="cuda")
    s, l, r, c = T2_SCALE
    gen = _gen(35)
    a = torch.randn((s, l, r), generator=gen, device="cuda")
    b = torch.randn((s, l, c), generator=gen, device="cuda")
    cap, rows4, d4 = T4_SCALE
    idx = _randint(rows4, (cap, 1), 36)
    g = torch.randn((cap, d4), generator=_gen(37), device="cuda")
    zeros = torch.zeros((rows4, d4), device="cuda")

    def exact(name, plain, lib, lib_atol):
        def hold(got):
            err = _held(f"{name} at scale", got, plain())
            _held(f"{name} at scale against its library call", got, lib(),
                  atol=lib_atol)
            return err
        return hold

    def t2_hold(got):
        return _t2_within_fp32(a, b, got)[0]

    cases = {  # kernel, its check (-> error), library call, bytes, ops
        "t3_reshape_add": (
            lambda: pk.t3_reshape_add(x3),
            exact("t3_reshape_add", lambda: pk.t3_reshape_add_plain(x3),
                  lambda: torch.add(x3, 1), 0.0),
            lambda: torch.add(x3, 1), 8 * x3.numel(), 0),
        "t6_revolve_accumulate": (
            lambda: pk.t6_revolve_accumulate(x6, steps, br),
            exact("t6_revolve_accumulate",
                  lambda: pk.t6_revolve_accumulate_plain(x6, steps, br),
                  lambda: torch.sum(x6.view(nb, steps, br, d), dim=1).view(
                      -1, d), 1e-5),
            lambda: torch.sum(x6.view(nb, steps, br, d), dim=1).view(-1, d),
            4 * (x6.numel() + nb * br * d), 0),
        "t2_contract": (
            lambda: pk.t2_contract(a, b), t2_hold,
            lambda: torch.einsum("slr,sld->rd", a, b),
            4 * (a.numel() + b.numel() + r * c), 2 * s * l * r * c),
        "t4_onehot_accumulate": (
            lambda: pk.t4_onehot_accumulate(idx, g, rows4),
            exact("t4_onehot_accumulate",
                  lambda: pk.t4_onehot_accumulate_plain(idx.cpu(), g.cpu(),
                                                        rows4),
                  lambda: torch.index_add(zeros, 0, idx.view(-1), g), 1e-4),
            lambda: torch.index_add(zeros, 0, idx.view(-1), g),
            4 * (cap + g.numel() + rows4 * d4), g.numel()),
    }
    out, failed = {}, []
    for name, (kern, hold, lib, nbytes, nops) in cases.items():
        got = kern()
        try:
            err = hold(got)
        except SmokeFailure as e:
            failed.append(str(e))
            err = float("nan")
            log(f"phase 5: FAILED: {e}")
        del got
        k, lb = split_times(kern), split_times(lib)
        bound_ms, bound_by = bound(nbytes, nops)
        dev_ms = k["device_us"] / 1e3
        out[name] = {"err": err, "nbytes": nbytes, "nops": nops,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / dev_ms, **k, "library": lb}
        log(f"phase 5: {name} at scale ({nbytes} B, {nops} fp32 ops): "
            f"kernel {_split_line(k)}, {bound_ms / dev_ms:.1%} of its "
            f"{bound_ms:.4f} ms {bound_by} bound on the card; library "
            f"{_split_line(lb)}; kernel/library on the card "
            f"{k['device_us'] / lb['device_us']:.3f}")
    check(not failed, "; ".join(failed))
    return out


def p2b_takes():
    """P2b's two takes at their own [256, 128] shape (stream_variants.py
    t1_variants), each through row_gather: its time three ways
    (split_times), its plain version's, the library call's (one indexing)
    three ways and its bound (each gathered row read and written once, the
    index read once). Launched after the probe path's counts are read."""
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
            f"{_split_line(split_times(kern))}; plain "
            f"{time_ms(plain, CUDA, 20):.4f} ms; library "
            f"{_split_line(split_times(lib))}; bound {bound_ms:.5f} ms by "
            f"bytes ({nbytes} B)")


def _against(name, rec, yard_name, yard_ms, slack=1.0):
    """One line: a probe kernel's ms against its yardstick's (held when
    ms <= yard_ms * slack) and its share of its bytes bound."""
    ms = rec["ms"]
    bound_ms, _ = bound(rec["nbytes"], 0)
    verdict = "held" if ms <= yard_ms * slack else "missed"
    log(f"  {name} {ms:.4f} ms ({bound_ms / ms:.1%} of its {bound_ms:.3f} ms "
        f"bytes bound) against {yard_name} {yard_ms:.4f} ms"
        + (f" x {slack}" if slack != 1.0 else "") + f": {verdict}")


def stream_probe_times():
    """The streamed block update and K2's bisection by CUDA events (the
    probes' own timers, each variant checked against its values): P2a in
    place against copy_ (P2's main), P4's S, D, M, N, P and Q against
    t + 1 (E) and copy_ (C), and P3's V1-V6 with index_add_ and K2's
    ladder at the main-path shape."""
    r2 = p2.main()["stream"]
    r4 = p4.main(variants="S,D,M,N,P,Q,E,C")
    r3 = p3.run_shape("main-path", *p3.main_path_shape(), CUDA,
                      list(pk.K2_VARIANTS))
    log("stream probes (CUDA events):")
    _against("P2a in place", r2["stream alias donate"], "copy_",
             r2["torch copy_ (device to device)"]["ms"])
    _against("P4 S", r4["S"], "E (t + 1)", r4["E"]["ms"])
    for v in "DMNPQ":
        _against(f"P4 {v}", r4[v], "E (t + 1)", r4["E"]["ms"], slack=1.01)
    log(f"  P4 C (copy_) {r4['C']['ms']:.4f} ms")
    for v in pk.K2_VARIANTS:
        log(f"  P3 {p3.NAMES[v]}: {r3[v]['ms']:.4f} ms, "
            f"{bound(r3[v]['nbytes'], 0)[0] / r3[v]['ms']:.1%} of its bytes "
            "bound")
    log(f"  P3 {p3.LIBRARY} {r3[p3.LIBRARY]['ms']:.4f} ms; K2 sgd fp32 "
        f"{r3['K2 sgd fp32']['ms']:.4f} ms")


def phase_probes():
    """Phase 5: the probe kernels against their plain versions, then the six
    probes' entry points (counted launches) and the card's figures."""
    held = {}
    for fn in (rows_vs_plain, block_stream_vs_plain, k2_bisect_vs_plain,
               feasibility_vs_plain):
        held.update(fn())
        torch.cuda.empty_cache()
    t4_drops_out_of_range()
    for name, rec in feasibility_at_scale().items():
        held[name]["extra"]["at_scale"] = rec
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
        entries[-1].update(h.get("extra", {}))
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

    def __init__(self, tag, first=None):
        self.tag = tag
        self.calls = {k: [] for k in FUSED}
        self.depth = 0  # coalesce_rows calls itself on rows padded to 4
        self.first = first  # copy only each kernel's first calls

    def _full(self, k):
        return self.first is not None and len(self.calls[k]) >= self.first

    def __enter__(self):
        self.real = real_c, real_s = su.coalesce_rows, su.row_scatter_add_

        def coalesce(r_s, seg, bag_s, w_s, dly, total_rows):
            if self.depth or self._full("coalesce_rows"):
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
            if self._full("row_scatter_add"):
                return real_s(table, idx, delta, **kw)
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


# ------------------------------------------------------------- phase 9
# the DLRM-v2 trainer's sharded stream path (parallel/stream_butterfly.py)
# over W ranks, each a process of its own: 9a the step in three plans, 9b
# v2_main --sharded from phase 6's days
P9_FP32_STEPS = 2
# 9b's depth: each train batch costs the host ~6.5 s of shared bucketing
# (rw_bucket.bucket_rw_hits_shared over 26 x 100 columns a sample); 9a's
# runs cut to 2 steps for the same reason (and 10a's rwsadagrad runs to 3),
# to keep the script, phase 13 included, inside its time limit on a slow
# host
P9B_LIMITS = {"train": 2, "val": 1, "test": 1}
P9_BF16_STEPS = 2
# the fp32 comparison's (rtol, atol): tables 1e-5 / 1e-6; dense params
# the port's step tests' (their grads sum 16,384 rows in another order)
P9_TOL = {"tables": (1e-5, 1e-6), "dense": (1e-4, 1e-5)}
# the fp32 comparison, by optimizer: (learning rate, held to P9_TOL). SGD's
# update is continuous in the gradient, so the sharded step's other
# summation order stays at rounding level; at lr 1.0 (the v1 MLPerf rate)
# a row's update (~3e-5) dwarfs atol, so a lost or doubled hit shows.
# Element-wise Adagrad on the dense params moves each weight by lr * g /
# |g| on the first step, sign(g) for a gradient at rounding level too, so
# there only the losses are held and the differences are reported.
P9_FP32 = {"sgd": (1.0, True), "rwsadagrad": (1e-3, False)}
# With W = 2 shards, bench.py's 26 equal tables stripe all or none (a
# capacity budget either fits 13 whole tables a shard or no plan meets it),
# so "striped" stripes every table (rw_threshold 100,000 rows: all 26 are
# above it); with 4 cards, 2 of them.
P9_PLANS = {
    "table-wise": {},
    "striped": {"stripe": True},
    "striped+shared": {"stripe": True, "shared": True},
}


def p9_world():
    """(ranks, backend, staged): NCCL over min(cards, 4) ranks, one card
    each; on one card, 2 ranks sharing it over gloo, each collective staged
    through host memory (NCCL refuses two ranks on one card)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return min(n, 4), "nccl", False
    return 2, "gloo", True


def p9_rank_device(rank, staged):
    dev = torch.device("cuda", 0 if staged else rank)
    torch.cuda.set_device(dev)
    # the ranks share the host's cores (each would take them all)
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // max(1, torch.cuda.device_count(), 2)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def p9_model(compute):
    return DLRMModel(DLRMConfig(
        embedding_dim=128, table_sizes=V2_TABLES,
        mlp_bot=(13, 512, 256, 128), mlp_top=(1024, 1024, 512, 256, 1),
        interaction="dot", loss="bce",
        num_indices_per_lookup=max(V2_HOT_SIZES), compute_dtype=compute))


def p9_batch(step):
    """Global batch `step` of phase 9, drawn from a seed on every rank."""
    return ragged_multihot_batch(np.random.default_rng(900 + step), 13,
                                 V2_TABLES, V2_HOT_SIZES, BATCH)


def p9_stripe_kw(msize):
    if msize == 2:
        return {"rw_threshold": 100_000}
    # more shards: the capacity that stripes the fewest tables
    return {"capacity_rows": -(-sum(V2_TABLES) // msize)
            + (V2_TABLES[0] // msize) // 2}


def p9_butterfly(name, model, mesh, dev, bf16):
    from dlrm_tpu_torch.parallel.stream_butterfly import StreamButterfly

    plan = P9_PLANS[name]
    kw = dict(batch_size=BATCH, hot_sizes=V2_HOT_SIZES, device=dev,
              table_dtype=torch.bfloat16 if bf16 else torch.float32,
              mm_dtype=torch.bfloat16 if bf16 else torch.float32)
    if plan.get("stripe"):
        kw.update(p9_stripe_kw(mesh.msize))
    if plan.get("shared"):
        kw.update(rw_shared_cap="auto",
                  rw_spill=max(6, max(V2_HOT_SIZES) // mesh.msize + 2))
    return StreamButterfly(model, mesh, **kw)


class K2Hold:
    """Patches the sharded step's K2 (stream_butterfly.stream_update): its
    first call also runs stream_update_plain on copies of the same inputs,
    which must give the same table and accumulator bit for bit. The
    kernel's launch is the wrapper's own; the plain version counts none."""

    def __init__(self, tag):
        self.tag, self.done = tag, None

    def __enter__(self):
        from dlrm_tpu_torch.parallel import stream_butterfly as sbm

        self.mod, self.real = sbm, sbm.stream_update

        def held(optimizer, plan, table, acc, g_u, *args, **kw):
            if self.done is not None:
                return self.real(optimizer, plan, table, acc, g_u, *args,
                                 **kw)
            t0 = table.clone()
            a0 = None if acc is None else acc.clone()
            out = self.real(optimizer, plan, table, acc, g_u, *args, **kw)
            ref = stream_update_plain(optimizer, plan, t0, a0, g_u, *args,
                                      **kw)
            self.done = compare_update(
                self.tag, ref[0], out[0], *((ref[1], out[1])
                                            if acc is not None else ()))
            return out

        sbm.stream_update = held
        return self

    def __exit__(self, *exc):
        self.mod.stream_update = self.real


def p9_table_err(sb, params, ref):
    """(max of |got - ref| - rtol |ref| over this shard's rows, max abs)
    against the single-card run's unpadded fp32 tables `ref` (mmap)."""
    local = params["emb"]["stacked"]
    offs = np.concatenate([[0], np.cumsum(V2_TABLES)[:-1]])
    worst, max_abs = -np.inf, 0.0
    pieces = []
    for j, t in enumerate(sb.shard_tables[sb.m]):
        if t < len(V2_TABLES):
            pieces.append((sb.plan.padded_offsets[j], int(offs[t]),
                           V2_TABLES[t]))
    for i, t in enumerate(sb.rw_ids):
        sl = int(sb.rw_slice[i])
        lo, hi = sb.m * sl, min(V2_TABLES[int(t)], (sb.m + 1) * sl)
        pieces.append((sb.plan.padded_offsets[sb.t_local + i],
                       int(offs[int(t)]) + lo, hi - lo))
    for dst, src, n in pieces:
        want = torch.from_numpy(np.ascontiguousarray(
            ref[src: src + n])).to(local.device)
        d = (local[dst: dst + n] - want).abs()
        worst = max(worst, float((d - P9_TOL["tables"][0]
                                   * want.abs()).max()))
        max_abs = max(max_abs, float(d.max()))
    return worst, max_abs


def p9_step_rank(rank, world, staged, refs):
    """Phase 9a on one rank: for each plan, the fp32 step with each
    optimizer of P9_FP32 (3 steps from the single-card run's init and
    batches, its losses, tables and dense params then held to that run's,
    `refs`) and the bf16 step with SR (P9_BF16_STEPS: losses, K2 launches,
    spans, synchronizing calls, shard_batch's host time, peak memory)."""
    from dlrm_tpu_torch.parallel.mesh import make_mesh

    dev = p9_rank_device(rank, staged)
    mesh = make_mesh(data=1, model=world, stage=staged)
    out = {}
    for name in P9_PLANS:
        res = {}
        pieces = None  # the plan's sharded batches, read by both fp32 runs
        for opt, (lr, _) in P9_FP32.items():
            ref_losses, tables, dense = refs[opt]
            sb = p9_butterfly(name, p9_model("float32"), mesh, dev, False)
            if pieces is None:
                pieces = [sb.shard_batch(p9_batch(i))
                          for i in range(P9_FP32_STEPS)]
            params = sb.init_params(seed=0)
            st = sb.init_opt_state(opt, params)
            step = sb.make_train_step(opt, BATCH, params, st)
            losses = []
            with K2Hold(f"phase 9a {name} fp32 {opt} rank {rank} K2"):
                for b in pieces:
                    params, st, loss, _ = step(params, st, b, lr)
                    losses.append(loss)
            log(f"phase 9a rank {rank}: {name} fp32 {opt} done")
            res[opt] = {
                "losses": [float(x) for x in losses], "ref": ref_losses,
                "tables": p9_table_err(sb, params,
                                       np.load(tables, mmap_mode="r")),
                "dense": p9_dense_err(params, dense)}
            res["num_rw"] = sb.num_rw
            del params, st, step, sb
            torch.cuda.empty_cache()
        del pieces

        sb = p9_butterfly(name, p9_model("bfloat16"), mesh, dev, True)
        params = sb.init_params(seed=0)
        st = sb.init_opt_state("rwsadagrad", params)
        step = sb.make_train_step("rwsadagrad", BATCH, params, st)
        batches = [p9_batch(100 + i) for i in range(P9_BF16_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        losses, spans, syncs, host = [], [], [], []
        with K2Hold(f"phase 9a {name} bf16/SR rank {rank} K2") as hold:
            for hb in batches:
                t0 = time.perf_counter()
                b = sb.shard_batch(hb)
                host.append((time.perf_counter() - t0) * 1e3)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                caught = []
                ev[0].record()
                with main_thread_syncs(caught):
                    params, st, loss, _ = step(params, st, b, LR)
                ev[1].record()
                spans.append(ev)
                syncs.append(caught)
                losses.append(loss)
        torch.cuda.synchronize()
        res.update(
            bf16_losses=[float(x) for x in losses],
            launches=dict(LAUNCHES),
            spans=[a.elapsed_time(b) for a, b in spans],
            syncs=[len(c) for c in syncs],
            sync_msgs=sorted({m for c in syncs[1:] for m in c}),
            host_ms=host, peak=torch.cuda.max_memory_allocated(),
            bf16_k2=hold.done["max_abs"],
        )
        del params, st, step, sb, batches
        torch.cuda.empty_cache()
        log(f"phase 9a rank {rank}: {name} bf16 done")
        out[name] = res
    return out


def p9_reference(root, optimizer):
    """The single-card stream step (the gather path) with fp32 tables and
    an fp32 tower on phase 9's first 3 batches, from init_params(seed=0),
    at P9_FP32[optimizer]'s learning rate: its losses; its final unpadded
    tables and dense params saved under `root`. Returns (losses, path of
    the tables, path of the dense params)."""
    from dlrm_tpu_torch.train.stream_step import unpad_params

    model = p9_model("float32")
    plan = plan_for_model(model, BATCH, block_rows=2048,
                          hot_sizes=V2_HOT_SIZES)
    params = pad_params(model.init_params(seed=0, device=CUDA), model, plan)
    st = init_stream_opt_state(optimizer, params, plan)
    step = make_stream_train_step(model, optimizer, plan,
                                  grad_impl="gather", mm_dtype=torch.float32)
    losses = []
    for i in range(P9_FP32_STEPS):
        b = p9_batch(i).with_stream_work(
            plan, update_touched_only=True).to_device(
                CUDA, flat_hots=plan.hot)
        params, st, loss, _ = step(params, st, b, P9_FP32[optimizer][0])
        losses.append(loss)
    tables = os.path.join(root, f"p9_{optimizer}_tables.npy")
    dense = os.path.join(root, f"p9_{optimizer}_dense.npz")
    np.save(tables, unpad_params(params, model, plan)["emb"][
        "stacked"].cpu().numpy())
    np.savez(dense, *[t.cpu().numpy() for t in tree_leaves(
        {k: v for k, v in params.items() if k != "emb"})])
    del params, st
    torch.cuda.empty_cache()
    return [float(x) for x in losses], tables, dense


def p9_dense_err(params, path):
    """(max of |got - ref| - rtol |ref|, max abs, elements beyond rtol /
    atol) of the dense params against the reference's."""
    ref = np.load(path)
    got = tree_leaves({k: v for k, v in params.items() if k != "emb"})
    worst, max_abs, n_out = -np.inf, 0.0, 0
    for i, g in enumerate(got):
        want = torch.from_numpy(ref[f"arr_{i}"]).to(g.device)
        d = (g - want).abs()
        rtol, atol = P9_TOL["dense"]
        over = d - rtol * want.abs()
        worst = max(worst, float(over.max()))
        max_abs = max(max_abs, float(d.max()))
        n_out += int((over > atol).sum())
    return worst, max_abs, n_out


def p9_trainer_rank(rank, world, staged, argv):
    """Phase 9b on one rank: v2_main.main(argv) with its train step's
    spans (CUDA events), K2's launches and peak memory."""
    from dlrm_tpu_torch.parallel.stream_butterfly import StreamButterfly

    dev = p9_rank_device(rank, staged)
    real = StreamButterfly.make_train_step
    spans = []

    def make(self, *a, **kw):
        step = real(self, *a, **kw)

        def probed(params, opt_state, batch, lr):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(params, opt_state, batch, lr)
            ev[1].record()
            spans.append(ev)
            return out

        return probed

    StreamButterfly.make_train_step = make
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = v2_main.main(argv, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    return {"rc": rc, "out": buf.getvalue(), "launches": launches,
            "spans": [a.elapsed_time(b) for a, b in spans], "wall": wall,
            "peak": torch.cuda.max_memory_allocated()}


def p9a(root, world, backend, staged):
    from dlrm_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    refs = {opt: p9_reference(root, opt) for opt in P9_FP32}
    for opt, (lr, _) in P9_FP32.items():
        log(f"phase 9a: the single-card reference (fp32 tables and tower, "
            f"{opt} at lr {lr}, {P9_FP32_STEPS} steps): losses "
            + " ".join(f"{x:.6f}" for x in refs[opt][0]))
    log(f"phase 9a: references in {time.perf_counter() - t0:.1f} s")
    ranks = run_ranks(p9_step_rank, world, args=(world, staged, refs),
                      backend=backend, timeout_s=600)
    for _, tables, dense in refs.values():
        os.remove(tables)
        os.remove(dense)
    # every figure is printed first, then held: a failing check still
    # leaves the whole phase's numbers in the log
    launches = {}
    for name in P9_PLANS:
        rs = [r[name] for r in ranks]
        tag = f"phase 9a {name}"
        launches[f"9a {name}"] = sum(r["launches"]["stream_update"]
                                     for r in rs)
        log(f"{tag}: {rs[0]['num_rw']} of {len(V2_TABLES)} tables striped "
            f"over {world} shards; K2's first call on every rank of every "
            "run below bit-identical to its plain version")
        for opt, (lr, held) in P9_FP32.items():
            log(f"{tag}: fp32 {opt} lr {lr}, {P9_FP32_STEPS} steps: rank "
                "0's losses " + " ".join(f"{x:.6f}" for x in rs[0][opt][
                    "losses"]) + ", the single card's " + " ".join(
                    f"{x:.6f}" for x in rs[0][opt]["ref"]) + "; "
                + ("held to" if held else "reported against")
                + " rtol / atol {}: tables max abs ".format(P9_TOL)
                + ", ".join(f"{r[opt]['tables'][1]:.3e}" for r in rs)
                + "; dense max abs "
                + ", ".join(f"{r[opt]['dense'][1]:.3e} ({r[opt]['dense'][2]}"
                            " elements beyond)" for r in rs)
                + " by rank")
        log(f"{tag}: bf16 tables, SR, {P9_BF16_STEPS} steps: rank 0's "
            "losses " + " ".join(f"{x:.6f}" for x in rs[0]["bf16_losses"])
            + "; K2 launches by rank "
            + str([r["launches"]["stream_update"] for r in rs]))
        for i, r in enumerate(rs):
            sp = r["spans"][1:]
            log(f"{tag} rank {i}: span per step median "
                f"{float(np.median(sp)):.2f} ms (min {min(sp):.2f}, max "
                f"{max(sp):.2f}; first {r['spans'][0]:.2f}); shard_batch "
                f"host ms per batch median "
                f"{float(np.median(r['host_ms'])):.1f}; peak "
                f"{r['peak'] / 2**30:.2f} GiB; synchronizing calls per step "
                f"past the first {sum(r['syncs'][1:]) / (len(sp)):.2f}"
                + ("" if not r["sync_msgs"] else " (" + "; ".join(
                    r["sync_msgs"][:4]) + ")"))
    for name in P9_PLANS:
        rs = [r[name] for r in ranks]
        tag = f"phase 9a {name}"
        for i, r in enumerate(rs):
            for opt, (lr, held) in P9_FP32.items():
                f32 = r[opt]
                check(np.allclose(f32["losses"], f32["ref"], rtol=1e-5,
                                  atol=0), f"{tag}: rank {i} fp32 {opt} "
                      f"losses {f32['losses']} vs the single card's "
                      f"{f32['ref']}")
                if held:
                    for what, (rtol, atol) in P9_TOL.items():
                        check(f32[what][0] <= atol, f"{tag}: rank {i} "
                              f"fp32 {opt} {what} beyond rtol {rtol} + "
                              f"atol {atol} of the single card's (max abs "
                              f"{f32[what][1]:.3e})")
            check(all(math.isfinite(x) for x in r["bf16_losses"]),
                  f"{tag}: rank {i} bf16 losses {r['bf16_losses']}")
            check(r["bf16_losses"] == rs[0]["bf16_losses"],
                  f"{tag}: rank {i} loss differs from rank 0's")
            k2 = r["launches"]["stream_update"]
            check(k2 == P9_BF16_STEPS, f"{tag}: rank {i} launched K2 {k2} "
                  f"times in {P9_BF16_STEPS} steps")
            others = {k: v for k, v in r["launches"].items()
                      if v and k != "stream_update"}
            check(not others, f"{tag}: kernels off this path: {others}")
            if not staged:
                check(sum(r["syncs"][1:]) == 0, f"{tag}: rank {i} "
                      f"synchronizing calls past the first step: "
                      f"{r['syncs']} {r['sync_msgs']}")
    return launches


def p9b(data, world, backend, staged):
    from dlrm_tpu_torch.parallel.launch import run_ranks

    # bf16 tables (2 B a column) + the rwsadagrad row accumulator (4 B):
    # a budget just under the ideal per-shard load stripes
    rows = -(-sum(V2_TABLES) // world) - V2_TABLES[0] // (2 * world)
    hbm_gb = rows * (128 * 2 + 4) / 0.7 / 2**30
    argv = v2_argv(BATCH, P9B_LIMITS, data) + [
        "--sharded", "--rw_bucket", "shared", "--hbm_gb", f"{hbm_gb:.6f}",
        "--allow_capacity_overflow", "--mesh_data", "1",
        "--mesh_model", str(world)]
    ranks = run_ranks(p9_trainer_rank, world, args=(world, staged, argv),
                      backend=backend, timeout_s=600)
    out = ranks[0]["out"]
    tag = "phase 9b"
    for i, r in enumerate(ranks):
        check(r["rc"] == 0, f"{tag}: rank {i} returned {r['rc']}")
        check(r["launches"]["stream_update"] == len(r["spans"]),
              f"{tag}: rank {i} K2 launches {r['launches']} in "
              f"{len(r['spans'])} steps")
        check(i == 0 or r["out"] == "", f"{tag}: rank {i} printed")
    plan = re.search(r"^sharded stream-butterfly over .*$", out, re.M)
    check(plan is not None, f"{tag}: no plan line")
    m = re.search(r"Epoch 0: (\d+) samples in \S+ \(([\d,]+) samples/s\), "
                  r"final loss (\S+)", out)
    check(m is not None and math.isfinite(float(m.group(3))),
          f"{tag}: no finite epoch line")
    auroc = dict(re.findall(r"AUROC over (\w+) set: (\S+)", out))
    for stage in ("val", "test"):
        check(stage in auroc and 0.0 <= float(auroc[stage]) <= 1.0,
              f"{tag}: {stage} AUROC {auroc.get(stage)}")
    bucket = re.search(r"^rw bucketing: .*$", out, re.M)
    log(f"{tag}: v2_main --sharded --rw_bucket shared --hbm_gb "
        f"{hbm_gb:.6f} over {world} ranks: {plan.group(0)}; "
        f"{bucket.group(0) if bucket else 'no bucketing line'}; "
        f"{m.group(1)} samples, {m.group(2)} samples/s as rank 0 prints "
        f"it, final loss {float(m.group(3)):.6f}, val AUROC "
        f"{auroc['val']}, test AUROC {auroc['test']}")
    for i, r in enumerate(ranks):
        sp = r["spans"][1:]
        log(f"{tag} rank {i}: main() {r['wall']:.1f} s; {len(r['spans'])} "
            f"steps, K2 launched {r['launches']['stream_update']} times; "
            f"span per step median {float(np.median(sp)):.2f} ms (first "
            f"{r['spans'][0]:.2f}); peak {r['peak'] / 2**30:.2f} GiB")
    return {"9b": sum(r["launches"]["stream_update"] for r in ranks)}


def phase_sharded(root, data_v2):
    """Phase 9: the sharded stream path over W ranks."""
    t_phase = time.perf_counter()
    world, backend, staged = p9_world()
    log(f"phase 9: {world} ranks over {backend}"
        + (" with each collective staged through host memory" if staged
           else "") + f", {torch.cuda.device_count()} card(s): "
        + ("all ranks share cuda:0" if staged else "one card per rank"))
    launches = p9a(root, world, backend, staged)
    launches.update(p9b(data_v2, world, backend, staged))
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------- phase 10
# the fused butterfly (parallel/butterfly.py: coalesce_rows and
# row_scatter_add on every shard) over W ranks: 10a the step in three plans
# against the single card, 10b the data axis, 10c v2_main --sharded
# --embedding_impl fused, 10d the v1 trainer's --sharded
P10_SGD_STEPS = 3
P10_RWS_STEPS = 3
P10B_BATCH = 2048
P10_PLANS = {
    "table-wise": {"strategy": "table_wise"},
    "table-wise+cw": {"strategy": "table_wise", "cw_tables": [0, 1]},
    "striped+bucket": {"stripe": True},
}
# 10c's depth, as 9b's
P10C_LIMITS = {"train": 4, "val": 1, "test": 1}
P10D_STEPS = 10


def p10_batch(step, b=BATCH):
    """Global batch `step` of phase 10, drawn from a seed on every rank."""
    return ragged_multihot_batch(np.random.default_rng(1000 + step), 13,
                                 V2_TABLES, V2_HOT_SIZES, b)


def p10_butterfly(name, model, mesh, dev):
    """The plan's ButterflyDLRM: table-wise (LPT), table-wise with tables
    0 and 1 column-wise, or every table striped (a capacity just under the
    per-shard load, as 9b's, which no plan meets on 2 shards) with per-table
    owner bucketing (v2_main's caps and spill)."""
    from dlrm_tpu_torch.parallel.butterfly import ButterflyDLRM
    from dlrm_tpu_torch.parallel.rw_bucket import default_bucket_caps

    plan = dict(P10_PLANS[name])
    kw = dict(hot_sizes=V2_HOT_SIZES, device=dev)
    if plan.pop("stripe", False):
        m = mesh.msize
        kw.update(strategy="mixed", allow_capacity_overflow=True,
                  capacity_rows=-(-sum(V2_TABLES) // m) - V2_TABLES[0]
                  // (2 * m))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rw = ButterflyDLRM(model, mesh, **kw).rw_ids
        hots = [V2_HOT_SIZES[int(t)] for t in rw]
        kw.update(rw_bucket_caps=default_bucket_caps(hots, m),
                  rw_spill=max(4, max(hots) // m + 2))
    kw.update(plan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ButterflyDLRM(model, mesh, **kw)


def p10_lr(b):
    """The fp32 SGD runs' learning rate at batch b: 1.0 at 16,384 (as
    phase 9's), scaled with the batch so that a hit moves its row as much
    at any batch (a row's update, lr / b of its cotangent, dwarfs the
    tables' atol, so a lost or doubled hit shows). At batch 2,048 lr 1.0
    grows the tower's rounding past the dense tolerance on a 1 x 2 grid as
    on a 2 x 2 one; 10b reports both."""
    return 1.0 * b / BATCH


def p10_permuted(hb, seed=7):
    """The batch with its rows in another (seeded) order: the same loss
    and gradients, summed in another order."""
    perm = np.random.default_rng(seed).permutation(hb.dense.shape[0])
    return dataclasses.replace(hb, dense=hb.dense[perm], idx=hb.idx[:, perm],
                               wt=None if hb.wt is None else hb.wt[:, perm],
                               labels=hb.labels[perm])


def p10_save_dense(params, path):
    np.savez(path, *[t.cpu().numpy() for t in tree_leaves(
        {k: v for k, v in params.items() if k != "emb"})])


def p10_reference(root, b, tag, lr=None, permute=False):
    """The single-card fused step with fp32 tables and tower, SGD at lr
    (None: p10_lr(b)), on phase 10's first 3 batches of b rows (permute:
    each with its rows reordered) from init_params(seed=0): its losses;
    its final tables, final dense params and the dense params after each
    step saved under `root` (the last two: paths, a list of paths)."""
    lr = p10_lr(b) if lr is None else lr
    model = p9_model("float32")
    params = model.init_params(seed=0, device=CUDA)
    st = init_opt_state("sgd", params)
    step = make_fused_train_step(model, "sgd", hot_sizes=V2_HOT_SIZES)
    losses, steps = [], []
    for i in range(P10_SGD_STEPS):
        hb = p10_batch(i, b)
        if permute:
            hb = p10_permuted(hb)
        batch = hb.to_device(CUDA, flat_hots=V2_HOT_SIZES)
        params, st, loss, _ = step(params, st, batch, lr)
        losses.append(loss)
        steps.append(os.path.join(root, f"p10_{tag}_dense_{i}.npz"))
        p10_save_dense(params, steps[-1])
    tables = os.path.join(root, f"p10_{tag}_tables.npy")
    dense = os.path.join(root, f"p10_{tag}_dense.npz")
    np.save(tables, params["emb"]["stacked"].cpu().numpy())
    p10_save_dense(params, dense)
    del params, st
    torch.cuda.empty_cache()
    return [float(x) for x in losses], tables, dense, steps


def p10_gap_where(params, path, thresh=1e-6):
    """Where the dense params lie more than `thresh` from the saved ones:
    "leaf [shape]: n elements over, in columns [...] (2-D leaves), max
    abs" for each leaf that has any. A ReLU unit j whose pre-activation for
    one sample sits within rounding of 0, and falls on the other side in
    one of two runs, moves only column j of its layer's weight gradient
    (and bias element j) by that sample's share, 1/B of its terms."""
    from dlrm_tpu_torch.optim.optimizers import tree_map_with_path

    ref = np.load(path)
    leaves = []  # in tree_leaves' order, which the saved arrays follow
    tree_map_with_path(lambda at, x: leaves.append(
        ("/".join(map(str, at)), x)),
        {k: v for k, v in params.items() if k != "emb"})
    out = []
    for i, (name, g) in enumerate(leaves):
        d = (g - torch.from_numpy(ref[f"arr_{i}"]).to(g.device)).abs()
        over = d > thresh
        n = int(over.sum())
        if not n:
            continue
        cols = ""
        if d.dim() == 2:
            c = sorted(set(over.nonzero()[:, 1].tolist()))
            cols = f" in {len(c)} column(s) {c[:6]}"
        out.append(f"{name} {list(g.shape)}: {n} over{cols}, max abs "
                   f"{float(d.max()):.3e}")
    return out


def p10_remove(ref):
    for path in [ref[1], ref[2], *ref[3]]:
        os.remove(path)


def p10_dense_gaps(a, b):
    """Max abs of the dense params' difference after each step, between
    two p10_reference runs' saved files."""
    out = []
    for pa, pb in zip(a[3], b[3]):
        za, zb = np.load(pa), np.load(pb)
        out.append(max(float(np.abs(za[k] - zb[k]).max()) for k in za))
    return out


def p10_table_err(bf, params, ref):
    """(max of |got - ref| - rtol |ref|, max abs) of this rank's block and
    column-wise block against the single card's tables `ref` (mmap)."""
    offs = np.concatenate([[0], np.cumsum(V2_TABLES)[:-1]])
    rtol = P9_TOL["tables"][0]
    worst, max_abs = -np.inf, 0.0
    pieces = [(params["emb"]["stacked"], dst, int(offs[t]) + lo, hi - lo,
               slice(None)) for t, lo, hi, dst in bf._pieces()]
    cols = slice(bf.m * bf.dm, (bf.m + 1) * bf.dm)
    for t, off in zip(bf.placement.cw_ids, bf.placement.cw_offsets):
        pieces.append((params["emb"]["cw_stacked"], off, int(offs[t]),
                       V2_TABLES[t], cols))
    for local, dst, src, n, c in pieces:
        want = torch.from_numpy(np.ascontiguousarray(
            ref[src: src + n, c])).to(local.device)
        d = (local[dst: dst + n] - want).abs()
        worst = max(worst, float((d - rtol * want.abs()).max()))
        max_abs = max(max_abs, float(d.max()))
    return worst, max_abs


def p10_per_step(bf):
    """Launches of each fused kernel per step: one for the row block, one
    more for the column-wise block."""
    return 2 if bf.num_cw else 1


def p10_step_rank(rank, world, staged, refs, data, b, plans, rws,
                  lr=None):
    """10a (10b: data 2 x model 2, batch b, no rwsadagrad run) on one rank:
    for each plan, 3 fp32 SGD steps (at lr, None: p10_lr(b)) compared with
    the single card's run `refs`, then (rws) P10_RWS_STEPS rwsadagrad
    steps with the bf16 tower: losses, launches, each fused kernel's first
    calls held to its plain version, spans, synchronizing calls,
    shard_batch's host ms, peak memory."""
    lr = p10_lr(b) if lr is None else lr
    from dlrm_tpu_torch.parallel.mesh import make_mesh

    dev = p9_rank_device(rank, staged)
    mesh = make_mesh(data=data, model=world // data, stage=staged)
    out = {}
    for name in plans:
        ref_losses, tables, dense, dense_steps = refs
        bf = p10_butterfly(name, p9_model("float32"), mesh, dev)
        params = bf.init_params(seed=0)
        st = init_opt_state("sgd", params)
        step = bf.make_train_step("sgd", b, params, st)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        losses, gaps = [], []
        hold = FusedHold(f"phase 10 {name} fp32 sgd rank {rank}", first=2)
        with hold:
            for i in range(P10_SGD_STEPS):
                params, st, loss, _ = step(params, st,
                                           bf.shard_batch(p10_batch(i, b)),
                                           lr)
                losses.append(loss)
                gaps.append(p9_dense_err(params, dense_steps[i])[1])
                if i == 0:
                    where = p10_gap_where(params, dense_steps[0])
        hold.hold()
        res = {"sgd": {
            "losses": [float(x) for x in losses], "ref": ref_losses,
            "tables": p10_table_err(bf, params,
                                    np.load(tables, mmap_mode="r")),
            "dense": p9_dense_err(params, dense), "dense_steps": gaps,
            "where_step1": where,
            "launches": dict(LAUNCHES)},
            "num_rw": bf.num_rw, "num_cw": bf.num_cw,
            "per_step": p10_per_step(bf)}
        del params, st, step, bf
        torch.cuda.empty_cache()
        log(f"phase 10 rank {rank}: {name} fp32 sgd done")
        if rws:
            res.update(p10_rws(rank, name, mesh, dev))
        out[name] = res
    return out


def p10_rws(rank, name, mesh, dev):
    """P10_RWS_STEPS rwsadagrad steps of the plan with the bf16 tower (fp32
    tables, as the fused butterfly keeps them): the figures p10_step_rank
    lists."""
    bf = p10_butterfly(name, p9_model("bfloat16"), mesh, dev)
    params = bf.init_params(seed=0)
    st = init_opt_state("rwsadagrad", params)
    step = bf.make_train_step("rwsadagrad", BATCH, params, st)
    batches = [p10_batch(100 + i) for i in range(P10_RWS_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    losses, spans, syncs, host = [], [], [], []
    hold = FusedHold(f"phase 10a {name} rwsadagrad rank {rank}", first=2)
    with hold:
        for hb in batches:
            t0 = time.perf_counter()
            batch = bf.shard_batch(hb)
            host.append((time.perf_counter() - t0) * 1e3)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            caught = []
            ev[0].record()
            with main_thread_syncs(caught):
                params, st, loss, _ = step(params, st, batch, LR)
            ev[1].record()
            spans.append(ev)
            syncs.append(caught)
            losses.append(loss)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    hold.hold()
    out = dict(
        rws_losses=[float(x) for x in losses], launches=launches,
        spans=[a.elapsed_time(b) for a, b in spans],
        syncs=[len(c) for c in syncs],
        sync_msgs=sorted({m for c in syncs[1:] for m in c}),
        host_ms=host, peak=torch.cuda.max_memory_allocated())
    del params, st, step, bf, batches
    torch.cuda.empty_cache()
    log(f"phase 10a rank {rank}: {name} rwsadagrad done")
    return out


def p10_hold_sgd(tag, rs, b):
    """Logs, then holds, each rank's fp32 SGD run to the single card's."""
    log(f"{tag}: fp32 sgd lr {p10_lr(b)}, {P10_SGD_STEPS} steps: rank 0's "
        "losses "
        + " ".join(f"{x:.6f}" for x in rs[0]["sgd"]["losses"])
        + ", the single card's " + " ".join(
            f"{x:.6f}" for x in rs[0]["sgd"]["ref"])
        + "; held to rtol / atol {}: tables max abs ".format(P9_TOL)
        + ", ".join(f"{r['sgd']['tables'][1]:.3e}" for r in rs)
        + "; dense max abs " + ", ".join(
            f"{r['sgd']['dense'][1]:.3e}" for r in rs) + " by rank; rank "
        "0's dense max abs after each step " + ", ".join(
            f"{x:.3e}" for x in rs[0]["sgd"]["dense_steps"]))
    for i, r in enumerate(rs):
        f32 = r["sgd"]
        check(np.allclose(f32["losses"], f32["ref"], rtol=1e-5, atol=0),
              f"{tag}: rank {i} fp32 losses {f32['losses']} vs the single "
              f"card's {f32['ref']}")
        for what, (rtol, atol) in P9_TOL.items():
            check(f32[what][0] <= atol, f"{tag}: rank {i} fp32 {what} "
                  f"beyond rtol {rtol} + atol {atol} of the single card's "
                  f"(max abs {f32[what][1]:.3e})")
        n = P10_SGD_STEPS * r["per_step"]
        for k in FUSED:
            check(f32["launches"][k] == n, f"{tag}: rank {i} launched {k} "
                  f"{f32['launches'][k]} times in {P10_SGD_STEPS} steps")


def p10a(root, world, backend, staged):
    from dlrm_tpu_torch.parallel.launch import run_ranks

    ref = p10_reference(root, BATCH, "a")
    log(f"phase 10a: the single-card fused step (fp32 tables and tower, "
        f"sgd at lr {p10_lr(BATCH)}, {P10_SGD_STEPS} steps): losses "
        + " ".join(f"{x:.6f}" for x in ref[0]))
    ranks = run_ranks(p10_step_rank, world,
                      args=(world, staged, ref, 1, BATCH, list(P10_PLANS),
                            True),
                      backend=backend, timeout_s=900)
    p10_remove(ref)
    launches = {}
    for name in P10_PLANS:
        rs = [r[name] for r in ranks]
        tag = f"phase 10a {name}"
        per = rs[0]["per_step"]
        launches[f"10a {name}"] = {k: sum(r["launches"][k] for r in rs)
                                   for k in FUSED}
        log(f"{tag}: {rs[0]['num_rw']} striped and {rs[0]['num_cw']} "
            f"column-wise of {len(V2_TABLES)} tables over {world} shards; "
            "the first calls of coalesce_rows and row_scatter_add on every "
            "rank of both runs bit-identical to their plain versions")
        p10_hold_sgd(tag, rs, BATCH)
        log(f"{tag}: rwsadagrad, bf16 tower, {P10_RWS_STEPS} steps: rank "
            "0's losses " + " ".join(f"{x:.6f}" for x in rs[0][
                "rws_losses"]) + "; launches by rank " + str(
                    [{k: r["launches"][k] for k in FUSED} for r in rs]))
        for i, r in enumerate(rs):
            sp = r["spans"][1:]
            log(f"{tag} rank {i}: span per step median "
                f"{float(np.median(sp)):.2f} ms (min {min(sp):.2f}, max "
                f"{max(sp):.2f}; first {r['spans'][0]:.2f}); shard_batch "
                f"host ms per batch median "
                f"{float(np.median(r['host_ms'])):.1f}; peak "
                f"{r['peak'] / 2**30:.2f} GiB; synchronizing calls per step "
                f"past the first {sum(r['syncs'][1:]) / len(sp):.2f}"
                + ("" if not r["sync_msgs"] else " (" + "; ".join(
                    r["sync_msgs"][:4]) + ")"))
        for i, r in enumerate(rs):
            check(all(math.isfinite(x) for x in r["rws_losses"]),
                  f"{tag}: rank {i} rwsadagrad losses {r['rws_losses']}")
            check(r["rws_losses"] == rs[0]["rws_losses"],
                  f"{tag}: rank {i} loss differs from rank 0's")
            for k in FUSED:
                n = r["launches"][k]
                check(n == P10_RWS_STEPS * per, f"{tag}: rank {i} launched "
                      f"{k} {n} times in {P10_RWS_STEPS} steps")
            others = {k: v for k, v in r["launches"].items()
                      if v and k not in FUSED}
            check(not others, f"{tag}: kernels off this path: {others}")
            if not staged:
                check(sum(r["syncs"][1:]) == 0, f"{tag}: rank {i} "
                      f"synchronizing calls past the first step: "
                      f"{r['syncs']} {r['sync_msgs']}")
    return launches


def p10b(root):
    """10b: 4 ranks (data 2 x model 2) at batch 2,048, the table-wise plan
    with tables 0 and 1 column-wise: 3 fp32 SGD steps against the single
    card (at p10_lr's batch-scaled rate), so the all-gathers over "data"
    run."""
    from dlrm_tpu_torch.parallel.launch import run_ranks

    nccl = torch.cuda.device_count() >= 4
    backend, staged = ("nccl", False) if nccl else ("gloo", True)
    ref = p10_reference(root, P10B_BATCH, "b")
    ranks = run_ranks(p10_step_rank, 4,
                      args=(4, staged, ref, 2, P10B_BATCH,
                            ["table-wise+cw"], False),
                      backend=backend, timeout_s=600)
    rs = [r["table-wise+cw"] for r in ranks]
    tag = "phase 10b"
    log(f"{tag}: 4 ranks over {backend} (data 2 x model 2), batch "
        f"{P10B_BATCH}, tables 0 and 1 column-wise")
    p10_hold_sgd(tag, rs, P10B_BATCH)
    # ROADMAP C2, reported, not held: lr 1.0 at this batch on both grids
    # against the single card at lr 1.0, the dense gap after each step;
    # beside it, at both rates, the single card against itself with each
    # batch's rows reordered (an order-only change of every sum)
    ref1 = p10_reference(root, P10B_BATCH, "b1", lr=1.0)
    w2, b2, st2 = p9_world()
    for world, data, bk, stg in ((4, 2, backend, staged),
                                 (w2, 1, b2, st2)):
        got = run_ranks(p10_step_rank, world,
                        args=(world, stg, ref1, data, P10B_BATCH,
                              ["table-wise+cw"], False, 1.0),
                        backend=bk, timeout_s=600)
        r = got[0]["table-wise+cw"]["sgd"]
        log(f"{tag}: reported, lr 1.0 on a {data} x {world // data} grid: "
            f"losses " + " ".join(f"{x:.6f}" for x in r["losses"])
            + ", the single card's " + " ".join(f"{x:.6f}" for x in r[
                "ref"]) + f"; tables max abs {r['tables'][1]:.3e}, dense "
            f"max abs {r['dense'][1]:.3e} ({r['dense'][2]} elements beyond "
            "the tolerance); dense max abs after each step "
            + ", ".join(f"{x:.3e}" for x in r["dense_steps"])
            + "; after step 1, the dense elements more than 1e-6 off: "
            + ("; ".join(r["where_step1"]) or "none"))
    for lr, base in ((1.0, ref1), (p10_lr(P10B_BATCH), ref)):
        perm = p10_reference(root, P10B_BATCH, "bp", lr=lr, permute=True)
        log(f"{tag}: reported, the single card at lr {lr} against itself "
            "with each batch's rows reordered: losses " + " ".join(
                f"{x:.6f}" for x in perm[0]) + " against " + " ".join(
                f"{x:.6f}" for x in base[0]) + "; dense max abs after each "
            "step " + ", ".join(f"{x:.3e}" for x in p10_dense_gaps(perm,
                                                                   base)))
        p10_remove(perm)
    p10_remove(ref1)
    p10_remove(ref)
    return {"10b": {k: sum(r["sgd"]["launches"][k] for r in rs)
                    for k in FUSED}}


def p10_trainer_rank(rank, world, staged, entry, argvs):
    """10c/10d on one rank: entry (v2_main or cli).main on each argv with
    the fused butterfly's train steps probed (spans, losses), every launch
    count set to 0 just before and read just after; a --save-model run
    keeps a copy of each save's directory. held: the first calls of both
    fused kernels in the first run held to their plain versions."""
    from dlrm_tpu_torch.parallel.butterfly import ButterflyDLRM
    from dlrm_tpu_torch.parallel.multihost import barrier

    dev = p9_rank_device(rank, staged)
    mod = v2_main if entry == "v2" else cli
    real_save = harness.Trainer.save
    saves = []

    def save(self, state, path):
        real_save(self, state, path)
        if rank == 0:
            shutil.copytree(path, f"{path}_{state.total_iter}")
        saves.append(state.total_iter)
        barrier()

    results = []
    for j, argv in enumerate(argvs):
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        hold = (FusedHold(f"phase 10 {entry} rank {rank}", first=1)
                if j == 0 else contextlib.nullcontext())
        harness.Trainer.save = save
        probes = [StepProbe("make_train_step", ButterflyDLRM),
                  StepProbe("make_grad_accum_train_step", ButterflyDLRM)]
        t0 = time.perf_counter()
        try:
            with probes[0], probes[1], hold, contextlib.redirect_stdout(buf):
                rc = mod.main(argv, device=dev)
        finally:
            harness.Trainer.save = real_save
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        torch.cuda.synchronize()
        if j == 0:
            hold.hold()
        spans = probes[0].spans + probes[1].spans
        results.append({
            "rc": rc, "out": buf.getvalue(), "launches": launches,
            "spans": [a.elapsed_time(b) for a, b in spans],
            "losses": [float(x) for x in probes[0].losses
                       + probes[1].losses],
            "wall": wall, "peak": torch.cuda.max_memory_allocated(),
            "saves": saves[:]})
        saves.clear()
    return results


def p10_check_run(tag, ranks, per_step):
    """Every rank returned 0 and launched each fused kernel `per_step`
    times a step and nothing else; only rank 0 printed. Returns the
    launches summed over the ranks."""
    for i, r in enumerate(ranks):
        check(r["rc"] == 0, f"{tag}: rank {i} returned {r['rc']}")
        steps = len(r["spans"])
        check(steps > 0, f"{tag}: rank {i} ran no train step")
        for k in FUSED:
            check(r["launches"][k] == per_step * steps, f"{tag}: rank {i} "
                  f"{k} launched {r['launches'][k]} times in {steps} steps")
        others = {k: v for k, v in r["launches"].items()
                  if v and k not in FUSED}
        check(not others, f"{tag}: kernels off this path: {others}")
        check(i == 0 or r["out"] == "", f"{tag}: rank {i} printed")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"{tag}: rank {i} losses {r['losses']}")
        sp = r["spans"][1:] or r["spans"]
        log(f"{tag} rank {i}: main() {r['wall']:.1f} s; {steps} steps, "
            + ", ".join(f"{k} launched {r['launches'][k]} times"
                        for k in FUSED)
            + f"; span per step median {float(np.median(sp)):.2f} ms "
            f"(first {r['spans'][0]:.2f}); peak {r['peak'] / 2**30:.2f} GiB")
    return {k: sum(r["launches"][k] for r in ranks) for k in FUSED}


def p10c(data, world, backend, staged):
    from dlrm_tpu_torch.parallel.launch import run_ranks

    argv = v2_argv(BATCH, P10C_LIMITS, data, path=(
        "--embedding_impl", "fused")) + [
        "--sharded", "--column_wise_tables", "0,1", "--mesh_data", "1",
        "--mesh_model", str(world)]
    ranks = [r[0] for r in run_ranks(
        p10_trainer_rank, world, args=(world, staged, "v2", [argv]),
        backend=backend, timeout_s=600)]
    tag = "phase 10c"
    out = ranks[0]["out"]
    plan = re.search(r"^sharding plan: .*$", out, re.M)
    check(plan is not None, f"{tag}: no plan line")
    m = re.search(r"Epoch 0: (\d+) samples in \S+ \(([\d,]+) samples/s\), "
                  r"final loss (\S+)", out)
    check(m is not None and math.isfinite(float(m.group(3))),
          f"{tag}: no finite epoch line")
    auroc = dict(re.findall(r"AUROC over (\w+) set: (\S+)", out))
    for stage in ("val", "test"):
        check(stage in auroc and 0.0 <= float(auroc[stage]) <= 1.0,
              f"{tag}: {stage} AUROC {auroc.get(stage)}")
    log(f"{tag}: v2_main --sharded --embedding_impl fused "
        f"--column_wise_tables 0,1 over {world} ranks: {plan.group(0)}; "
        f"{m.group(1)} samples, {m.group(2)} samples/s as rank 0 prints it, "
        f"final loss {float(m.group(3)):.6f}, val AUROC {auroc['val']}, "
        f"test AUROC {auroc['test']}")
    return {"10c": p10_check_run(tag, ranks, 2)}


def p10d(root, world, backend, staged):
    """10d: cli.main --sharded at 8a's widths over the ranks: 10 steps
    with evaluations after steps 5 and 10 (the histogram summed over the
    ranks) and a per-shard checkpoint at each new best; a --load-model run
    from step 5's checkpoint, whose losses must equal the first run's;
    then --mlperf-grad-accum-iter 2 for 4 steps."""
    from dlrm_tpu_torch.parallel.launch import run_ranks

    ck = os.path.join(root, "p10d_ckpt")
    base = [a for a in V1_BENCH if not a.startswith(("--num-batches",
                                                     "--print-freq"))]
    base += ["--sharded", "--print-freq=1", "--round-targets=True",
             "--loss-function=bce", "--mlperf-logging",
             "--mlperf-auc-threshold=1.0"]
    half = P10D_STEPS // 2
    first = base + [f"--num-batches={P10D_STEPS}", f"--test-freq={half}",
                    f"--save-model={ck}"]
    accum = base + [f"--num-batches={4 * 2}", "--mlperf-grad-accum-iter=2"]
    run1 = run_ranks(p10_trainer_rank, world,
                     args=(world, staged, "cli", [first, accum]),
                     backend=backend, timeout_s=900)
    tag = "phase 10d"
    saves = run1[0][0]["saves"]
    check(saves and saves[0] == half,
          f"{tag}: no checkpoint at the first evaluation ({saves})")
    snap = f"{ck}_{half}"
    check(os.path.exists(os.path.join(snap, "sharding.json")),
          f"{tag}: the checkpoint has no per-shard manifest")
    resumed = base + [f"--num-batches={P10D_STEPS}", f"--test-freq={half}",
                      f"--load-model={snap}"]
    run2 = run_ranks(p10_trainer_rank, world,
                     args=(world, staged, "cli", [resumed]),
                     backend=backend, timeout_s=600)
    whole, again = [r[0] for r in run1], [r[0] for r in run2]
    out = whole[0]["out"]
    aucs = re.findall(r"Testing at - (\d+)/\d+ of epoch 0, accuracy (\S+) "
                      r"%, best \S+ %, auc (\S+), best auc (\S+)", out)
    check([int(a[0]) for a in aucs] == [half, P10D_STEPS],
          f"{tag}: evaluations {aucs}")
    for line in out.splitlines():
        if line.startswith(("sharding plan", "Testing at", "Saved model")):
            log(f"{tag}: | {line}")
    log(f"{tag}: per-shard checkpoint files "
        + ", ".join(sorted(os.listdir(snap))))
    launches = {"10d": p10_check_run(tag, whole, 1),
                "10d resumed": p10_check_run(f"{tag} resumed", again, 1),
                "10d accum": p10_check_run(f"{tag} grad accum",
                                           [r[1] for r in run1], 1)}
    check(f"Loaded model from {snap}: epoch 0 iteration {half}"
          in again[0]["out"], f"{tag}: the resumed run did not load")
    for i, (a, b) in enumerate(zip(whole, again)):
        check(a["losses"][half:] == b["losses"],
              f"{tag}: rank {i}: the resumed run's losses {b['losses']} "
              f"differ from the uninterrupted run's {a['losses'][half:]}")
    log(f"{tag}: resumed from step {half}'s per-shard checkpoint: the "
        f"losses of steps {half + 1}-{P10D_STEPS} equal the uninterrupted "
        f"run's bit for bit on every rank (last "
        f"{again[0]['losses'][-1]:.6f}); grad accum 2 x 4 steps: losses "
        + " ".join(f"{x:.6f}" for x in run1[0][1]["losses"]))
    return launches


def phase_fused_sharded(root, data_v2):
    """Phase 10: the fused butterfly over W ranks."""
    t_phase = time.perf_counter()
    world, backend, staged = p9_world()
    log(f"phase 10: {world} ranks over {backend}"
        + (" with each collective staged through host memory" if staged
           else "") + f", {torch.cuda.device_count()} card(s)")
    launches = p10a(root, world, backend, staged)
    log(f"phase 10a: {time.perf_counter() - t_phase:.1f} s")
    launches.update(p10b(root))
    launches.update(p10c(data_v2, world, backend, staged))
    launches.update(p10d(root, world, backend, staged))
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------- phase 11

P11_CPU_ROWS = 1024  # 11a's sub-batch for the CPU holds
P11_ROWS_HELD = 100_000  # 11a's table rows held to the numpy quantizer
# probabilities through a bf16 or int8 tower, card vs CPU: the fp32 sums of
# a product or of the interaction differ in order there, which can move a
# bf16 rounding or an int8 activation's rounding by a step
P11_TOWER_ATOL = 1e-2
P11_QUANT_ATOL = 1e-3  # quantized vs dequantized-fp32 tables, on the card
P11_CAP = 100_000  # 11c-e: the tables capped for the CPU and rank runs
P11C_BASE = [a for a in V1_BENCH if not a.startswith((
    "--num-batches", "--print-freq", "--print-time", "--compute-dtype"))]
P11C_BASE += ["--num-batches=4", "--inference-only", "--round-targets=True"]
P11C = {  # 11c's forms: argv (emb 4 and 8 bits, mlp 8 and 16, group-16)
    "emb 8, mlp 8": ["--quantize-emb-with-bit=8",
                     "--quantize-mlp-with-bit=8"],
    "emb 4, mlp 16": ["--quantize-emb-with-bit=4",
                      "--quantize-mlp-with-bit=16"],
    "emb 4 group-16, mlp 16": ["--quantize-emb-with-bit=4",
                               "--quantize-group16",
                               "--quantize-mlp-with-bit=16"],
}
ACC_LINE = re.compile(r"^Testing at .*$", re.M)


def p11_capped(argv, batches=2):
    """argv with every table capped at P11_CAP rows and `batches` batches."""
    out = []
    for a in argv:
        if a.startswith("--arch-embedding-size="):
            sizes = [min(int(n), P11_CAP) for n in a.split("=")[1].split("-")]
            a = "--arch-embedding-size=" + "-".join(map(str, sizes))
        elif a.startswith("--num-batches="):
            a = f"--num-batches={batches}"
        out.append(a)
    return out


class EvalProbe:
    """Records every probability the harness's eval steps return (on the
    host), in order."""

    def __enter__(self):
        self.real, self.probs = harness.make_eval_step, []

        def make(model, *a, **k):
            step = self.real(model, *a, **k)

            def eval_step(params, batch):
                p = step(params, batch)
                self.probs.append(p.float().cpu())
                return p

            return eval_step

        harness.make_eval_step = make
        return self

    def __exit__(self, *exc):
        harness.make_eval_step = self.real


def p11_cli(tag, argv, device=CUDA, quiet=True):
    """cli.main(argv, device) with every launch count set to 0 just before
    and read just after: (output, the eval probabilities, wall s, peak
    bytes). Fails unless it returns 0 with finite probabilities and no
    kernel of the port launched (serving is ATen work)."""
    if device == CUDA:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    buf = Tee(sys.stdout) if not quiet else Tee(io.StringIO())
    t0 = time.perf_counter()
    with EvalProbe() as ev, contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == CUDA else 0
    check(rc == 0, f"{tag}: cli.main returned {rc}")
    probs = torch.cat([p.reshape(-1) for p in ev.probs]) if ev.probs else None
    check(probs is not None and bool(torch.isfinite(probs).all()),
          f"{tag}: no or non-finite probabilities")
    launched = {k: v for k, v in LAUNCHES.items() if v}
    check(not launched, f"{tag}: kernels launched on the serving path: "
          f"{launched}")
    return buf.buf.getvalue(), probs, wall, peak


def p11_int8_sums(tag, fn):
    """Runs fn() with every int8 product on the card recorded, then holds
    each int32 result to the CPU's product of the same operands, bit for
    bit. Returns fn()'s result and the count of products held."""
    from dlrm_tpu_torch.ops import quantized as Q

    real, seen = Q.int8_matmul, []

    def record(a, b):
        out = real(a, b)
        if a.is_cuda:
            seen.append((a.cpu(), b.cpu(), out.cpu()))
        return out

    Q.int8_matmul = record
    try:
        res = fn()
    finally:
        Q.int8_matmul = real
    for a, b, out in seen:
        check(torch.equal(real(a, b), out), f"{tag}: the int8 product "
              f"{tuple(a.shape)} x {tuple(b.shape)}'s int32 sums differ "
              "from the CPU's")
    return res, len(seen)


def p11_dequantized(p, d):
    """The quantized stacked table of params p as fp32 rows on the card
    (ops/quantized.py::dequantize_table): the forward's dequantized-fp32
    counterpart."""
    from dlrm_tpu_torch.ops import quantized as Q

    packed = p["emb"]["quantized"]["packed"]
    bits = Q.infer_bits(p["emb"]["quantized"], d)
    deq = Q.dequantize_table({"packed": packed.cpu().numpy()}, bits)
    return dict(p, emb={"stacked": torch.from_numpy(deq).to(CUDA)})


def p11a():
    """11a: infer_bench's variants at bench.py's widths and batch 8,192
    (8 hits a bag): each timed (ms a batch, examples/s, forward peak), then
    held: the card's sub-batch forward against the CPU's (the pooled rows
    of a quantized table bit for bit, the probabilities through the bf16
    tower within P11_TOWER_ATOL), a quantized table's forward against its
    dequantized-fp32 table's on the card (pooled rtol 1e-5 / atol 1e-7,
    probabilities P11_QUANT_ATOL) and its first rows' bytes against the
    numpy quantize_table's, group-16 equal to rowwise bit for bit, the int8
    towers' int32 sums equal to the CPU's."""
    from dlrm_tpu_torch.ops import quantized as Q
    from dlrm_tpu_torch.probes import infer_bench as ib

    model = ib.bench_model()
    d = model.cfg.embedding_dim
    params = model.init_params(seed=0, device=CUDA)
    batch = ib.bench_batch(model, ib.BATCH, CUDA)
    hits = batch.idx.numel()
    n = P11_CPU_ROWS
    sub = Batch(batch.dense[:n], batch.idx[:, :n], None, None)
    sub_cpu = Batch(sub.dense.cpu(), sub.idx.cpu(), None, None)
    log(f"phase 11a: bench.py's model at batch {ib.BATCH}, {ib.HOT} hits a "
        f"bag ({hits} hits), bf16 compute; {ib.ITERS} forwards a form, the "
        "batch rotated before each")
    res, rowwise4 = {}, None
    for name, p in ib.variants(model, params):
        r = ib.run_variant(model, p, batch, CUDA)
        tag = f"phase 11a {name}"
        quant = "quantized" in p["emb"]
        with torch.no_grad():
            (probs, pooled), sums = p11_int8_sums(tag, lambda: (
                model.apply(p, sub), model.apply_emb(p, sub)))
            cpu_p = tree_map(lambda t: t.cpu(), p)
            probs_cpu = model.apply(cpu_p, sub_cpu)
            pooled_cpu = model.apply_emb(cpu_p, sub_cpu)
            del cpu_p
        err_cpu = float((probs.cpu() - probs_cpu).abs().max())
        check(err_cpu <= P11_TOWER_ATOL, f"{tag}: probabilities on the card "
              f"and the CPU differ by {err_cpu:.3e}")
        if quant:
            check(torch.equal(pooled.cpu(), pooled_cpu), f"{tag}: the "
                  "quantized lookup on the card differs from the CPU's")
        line = (f"{tag}: {r['ms']:.3f} ms a batch, "
                f"{r['examples_per_s']:.0f} examples/s, tables "
                f"{r['table_bytes']} B, forward peak "
                f"{r['forward_peak_bytes'] / 2**30:.3f} GiB; card vs CPU "
                f"({n} rows): probabilities max abs {err_cpu:.3e}"
                + (", pooled bit for bit" if quant else "")
                + (f", {sums} int8 products' int32 sums bit for bit"
                   if sums else ""))
        if quant and "packed" in p["emb"]["quantized"] and "w" in p["bot"][0]:
            # the tables quantized on the card: the numpy copy's bytes
            packed = p["emb"]["quantized"]["packed"]
            bits = Q.infer_bits(p["emb"]["quantized"], d)
            want = Q.quantize_table(params["emb"]["stacked"][:P11_ROWS_HELD]
                                    .cpu().numpy(), bits)["packed"]
            check(np.array_equal(packed[:P11_ROWS_HELD].cpu().numpy(), want),
                  f"{tag}: the card's packed rows differ from "
                  "quantize_table's")
            line += (f"; the first {P11_ROWS_HELD} packed rows equal "
                     "quantize_table's (numpy) bytes")
            deq = p11_dequantized(p, d)
            with torch.no_grad():
                pq, lq = model.apply(p, batch), model.apply_emb(p, batch)
                pd, ld = model.apply(deq, batch), model.apply_emb(deq, batch)
            del deq
            torch.cuda.empty_cache()
            e_pool = float(((lq - ld).abs() - 1e-5 * ld.abs()).max())
            e_prob = float((pq - pd).abs().max())
            check(e_pool <= 1e-7, f"{tag}: pooled rows beyond rtol 1e-5 / "
                  f"atol 1e-7 of the dequantized table's ({e_pool:.3e})")
            check(e_prob <= P11_QUANT_ATOL, f"{tag}: probabilities "
                  f"{e_prob:.3e} from the dequantized table's")
            line += (f"; against the dequantized fp32 table: pooled max "
                     f"abs {float((lq - ld).abs().max()):.3e}, "
                     f"probabilities max abs {e_prob:.3e}")
            if name == "int4 rowwise tables":
                rowwise4 = pq
            del pq, lq, pd, ld
        if name == "int4 group-16 tables":
            with torch.no_grad():
                g16 = model.apply(p, batch)
            check(rowwise4 is not None and torch.equal(g16, rowwise4),
                  f"{tag}: differs from the rowwise int4 forward")
            line += "; equal to rowwise int4 bit for bit"
        res[name] = r
        log(line)
        del p
    del params, batch, rowwise4
    torch.cuda.empty_cache()
    return res


def p11b():
    """11b: the uncapped Criteo 1TB counts served on one card from int4
    rowwise, int4 group-16 and int8 rowwise tables filled on the card, one
    at a time (probes/serve_flagship.py), batch 8,192 with the MLPerf hot
    sizes."""
    from dlrm_tpu_torch.probes import serve_flagship as sf

    buf = Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(buf):
            res = sf.main(CUDA)
    except AssertionError as e:
        raise SmokeFailure(f"phase 11b: {e}") from e
    n = sum(sf.TABLE_SIZES)
    check(n == 204_184_588, f"phase 11b: {n} rows")
    check(res["int4 rowwise"]["table_bytes"] == n * 72
          and res["int8 rowwise"]["table_bytes"] == n * 136,
          f"phase 11b: table bytes {res}")
    for name, r in res.items():
        log(f"phase 11b {name}: tables {r['table_bytes']} B, "
            f"{r['ms']:.3f} ms a batch, {r['examples_per_s']:.0f} "
            f"examples/s, peak {r['peak_bytes']} B "
            f"({r['peak_bytes'] / 2**30:.2f} GiB)")
    torch.cuda.empty_cache()
    return res


def p11c():
    """11c: cli.main --inference-only at phase 8a's widths (8 x 1,000,000
    rows, d 64, mini-batch 2,048, 100 hits a bag, fp32 compute), each
    form of P11C on the card; group-16's accuracy line equal to rowwise
    int4's; then each form with the tables capped at P11_CAP rows on the
    card and on the CPU from the same init: probabilities within rtol 1e-4
    / atol 1e-5 for the fp32 towers, P11_TOWER_ATOL for the int8 and bf16
    towers."""
    lines, res = {}, {}
    for name, extra in P11C.items():
        tag = f"phase 11c {name}"
        out, probs, wall, peak = p11_cli(tag, P11C_BASE + extra)
        acc = ACC_LINE.findall(out)
        check(len(acc) == 1, f"{tag}: accuracy lines {acc}")
        lines[name] = acc[0]
        capped = p11_capped(P11C_BASE + extra)
        _, card, _, _ = p11_cli(f"{tag} capped", capped)
        _, host, _, _ = p11_cli(f"{tag} capped, CPU", capped, device="cpu")
        err = float((card - host).abs().max())
        if any(a.startswith("--quantize-mlp") for a in extra):
            ok = err <= P11_TOWER_ATOL
        else:
            ok = bool(torch.allclose(card, host, rtol=1e-4, atol=1e-5))
        check(ok, f"{tag}: capped tables, card vs CPU probabilities differ "
              f"by {err:.3e}")
        res[name] = {"wall": wall, "peak": peak, "rows": probs.numel(),
                     "cpu_err": err}
        log(f"{tag}: {acc[0]!r}; {probs.numel()} rows served in {wall:.1f} s "
            f"(the reference's draw included), peak {peak / 2**30:.2f} "
            f"GiB; capped tables, card vs CPU probabilities max abs "
            f"{err:.3e}")
    g16, row = lines["emb 4 group-16, mlp 16"], lines["emb 4, mlp 16"]
    check(g16 == row, f"phase 11c: group-16's accuracy line {g16!r} "
          f"differs from rowwise's {row!r}")
    return res


def p11_serve_rank(rank, world, staged, argv):
    """11d on one rank: cli.main(argv) on its device; its output."""
    dev = p9_rank_device(rank, staged)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=dev)
    return rc, buf.getvalue()


def p11d():
    """11d: cli --sharded quantized serving over the ranks (p9_world's), the
    tables capped; its accuracy line equal to the single card's run."""
    from dlrm_tpu_torch.parallel.launch import run_ranks

    argv = p11_capped(P11C_BASE + P11C["emb 8, mlp 8"], batches=4)
    out1, _, _, _ = p11_cli("phase 11d single card", argv)
    world, backend, staged = p9_world()
    ranks = run_ranks(p11_serve_rank, world,
                      args=(world, staged, argv + ["--sharded"]),
                      backend=backend, timeout_s=600)
    tag = "phase 11d"
    check(all(rc == 0 for rc, _ in ranks), f"{tag}: ranks returned "
          f"{[rc for rc, _ in ranks]}")
    check(all(out == "" for _, out in ranks[1:]), f"{tag}: a rank but 0 "
          "printed")
    out = ranks[0][1]
    check(f"quantized serving over {world} mesh devices" in out,
          f"{tag}: {out!r}")
    check(ACC_LINE.findall(out) == ACC_LINE.findall(out1) != [],
          f"{tag}: {ACC_LINE.findall(out)} against the single card's "
          f"{ACC_LINE.findall(out1)}")
    log(f"{tag}: {world} ranks over {backend}: {ACC_LINE.findall(out)[0]!r}"
        ", the single card's line")


def p11e(root):
    """11e: --save-onnx on the card after a train step and after quantized
    serving: each archive loaded back gives the eager forward's
    probabilities on the exported params, bit for bit; --plot-compute-graph
    writes the program's text."""
    from dlrm_tpu_torch.tools import export

    real, seen = export.export_forward, []

    def record(model, params, batch_size, path, wt=True):
        seen.append((model, params, batch_size, path))
        return real(model, params, batch_size, path, wt)

    base = [a for a in p11_capped(P11C_BASE, batches=1)
            if a != "--inference-only"]
    runs = {"trained": base + ["--save-onnx"],
            "quantized": base + ["--inference-only", "--save-onnx",
                                 "--quantize-emb-with-bit=4",
                                 "--quantize-mlp-with-bit=8"],
            "graph": base + ["--plot-compute-graph"]}
    export.export_forward = record
    try:
        outs = {}
        for name, argv in runs.items():
            prefix = os.path.join(root, f"p11e_{name}")
            tag = f"phase 11e {name}"
            if name != "quantized":  # they train: the fused kernels run
                for k in LAUNCHES:
                    LAUNCHES[k] = 0
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(argv + [f"--tensor-board-filename={prefix}"])
                check(rc == 0, f"{tag}: cli.main returned {rc}")
                outs[name] = buf.getvalue()
            else:
                outs[name] = p11_cli(tag, argv + [
                    f"--tensor-board-filename={prefix}"])[0]
    finally:
        export.export_forward = real
    check(len(seen) == 2, f"phase 11e: {len(seen)} exports")
    for (model, params, b, path), name in zip(seen, ("trained",
                                                     "quantized")):
        tag = f"phase 11e {name}"
        check(f"exported serialized forward to {path}" in outs[name],
              f"{tag}: {outs[name][-300:]!r}")
        hb = RandomDataset(model.cfg, cli.configs_from_args(
            cli.build_parser().parse_args(runs[name]))[1])[0]
        batch = hb.to_device(CUDA)
        got = export.load_forward(path)(params, batch.dense, batch.idx,
                                        batch.wt)
        with torch.no_grad():
            want = model.apply(params, batch)
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"{tag}: the loaded archive's "
              f"probabilities differ from the eager forward's by {err:.3e}")
        log(f"{tag}: {path} ({os.path.getsize(path)} B) loaded back: "
            f"{got.shape[0]} probabilities equal to the eager forward's bit "
            "for bit")
    graph = os.path.join(root, "p11e_graph_graph.pt2.txt")
    check(os.path.exists(graph), "phase 11e: no graph file")
    text = open(graph).read()
    for op in ("aten.embedding_bag", "aten.mm", "aten.sigmoid"):
        check(op in text, f"phase 11e: the graph names no {op}")
    log(f"phase 11e: --plot-compute-graph wrote {graph} "
        f"({len(text.splitlines())} lines)")


def phase_serving(root):
    """Phase 11: quantized inference on one card and over the ranks, and
    the forward's export."""
    t_phase = time.perf_counter()
    res = {"11a": p11a()}
    log(f"phase 11a: {time.perf_counter() - t_phase:.1f} s")
    res["11b"] = p11b()
    log(f"phase 11b: {time.perf_counter() - t_phase:.1f} s")
    res["11c"] = p11c()
    log(f"phase 11c: {time.perf_counter() - t_phase:.1f} s")
    p11d()
    log(f"phase 11d: {time.perf_counter() - t_phase:.1f} s")
    p11e(root)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return res


# ------------------------------------------------------------------ phase 12
P12_FWD_ITERS = 20
# 12c: the proxy at the in-suite size (tests/test_mlperf_proxy.py's)
P12_PROXY = ["--days", "24", "--rows-per-day", "800", "--auc-threshold",
             "0.70", "--auroc-target", "0.70"]
# 12f: the checkpoint's model (dlrm_criteo_kaggle.sh's widths on 8 tables
# of 100,000 rows) and 4 batches of 1,024
P12_VIZ = ["--arch-sparse-feature-size=16",
           "--arch-embedding-size=" + "-".join(["100000"] * 8),
           "--arch-mlp-bot=13-512-256-64-16", "--arch-mlp-top=512-256-1",
           "--num-batches=4", "--mini-batch-size=1024"]
P12_VIZ_TOL = (1e-4, 1e-5)  # fp32 towers, card vs CPU (phase 11c's)
# 12g: cli --sharded over the launcher's ranks, 8a's widths on tables of
# 100,000 rows, 10 steps
P12G_STEPS = 10
P12G_ARGS = ["--arch-sparse-feature-size=64",
             "--arch-embedding-size=" + "-".join(["100000"] * 8),
             "--arch-mlp-bot=13-512-64", "--arch-mlp-top=1024-1024-1",
             "--data-generation=random", "--mini-batch-size=2048",
             f"--num-batches={P12G_STEPS}", "--print-freq=5", "--sharded"]
P12_COUNTED = ("stream_update", "coalesce_rows", "row_scatter_add")
# 12b: each leg's losses, card against the CPU: bf16 towers on all but the
# trainer legs, whose roundings move where the fp32 sums' order differs
# (12a's probabilities: 6.8e-05)
P12B_TOL = 2e-3
# the leg that cannot be held so: v2_main draws its init on the device it
# runs on (a torch.Generator on the card gives other numbers than the CPU's);
# its path is held against one card in phases 9b and 10c
P12B_UNHELD = "v2_main.main --sharded"
P12B_CPU = ("import json\n"
            "from dlrm_tpu_torch import graft_entry\n"
            "if __name__ == '__main__':\n"
            "    res = graft_entry.dryrun_multichip(4, device='cpu')\n"
            "    print('P12B_CPU ' + json.dumps(res['legs']))\n")
# 12c: v1 on the card against v1 on the CPU (fp32, sgd): the first printed
# loss (the mean of 80 steps) and the first evaluation's AUC
P12C_LOSS_TOL, P12C_AUC_TOL = 1e-4, 1e-3
P12C_CPU = ("import sys\n"
            "from dlrm_tpu_torch.scripts import mlperf_proxy_run\n"
            "if __name__ == '__main__':\n"
            "    sys.exit(mlperf_proxy_run.main(sys.argv[1:], device='cpu'))\n")


class P12Run:
    """A subprocess of phase 12, started at once: cmd from the checkout's
    root in a process group of its own, its output to a file, every
    process of it run with DLRM_TORCH_LAUNCHES_TO. finish() waits for it;
    kill() ends the whole group if it is still running."""

    def __init__(self, tag, cmd):
        from dlrm_tpu_torch.ops.stream_kernels import LAUNCHES_TO

        self.tag = tag
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT", "DLRM_NUM_PROCESSES"):
            env.pop(k, None)
        self.tmp = tempfile.mkdtemp(prefix="p12_run_")
        self.counts = os.path.join(self.tmp, "launches")
        os.mkdir(self.counts)
        env[LAUNCHES_TO] = self.counts
        self.out = open(os.path.join(self.tmp, "out"), "w+")
        self.t0, self.t1 = time.perf_counter(), None
        self.proc = subprocess.Popen(cmd, cwd=here, env=env, text=True,
                                     stdout=self.out,
                                     stderr=subprocess.STDOUT,
                                     start_new_session=True)
        # its own wall time, whenever finish() is called
        threading.Thread(target=self._reap, daemon=True).start()

    def _reap(self):
        self.proc.wait()
        self.t1 = time.perf_counter()

    def finish(self, timeout):
        """(its output, the launches its processes wrote at exit, summed,
        wall s from its start); fails the phase on a non-zero exit or when
        it is still running `timeout` s after its start."""
        left = timeout - (time.perf_counter() - self.t0)
        try:
            self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            self.kill()
            raise SmokeFailure(f"{self.tag}: still running after "
                               f"{timeout} s")
        self.proc.wait()
        wall = (self.t1 or time.perf_counter()) - self.t0
        self.out.seek(0)
        out = self.out.read()
        launches = dict.fromkeys(P12_COUNTED, 0)
        for name in os.listdir(self.counts):
            with open(os.path.join(self.counts, name)) as f:
                for k, v in json.load(f).items():
                    if k in launches:
                        launches[k] += v
        self.kill()
        check(self.proc.returncode == 0, f"{self.tag}: exit code "
              f"{self.proc.returncode}:\n{out[-3000:]}")
        return out, launches, wall

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()
        self.out.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def p12a():
    """12a: graft_entry.entry()'s flagship forward at full width on the
    card (26 x 200,000 x 128 fp32 tables, batch 1,024, 8 hits a bag, bf16
    compute): ms per forward (CUDA events over P12_FWD_ITERS), peak memory,
    and the same params' forward on the CPU within P11_TOWER_ATOL (the bf16
    tower's roundings can move by a step where the fp32 sums' order
    differs)."""
    from dlrm_tpu_torch import graft_entry

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd, (params, batch) = graft_entry.entry()
    table = params["emb"]["stacked"]
    check(tuple(table.shape) == (26 * 200_000, 128)
          and table.dtype == torch.float32, f"phase 12a: table "
          f"{tuple(table.shape)} {table.dtype}")
    probs = fwd(params, batch)
    ms = time_ms(lambda: fwd(params, batch), CUDA, P12_FWD_ITERS)
    peak = torch.cuda.max_memory_allocated()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_batch = Batch(*(None if t is None else t.cpu() for t in batch))
    want = fwd(cpu_params, cpu_batch)
    got = probs.float().cpu()
    check(got.shape == (1024, 1) and bool(torch.isfinite(got).all()),
          f"phase 12a: probabilities {tuple(got.shape)}")
    err = float((got - want.float()).abs().max())
    check(err <= P11_TOWER_ATOL, f"phase 12a: card vs CPU probabilities "
          f"differ by {err:.3e}")
    log(f"phase 12a: graft_entry.entry() at full width ({table.numel() * 4} "
        f"B of fp32 tables): {ms:.3f} ms a forward of 1,024 (CUDA events, "
        f"{P12_FWD_ITERS} forwards), peak {peak} B ({peak / 2**30:.2f} "
        f"GiB); card vs CPU probabilities max abs {err:.3e} (held to "
        f"{P11_TOWER_ATOL})")
    del fwd, params, batch, cpu_params, probs
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak, "cpu_err": err}


def p12b_cpu_start():
    """12b's reference: the same dry run on 4 gloo ranks on the CPU, a
    subprocess started before 12a."""
    return P12Run("phase 12b (CPU)", [sys.executable, "-c", P12B_CPU])


def p12b(cpu_run):
    """12b: graft_entry.dryrun_multichip(4): every leg one step on 4 ranks
    (NCCL where there are 4 cards, else 4 ranks sharing the card over gloo,
    staged), each leg's OK line; K2 launched on the streamed legs and the
    fused kernels on the fused ones, on every rank; each leg's loss and
    loss after its step within P12B_TOL of the CPU run's. Returns the
    launches summed over the legs and ranks."""
    from dlrm_tpu_torch import graft_entry

    buf = Tee(sys.stdout)
    with contextlib.redirect_stdout(buf):
        res = graft_entry.dryrun_multichip(4)
    lines = [ln for ln in buf.buf.getvalue().splitlines()
             if ln.startswith("dryrun_multichip(4)")]
    check(len(lines) == len(graft_entry.LEGS) == len(res["legs"]),
          f"phase 12b: {len(lines)} leg lines")
    out, _, cpu_wall = cpu_run.finish(300)
    found = [ln for ln in out.splitlines() if ln.startswith("P12B_CPU ")]
    check(len(found) == 1, f"phase 12b (CPU): {out[-2000:]}")
    cpu = json.loads(found[0].split(" ", 1)[1])
    check([leg[0] for leg in cpu] == [leg[0] for leg in res["legs"]],
          f"phase 12b: the CPU's legs {[leg[0] for leg in cpu]}")
    errs = []
    for (name, *card), (_, *host) in zip(res["legs"], cpu):
        if name == P12B_UNHELD:
            continue
        check([x is None for x in card] == [x is None for x in host],
              f"phase 12b {name}: losses {card} on the card, {host} on "
              "the CPU")
        err = max(abs(a - b) for a, b in zip(card, host) if a is not None)
        check(err <= P12B_TOL, f"phase 12b {name}: losses {card} on the "
              f"card, {host} on the CPU (beyond {P12B_TOL})")
        errs.append(err)
    log(f"phase 12b: the legs' losses within {max(errs):.3e} of the CPU's "
        f"(held to {P12B_TOL}; by leg "
        f"{', '.join(f'{e:.1e}' for e in errs)}; the CPU run "
        f"{cpu_wall:.1f} s); {P12B_UNHELD} not held to the CPU (its init "
        "is drawn on the card)")
    total = dict.fromkeys(P12_COUNTED, 0)
    for name, counts in res["launches"].items():
        stream = "stream" in name
        if name.startswith("v2_main"):  # --embedding_impl auto: either
            ran = counts["stream_update"] or counts["coalesce_rows"]
        elif stream:
            ran = counts["stream_update"]
        else:
            ran = counts["coalesce_rows"] and counts["row_scatter_add"]
        check(ran, f"phase 12b {name}: launches {counts}")
        for k in P12_COUNTED:
            total[k] += counts[k]
    log(f"phase 12b: {len(lines)} legs over 4 ranks ({res['backend']}"
        f"{', staged through host memory' if res['staged'] else ''}, grid "
        f"{res['grid'][0]} x {res['grid'][1]}); launches summed over the "
        f"legs and ranks: {total}")
    return total


def p12c(root):
    """12c: the MLPerf proxy (python -m dlrm_tpu_torch.scripts.
    mlperf_proxy_run, its main on the card) with both phases on 24 days x
    800 rows: v1 stops on its AUC threshold with a log the copy of the
    compliance checker passes (inside run_v1), and the same log passes it
    again here and through its CLI; v2 stops on its AUROC target. v1 runs
    the fused step (coalesce_rows, row_scatter_add), v2 the stream path
    (K2). Returns (the workdir, launches)."""
    from dlrm_tpu_torch.utils.compliance import check_lines

    work = os.path.join(root, "p12_proxy")
    out, launches, wall = P12Run(
        "phase 12c", [sys.executable, "-m",
                      "dlrm_tpu_torch.scripts.mlperf_proxy_run",
                      "--workdir", work, "--phase", "both"] + P12_PROXY
    ).finish(600)
    ok = [ln for ln in out.splitlines() if ln.startswith("[proxy] v")
          and " OK" in ln]
    check(len(ok) == 2, f"phase 12c: {out[-2000:]}")
    check(not check_lines(out.splitlines()), "phase 12c: the log has "
          "violations")
    log_path = os.path.join(root, "p12_proxy_v1.log")
    with open(log_path, "w") as f:
        f.write(out)
    verdict = subprocess.run(
        [sys.executable, "-m", "dlrm_tpu_torch.utils.compliance", log_path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=120)
    check(verdict.returncode == 0 and verdict.stdout.strip() == "compliant",
          f"phase 12c: the checker's CLI said {verdict.stdout!r}")
    check(launches["coalesce_rows"] and launches["row_scatter_add"]
          and launches["stream_update"], f"phase 12c: launches {launches}")
    log(f"phase 12c: {ok[0]}; {ok[1]}; the log compliant again here and "
        f"through `python -m dlrm_tpu_torch.utils.compliance`; launches "
        f"{launches}; {wall:.1f} s")
    return work, launches, out


def p12c_cpu_start(work):
    """12c's reference: v1 on the CPU over 12c's bins (nothing to parse:
    the workdir holds them)."""
    return P12Run("phase 12c (CPU)", [sys.executable, "-c", P12C_CPU,
                                      "--workdir", work, "--phase", "v1"]
                  + P12_PROXY)


def _v1_trace(out):
    """(the printed losses, the evaluations' AUCs) of a v1 proxy run's
    output, up to its OK line."""
    out = out.split("[proxy] v1 OK", 1)[0]
    losses = [float(x) for x in re.findall(
        r"^Finished training it .* loss (\S+)$", out, re.M)]
    aucs = [float(x) for x in re.findall(
        r'"key": "eval_accuracy", "value": ([^,]+),', out)]
    return losses, aucs


def p12c_cpu(run, card_out):
    """v1 on the card against v1 on the CPU: the first printed loss within
    P12C_LOSS_TOL, the first AUC within P12C_AUC_TOL; both runs' printed
    losses and AUCs are logged, later ones unheld (lr 0.4 sgd: the fp32
    sums' order moves later steps)."""
    out, _, wall = run.finish(300)
    card, host = _v1_trace(card_out), _v1_trace(out)
    check(card[0] and card[1] and host[0] and host[1],
          f"phase 12c (CPU): {out[-2000:]}")
    dl, da = abs(card[0][0] - host[0][0]), abs(card[1][0] - host[1][0])
    log(f"phase 12c: v1 card against CPU: losses {card[0]} / {host[0]}, "
        f"AUCs {card[1]} / {host[1]}; the CPU run {wall:.1f} s")
    check(dl <= P12C_LOSS_TOL and da <= P12C_AUC_TOL,
          f"phase 12c: v1's first loss {dl:.3e} (held to {P12C_LOSS_TOL}) "
          f"and first AUC {da:.3e} (held to {P12C_AUC_TOL}) from the CPU's")
    log(f"phase 12c: v1's first loss within {dl:.3e} of the CPU's (held to "
        f"{P12C_LOSS_TOL}), its first AUC within {da:.3e} (held to "
        f"{P12C_AUC_TOL})")


def p12d_start():
    """12d: the golden test's twin (dlrm_tpu_torch/scripts/dlrm_tpu_test.sh)
    as a subprocess: its four configs on the card, each log within 5e-6 of
    its golden."""
    return P12Run("phase 12d",
                  ["bash", "dlrm_tpu_torch/scripts/dlrm_tpu_test.sh"])


def p12d(run):
    out, _, wall = run.finish(300)
    passed = re.findall(r"^(tiny\d): PASSED$", out, re.M)
    check(passed == ["tiny1", "tiny2", "tiny3", "tiny4"],
          f"phase 12d: {out[-2000:]}")
    log(f"phase 12d: dlrm_tpu_test.sh: {', '.join(passed)} PASSED (text "
        f"equal, numbers within 5e-6); {wall:.1f} s")


def p12e_start(root, work):
    """12e: the preprocessing twin (process_criteo_1tb.sh) on 12c's raw
    days into a fresh directory: its bins and counts equal the proxy's
    byte for byte."""
    return P12Run("phase 12e",
                  ["bash", "dlrm_tpu_torch/scripts/process_criteo_1tb.sh",
                   os.path.join(work, "raw"), os.path.join(root, "p12_1tb")])


def p12e(run, root, work):
    import filecmp

    dest = os.path.join(root, "p12_1tb")
    out, _, wall = run.finish(300)
    names = ["train_data.bin", "test_data.bin", "val_data.bin",
             "day_fea_count.npz"]
    for name in names:
        check(filecmp.cmp(os.path.join(dest, name),
                          os.path.join(work, "proc", name), shallow=False),
              f"phase 12e: {name} differs from the proxy's")
    log(f"phase 12e: process_criteo_1tb.sh on 12c's 24 raw days: "
        f"{', '.join(names)} equal to 12c's byte for byte; {wall:.1f} s")


def p12f(root):
    """12f: visualize.representations on the card against the CPU from one
    checkpoint: the three stages within P12_VIZ_TOL. The projection,
    clustering and plotting half runs on the host with scikit-learn and
    matplotlib; this machine's lack of them is printed."""
    import importlib.util

    from dlrm_tpu_torch.tools import visualize
    from dlrm_tpu_torch.train import checkpoint as ckpt

    ck = os.path.join(root, "p12_viz_ckpt")
    args = visualize.build_parser().parse_args(["--load-model", ck]
                                               + P12_VIZ)
    model = DLRMModel(visualize.config_from_args(args))
    ckpt.save_checkpoint(ck, model.init_params(seed=12, device=CUDA),
                         meta={"phase": "12f"})
    stages = {}
    for dev in (CUDA, torch.device("cpu")):
        with contextlib.redirect_stdout(io.StringIO()):
            m, params, data = visualize.load(args, dev)
        stages[dev.type] = visualize.representations(m, params, data, dev,
                                                     max_points=4096)
        del params
    (card, y), (host, y_cpu) = stages["cuda"], stages["cpu"]
    check(np.array_equal(y, y_cpu) and len(y) == 4096,
          f"phase 12f: labels {len(y)}")
    rtol, atol = P12_VIZ_TOL
    errs = {}
    for stage in ("input", "interaction", "final"):
        check(card[stage].shape == host[stage].shape,
              f"phase 12f {stage}: {card[stage].shape} vs "
              f"{host[stage].shape}")
        errs[stage] = float(np.abs(card[stage] - host[stage]).max())
        check(np.allclose(card[stage], host[stage], rtol=rtol, atol=atol),
              f"phase 12f {stage}: card vs CPU max abs {errs[stage]:.3e}")
    missing = [m for m in ("sklearn", "matplotlib")
               if importlib.util.find_spec(m) is None]
    log(f"phase 12f: visualize.representations of {len(y)} rows on the "
        "card against the CPU from one checkpoint, within rtol "
        f"{rtol} / atol {atol}: " + ", ".join(
            f"{k} {tuple(card[k].shape)} max abs {v:.3e}"
            for k, v in errs.items()))
    log("phase 12f: the projection, clustering and plotting half of "
        "visualize runs on the host (CPU only) and is not run here: "
        + (f"{' and '.join(missing)} not installed on this machine"
           if missing else "its packages are installed, but it times "
           "nothing of the card"))


def p12g_start():
    """12g: python -m dlrm_tpu_torch.scripts.launch --nproc <cards> -m
    dlrm_tpu_torch.cli -- ... --sharded: exit code 0, its losses, the fused
    kernels once per step on every rank."""
    return P12Run("phase 12g",
                  [sys.executable, "-m", "dlrm_tpu_torch.scripts.launch",
                   "--nproc", str(torch.cuda.device_count()), "-m",
                   "dlrm_tpu_torch.cli", "--"] + P12G_ARGS)


def p12g(run):
    n = torch.cuda.device_count()
    out, launches, wall = run.finish(300)
    losses = [float(x) for x in re.findall(r"loss (\d+\.\d+)", out)]
    check(len(losses) == P12G_STEPS // 5
          and all(math.isfinite(x) for x in losses),
          f"phase 12g: {out[-2000:]}")
    want = P12G_STEPS * n
    check(launches["coalesce_rows"] == launches["row_scatter_add"] == want,
          f"phase 12g: launches {launches}, want {want} of each")
    log(f"phase 12g: launch.py --nproc {n} -m dlrm_tpu_torch.cli --sharded "
        f"exited 0: losses {losses}; launches {launches}; {wall:.1f} s")
    return launches


def phase_tools(root):
    """Phase 12: the tools, scripts and entry points on the card.
    12a and 12b run beside 12b's CPU reference; 12d and 12g beside 12c;
    12e and 12c's CPU reference beside 12f (subprocesses: each line's
    seconds are its own wall time). Returns
    {path: launches} for the kernels line's launches_by_path."""
    t_phase = time.perf_counter()
    runs = []
    try:
        runs.append(p12b_cpu_start())
        p12a()
        log(f"phase 12a: {time.perf_counter() - t_phase:.1f} s")
        by_path = {"12b": p12b(runs[0])}
        log(f"phase 12b: {time.perf_counter() - t_phase:.1f} s")
        runs += [p12d_start(), p12g_start()]
        work, by_path["12c"], card_out = p12c(root)
        runs += [p12e_start(root, work), p12c_cpu_start(work)]
        p12f(root)
        p12d(runs[1])
        by_path["12g"] = p12g(runs[2])
        p12e(runs[3], root, work)
        p12c_cpu(runs[4], card_out)
    finally:
        for run in runs:
            run.kill()
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return by_path


# ----------------------------------------------------------------- phase 13
# GspmdDLRM's training half over W = 2 ranks, each step held to the single
# card's dense step (train/step.py) on the same global batch from the same
# state. The single card takes the batch in the ranks' two slices
# (make_grad_accum_train_step: the mean of the slices' mean losses, the
# global batch's, with the tower's products in the ranks' shapes): in one
# product of 2,048 rows cuBLAS rounds the tower otherwise, a few samples'
# cotangents move, and rwsadagrad's row normalization carries that into
# their rows. That whole-batch step is reported (the rows it moves), as is
# the single card's own whole-batch run, whose losses are held. From
# the same state, not from an independent run: element-wise Adagrad (the
# dense params under rwsadagrad) moves a weight by lr * g / |g|, so a
# gradient at rounding level, which the ranks sum in another order, moves
# it by up to lr either way (phase 9), and later steps follow the towers
# apart.
P13_TABLES = (20_000,) * 25 + (20_001,)
P13_BATCH = 2048  # cut from 16,384
P13_STEPS = 3
# phase 9's rwsadagrad rate: at 0.01 the fp32 tower's loss jumps past 18
# on the second step
P13_LR = 1e-3
P13_VARIANTS = {
    "plain": {},
    "qr": {"qr": QRConfig(collisions=4, threshold=0)},
    "v_w": {"weighted_pooling": "learned"},
}
# (rtol, atol); the dense params' rounding-level elements: see p13_hold
P13_TOL = {"table": (1e-5, 1e-6), "dense": (1e-4, 1e-5),
           "acc": (1e-4, 1e-8)}
# The samples whose rows a step may leave beyond P13_TOL. The ranks sum a
# pooled bag block by block, so the tower's input differs from the single
# card's at rounding level, and where one of its ReLUs sits within that
# rounding of 0 a sample's cotangent moves; rwsadagrad normalizes each
# row's gradient, so the rows that sample's hits dominate move by a share
# of lr (205 rows, about one sample's q rows and their accumulators, of the
# 260,210 at step 2 of the QR run on the card). A fault of the sharding (a
# block's offset, a lost or doubled hit, a wrong slice) moves thousands.
P13_FLIP_SAMPLES = 2


def p13_model(variant):
    return DLRMModel(DLRMConfig(
        embedding_dim=128, table_sizes=P13_TABLES,
        mlp_bot=(13, 512, 256, 128), mlp_top=(1024, 1024, 512, 256, 1),
        interaction="dot", loss="bce",
        num_indices_per_lookup=max(V2_HOT_SIZES), compute_dtype="float32",
        **P13_VARIANTS[variant]))


def p13_batches(model, device):
    """Phase 13's global batches on `device` (the stacked tables' in the
    flat per-hit layout, QR's padded)."""
    hots = V2_HOT_SIZES if model.fused else None
    return [ragged_multihot_batch(np.random.default_rng(1300 + i), 13,
                                  P13_TABLES, V2_HOT_SIZES, P13_BATCH)
            .to_device(device, flat_hots=hots) for i in range(P13_STEPS)]


def p13_init(model, device):
    """(params, rwsadagrad state) from init_params(seed=0) on `device`."""
    params = model.init_params(seed=0, device=device)
    return params, init_opt_state("rwsadagrad", params)


def p13_rank(rank, world, staged, root):
    """Each variant's steps on this rank: losses, launches, seconds a step
    (the unsharding and saving excluded), the padded rows (all 0?); rank 0
    saves the unsharded params and accumulators after each step under
    `root`."""
    from dlrm_tpu_torch.parallel.gspmd import GspmdDLRM, _is_row_shardable
    from dlrm_tpu_torch.parallel.mesh import make_mesh

    dev = p9_rank_device(rank, staged)
    mesh = make_mesh(data=1, model=world, stage=staged)
    out = {}
    for variant in P13_VARIANTS:
        model = p13_model(variant)
        runner = GspmdDLRM(model, mesh, device=dev, hot_sizes=V2_HOT_SIZES)
        params, state = p13_init(model, dev)
        shapes = tree_map(lambda t: torch.empty(t.shape, device="meta"),
                          {"params": params, "accum": state["accum"]})
        sp = runner.shard_params(params)
        st = runner.shard_opt_state(state)
        del params, state
        step = runner.make_train_step("rwsadagrad")
        batches = p13_batches(model, "cpu")
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        losses, secs = [], 0.0
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp, st, loss, _ = step(sp, st, runner.shard_batch(b), P13_LR)
            losses.append(float(loss))
            secs += time.perf_counter() - t0
            full = {"params": runner.unshard_params(sp, shapes["params"]),
                    "accum": runner.unshard_params(st["accum"],
                                                   shapes["accum"])}
            if rank == 0:
                torch.save(full, os.path.join(root, f"p13_{variant}_{i}.pt"))
            del full
        launches = dict(LAUNCHES)
        pads = []

        def pad_rows(path, leaf, t):
            if _is_row_shardable(path, leaf):
                n, block = t.shape[0], leaf.shape[0]
                pad = leaf[max(0, min(block, n - mesh.m * block)):]
                pads.append((pad.shape[0], bool((pad == 0).all())))

        tree_map_with_path(pad_rows, {"params": sp, "accum": st["accum"]},
                           shapes)
        out[variant] = {"losses": losses, "launches": launches,
                        "secs": secs / P13_STEPS,
                        "padded": sum(n for n, _ in pads),
                        "padding_zero": all(z for _, z in pads)}
        del sp, st, step
        torch.cuda.empty_cache()
    return out


def p13_independent(variant):
    """The single card's own 3 steps of the variant from the init, the
    whole batch at once: losses and final params (on the card)."""
    model = p13_model(variant)
    params, state = p13_init(model, CUDA)
    step = make_train_step(model, "rwsadagrad", hot_sizes=V2_HOT_SIZES)
    losses = []
    for b in p13_batches(model, CUDA):
        params, state, loss, _ = step(params, state, b, P13_LR)
        losses.append(float(loss))
    return losses, params


def p13_hold(tag, full, params, accum):
    """{kind: max abs error} of the ranks' unsharded trees against the
    single card's step, each held to P13_TOL: tables, QR's q and r and v_w
    ("table"), the other params ("dense"), the accumulators ("acc"); the
    count of rounding-level elements (an element under element-wise
    Adagrad whose accumulator stays below 1e-12 has only had gradients at
    rounding level, which Adagrad divides by themselves: held to |dw| <=
    lr instead); and the rows of the row-sharded leaves and accumulators
    beyond P13_TOL, at most the rows the hits of P13_FLIP_SAMPLES samples
    reach (see there)."""
    from dlrm_tpu_torch.parallel.gspmd import _is_row_shardable

    errs = {"table": 0.0, "dense": 0.0, "acc": 0.0, "noise": 0,
            "rows": 0}
    accs = {}
    tree_map_with_path(lambda path, a: accs.setdefault(path, a), accum)
    rows = [0, 0]  # row-sharded rows beyond P13_TOL, row-sharded rows

    def held(kind, got, want, what, keep=None, by_row=False):
        d = (got.to(want.device) - want).abs()
        rtol, atol = P13_TOL[kind]
        bad = d > atol + rtol * want.abs()
        if keep is not None:
            bad &= keep
        errs[kind] = max(errs[kind], float(d.max()) if d.numel() else 0.0)
        if by_row:
            rows[0] += int(bad.reshape(bad.shape[0], -1).any(1).sum())
            rows[1] += bad.shape[0]
        elif bad.any():
            j = int(torch.where(bad, d, 0).argmax())
            check(False, f"{tag}: {what} beyond rtol {rtol} / atol {atol} "
                  f"of the single card's at {int(bad.sum())} of "
                  f"{bad.numel()} elements (e.g. "
                  f"{got.reshape(-1)[j].item()} vs "
                  f"{want.reshape(-1)[j].item()})")
        return d

    def param(path, got, want):
        what = "/".join(map(str, path))
        table = _is_row_shardable(path, want)
        kind = "table" if table else "dense"
        if accs[path].shape != want.shape:  # rwsadagrad's row accumulator
            held(kind, got, want, what, by_row=table)
            return
        noise = accs[path] < 1e-12
        errs["noise"] += int(noise.sum())
        d = held(kind, got, want, what, keep=~noise, by_row=table)
        check(not bool((d[noise] > P13_LR).any()), f"{tag}: {what}'s "
              "rounding-level elements moved past lr")

    tree_map_with_path(param, full["params"], params)
    tree_map_with_path(
        lambda path, g, w: held("acc", g, w, f"accum {path}",
                                by_row=_is_row_shardable(path, w)),
        full["accum"], accum)
    errs["rows"] = rows[0]
    # a sample's hits reach sum(hots) rows of each row-sharded leaf kind
    # (the stacked table or a table's w, q, r; v_w), and as many
    # accumulator rows
    kinds = len({path[-1] if path[0] == "emb" else path[0]
                 for path in accs if _is_row_shardable(path, accs[path])})
    budget = P13_FLIP_SAMPLES * sum(V2_HOT_SIZES) * kinds * 2
    check(rows[0] <= budget, f"{tag}: {rows[0]} of {rows[1]} rows of the "
          "tables, v_w and their accumulators beyond rtol / atol of the "
          f"single card's, more than {P13_FLIP_SAMPLES} samples' hits reach "
          f"({budget})")
    return errs


def p13_slices(batch, world=2):
    """The global batch as the ranks' `world` slices, stacked on a leading
    axis."""
    from dlrm_tpu_torch.parallel.gspmd import batch_slice

    parts = [batch_slice(batch, m, world, V2_HOT_SIZES)
             for m in range(world)]
    return Batch(*(torch.stack(f) for f in zip(*(p[:4] for p in parts))))


def p13_apart(full, params):
    """(rows of the row-sharded leaves beyond P13_TOL["table"], max abs)
    of the ranks' params against another single-card step's."""
    from dlrm_tpu_torch.parallel.gspmd import _is_row_shardable

    out = [0, 0.0]

    def visit(path, got, want):
        if _is_row_shardable(path, want):
            d = (got.to(want.device) - want).abs()
            rtol, atol = P13_TOL["table"]
            bad = (d > atol + rtol * want.abs()).reshape(d.shape[0], -1)
            out[0] += int(bad.any(1).sum())
            out[1] = max(out[1], float(d.max()))

    tree_map_with_path(visit, full, params)
    return tuple(out)


def p13_steps_held(variant, root, rank_losses):
    """Each step of the ranks against the single card's step from the
    ranks' state before it (the init before the first) on the same batch
    in the ranks' slices: its loss and the state after it. Also the whole
    batch at once from the same state, reported. Returns the worst errors
    over the steps, the state after the last step and the whole batch's
    (rows apart, max abs) by step."""
    model = p13_model(variant)
    step = make_grad_accum_train_step(model, "rwsadagrad", 2,
                                      hot_sizes=V2_HOT_SIZES)
    whole = make_train_step(model, "rwsadagrad", hot_sizes=V2_HOT_SIZES)
    params, state = p13_init(model, CUDA)
    worst = {"table": 0.0, "dense": 0.0, "acc": 0.0, "noise": 0,
             "rows": 0}
    apart = []
    for i, b in enumerate(p13_batches(model, CUDA)):
        alone = whole(tree_map(torch.clone, params),
                      {"step": i, "accum": tree_map(torch.clone,
                                                    state["accum"])},
                      b, P13_LR)[0]
        params, state, loss, _ = step(params, state, p13_slices(b),
                                      P13_LR)
        tag = f"phase 13 {variant} step {i}"
        for r, losses in enumerate(rank_losses):
            check(math.isclose(losses[i], float(loss), rel_tol=1e-5),
                  f"{tag}: rank {r}'s loss {losses[i]} vs the single "
                  f"card's {float(loss)}")
        full = torch.load(os.path.join(root, f"p13_{variant}_{i}.pt"),
                          map_location=CUDA)
        errs = p13_hold(tag, full, params, state["accum"])
        worst = {k: max(worst[k], errs[k]) for k in worst}
        apart.append(p13_apart(full["params"], alone))
        del alone
        params, state["accum"] = full["params"], full["accum"]
        state["step"] = i + 1
    return worst, params, apart


def phase_gspmd_train(root):
    """Phase 13: GspmdDLRM's training half over 2 ranks against the single
    card."""
    from dlrm_tpu_torch.parallel.launch import start_ranks

    t_phase = time.perf_counter()
    _, backend, staged = p9_world()
    world = 2
    log(f"phase 13: {world} ranks over {backend}"
        + (" with each collective staged through host memory" if staged
           else "") + f"; {len(P13_TABLES)} tables x {P13_TABLES[0]:,} rows "
        f"(cut from 200,000), d 128, batch {P13_BATCH:,} (cut from 16,384), "
        f"fp32 tower, rwsadagrad lr {P13_LR}, {P13_STEPS} steps a variant")
    job = start_ranks(p13_rank, world, args=(world, staged, root),
                      backend=backend)
    try:
        alone = {v: p13_independent(v) for v in P13_VARIANTS}
    except BaseException:
        job.close()
        raise
    ranks = job.wait(timeout_s=600)
    log(f"phase 13: the ranks done at {time.perf_counter() - t_phase:.1f} s")
    for variant, (losses, own) in alone.items():
        rs = [r[variant] for r in ranks]
        worst, last, apart = p13_steps_held(variant, root,
                                            [r["losses"] for r in rs])
        drift = max(float((a - b.to(a.device)).abs().max()) for a, b in zip(
            tree_leaves(own), tree_leaves(last)))
        log(f"phase 13 {variant}: rank 0's losses " + " ".join(
            f"{x:.6f}" for x in rs[0]["losses"]) + "; each step against the "
            "single card's in the ranks' slices from the same state, max "
            "abs: tables, q, r, v_w "
            f"{worst['table']:.3e} (rows beyond rtol / atol: at most "
            f"{worst['rows']} a step), dense {worst['dense']:.3e} "
            f"(rounding-level elements, held to lr: at most "
            f"{worst['noise']} a step), accumulators "
            f"{worst['acc']:.3e}; the single card's step on the whole "
            "batch at once from the same state (not held): rows of the "
            "tables, q, r, v_w beyond rtol / atol by step "
            f"{[a[0] for a in apart]}, max abs "
            + ", ".join(f"{a[1]:.3e}" for a in apart)
            + "; the single card's own run, the whole batch at once: "
            "losses "
            + " ".join(f"{x:.6f}" for x in losses) + f", params "
            f"{drift:.3e} from the ranks' after {P13_STEPS} steps (not "
            "held); padded rows by rank "
            f"{[r['padded'] for r in rs]}, all 0; s a step by rank "
            + ", ".join(f"{r['secs']:.3f}" for r in rs)
            + "; launches of the port's kernels: none")
        for i, r in enumerate(rs):
            check(np.allclose(r["losses"], losses, rtol=1e-5, atol=0),
                  f"phase 13 {variant}: rank {i} losses {r['losses']} vs "
                  f"the single card's own run's {losses}")
            check(r["padding_zero"], f"phase 13 {variant}: rank {i}'s "
                  "padded rows moved")
            launched = {k: v for k, v in r["launches"].items() if v}
            check(not launched, f"phase 13 {variant}: rank {i} launched "
                  f"{launched}")
        del own, last
        torch.cuda.empty_cache()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


def tools_only():
    """`python3 chip_smoke.py --tools`: the build, then phase 12 alone; no
    "ok" line is printed."""
    t_start = time.perf_counter()
    try:
        phase_build()
        root = os.path.dirname(os.path.abspath(__file__))
        with tempfile.TemporaryDirectory(prefix=".smoke_data_",
                                         dir=root) as tmp:
            by_path = phase_tools(tmp)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"phase 12 launches by path: {json.dumps(by_path)}")
    log(f"chip_smoke --tools: done in {time.perf_counter() - t_start:.1f} s")
    return 0


def device_times():
    """`python3 chip_smoke.py --device-times`: the build, then only the
    launch path's host us (phase 2b), phase 5's split times (T2-T6 at
    P6's size, T3, T6, T2 and T4 at scale, P2b's takes), with their checks
    against the plain versions, and the stream probes' times (P2a, P4, P3
    at the main-path shape); no other phase runs, and no "ok" line is
    printed."""
    t_start = time.perf_counter()
    try:
        phase_build()
        launch_path_host_us()
        feasibility_vs_plain()
        feasibility_at_scale()
        p2b_takes()
        stream_probe_times()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke --device-times: done in "
        f"{time.perf_counter() - t_start:.1f} s")
    return 0


K1_ROUNDS = 3


def k1_times():
    """`python3 chip_smoke.py --k1`: the build, then K1 alone on phase 4's
    work (a batch of the full-width plan, unit weights, a random fp32 dly
    as the [B, T, d] cotangent's transposed view, mm_dtype bf16): G_u in
    fp32 and in bf16, each bit for bit against its plain version, and K1
    on dly cast to bf16 first (the kernel's own rounding, so the same
    bits); then in K1_ROUNDS rounds the ms of each (CUDA events, 20 calls),
    of the cast and K1 together, of gather_grads and of K1's library call,
    and the bound. Prints one JSON line {"k1": ...}; no "ok" line."""
    t_start = time.perf_counter()
    bf16 = torch.bfloat16
    try:
        phase_build()
        tables = (200_000,) * 26
        plan = make_stream_plan(tables, 128, BATCH, V2_HOT_SIZES,
                                block_rows=2048)
        timing = {"read": 0.0, "build": 0.0, "h2d": 0.0}
        cfg = DLRMConfig(embedding_dim=128, table_sizes=tables,
                         mlp_bot=(13, 512, 256, 128))
        hb = host_batch(np.random.default_rng(0), plan, cfg, timing,
                        touched=False)
        sw = to_dev(hb, plan, timing).stream
        dly = torch.randn((BATCH, len(tables), 128), generator=_gen(6),
                          device="cuda").transpose(0, 1)
        args = (sw.vals_u, (sw.rows_u != SENTINEL_ROW).float(), sw.w2t)
        dly16 = dly.to(bf16)
        calls = {}
        out = {"slots": plan.u_total}
        for name, gdt in (("fp32", torch.float32), ("bf16", bf16)):
            kw = dict(mm_dtype=bf16, out_dtype=gdt)
            got = window_grads(dly, *args, **kw)
            check(torch.equal(got, window_grads_plain(dly, *args, **kw)),
                  f"--k1: K1 with {name} G_u differs from its plain version")
            check(torch.equal(window_grads(dly16, *args, **kw), got),
                  f"--k1: K1 on dly cast to bf16 differs ({name} G_u)")
            del got
            calls.update({
                f"K1 {name}": functools.partial(window_grads, dly, *args,
                                                **kw),
                f"K1 {name}, bf16 dly": functools.partial(
                    window_grads, dly16, *args, **kw),
                f"cast + K1 {name}": lambda kw=kw: window_grads(
                    dly.to(bf16), *args, **kw),
                f"gather_grads {name}": functools.partial(
                    gather_grads, dly, *args, out_dtype=gdt),
            })
            bound_ms, _ = bound(*kernel_work(plan, sw, hb, 4 if name ==
                                             "fp32" else 2)["window_grads"])
            out[f"bound {name}"] = bound_ms
        calls["cast"] = lambda: dly.to(bf16)
        for _ in range(K1_ROUNDS):
            for name, fn in calls.items():
                out.setdefault(name, []).append(time_ms(fn, CUDA, 20))
            for name, gdt in (("fp32", torch.float32), ("bf16", bf16)):
                out.setdefault(f"library {name}", []).append(
                    k1_library_ms((dly, *args), gdt))
        for name in ("fp32", "bf16"):
            log(f"--k1: K1 {name} G_u " + ", ".join(
                f"{x:.4f}" for x in out[f"K1 {name}"]) + f" ms; bound "
                f"{out[f'bound {name}']:.4f} ms")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps({"k1": out}))
    log(f"chip_smoke --k1: done in {time.perf_counter() - t_start:.1f} s")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--device-times"]:
        return device_times()
    if sys.argv[1:] == ["--tools"]:
        return tools_only()
    if sys.argv[1:] == ["--k1"]:
        return k1_times()
    t_start = time.perf_counter()
    try:
        phase_build()
        phase_k2_vs_plain()
        phase_new_kernels_vs_plain()
        k2 = phase_gather_path()
        new, k2["g_bf16"] = phase_kernel_path()
        probes = phase_probes()
        root = os.path.dirname(os.path.abspath(__file__))
        with tempfile.TemporaryDirectory(prefix=".smoke_data_",
                                         dir=root) as tmp:
            data_v2 = write_v2_dataset(tmp)
            phase_v2_trainer(data_v2)
            fused = phase_other_paths(tmp, data_v2)
            v1 = phase_v1_trainer(tmp)
            sharded = phase_sharded(tmp, data_v2)
            fused_sharded = phase_fused_sharded(tmp, data_v2)
            phase_serving(tmp)
            tools = phase_tools(tmp)
            phase_gspmd_train(tmp)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: phase 7a's; by path: 7a's, phase 8's, each phase-10 run's
    # (the sum over its ranks) and phase 12's (12b summed over its legs and
    # ranks, 12c's proxy run, 12g's launcher ranks)
    for entry in fused:
        name = entry["name"].split(" ")[0]
        entry["launches_by_path"] = {
            "7a": entry["launches"], **{t: c[name] for t, c in v1.items()},
            **{t: c[name] for t, c in fused_sharded.items()},
            **{t: c[name] for t, c in tools.items()}}
    # K2's launches: phase 3's; by path: 3's, each phase-9 run's (the sum
    # over its ranks, every rank once per step) and phase 12's (12b, 12c)
    k2["launches_by_path"] = {
        "3": k2["launches"], **sharded,
        **{t: c["stream_update"] for t, c in tools.items()
           if c["stream_update"]}}
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
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
