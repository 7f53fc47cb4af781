"""DLRM-v2 trainer on CUDA cards (the port of dlrm_tpu/v2_main.py, the
torchrec_dlrm/dlrm_main.py equivalent).

The flag surface is the JAX trainer's (dlrm_main.py:75-311, underscore
style). Ported: the single-device paths, which are the stream path (the
U-layout update, K2 on the card), the fused coalesce+scatter step
(train/fused_step.py, the coalesce_rows and row_scatter_add kernels on the
card) and the dense autograd step (train/step.py), with the dot, dcn and
projection interactions (the projection is torchrec's DLRM_Projection, both
--interaction_branch{1,2}_layer_sizes taken whole; the JAX trainer keeps
one linear map a branch of branch 1's last size) and weighted pooling; the sharded paths over
several ranks (--sharded, one model shard per rank): the stream butterfly
(parallel/stream_butterfly.py, K2 on each shard) and the fused butterfly
(parallel/butterfly.py, coalesce_rows and row_scatter_add on each shard,
with column-wise tables, owner bucketing and learned pooling weights); the
random-data, Multihot, materialized multi-hot and binary Criteo loaders
(--in_memory_binary_criteo_path, the packed bins of data/criteo.py), the
overlapped host pipeline (train/pipeline.py::DevicePrefetcher, a host
thread and a CUDA side stream), the LR policy, and per-epoch train/val/test
with the exact AUROC. A multi-rank run without --sharded raises
NotImplementedError (the JAX trainer would train one unsynchronized
replica per process); nothing falls back.

Usage, one card:
  python -m dlrm_tpu_torch.v2_main --embedding_dim 128 \\
      --num_embeddings_per_feature 200000,... --multi_hot_sizes 3,2,... \\
      --adagrad --embedding_impl stream --embedding_dtype bfloat16
W cards, one rank each (NCCL; rank r on cuda:LOCAL_RANK, rank 0 prints):
  python -m torch.distributed.run --nproc_per_node W \\
      -m dlrm_tpu_torch.v2_main --sharded --embedding_impl stream ...
  (--embedding_impl fused, or auto where it picks fused, trains the fused
  butterfly; --column_wise_tables 0,1 splits tables 0 and 1 by column)

It runs on the card; main(argv, device="cpu") runs it on the CPU, where
every kernel wrapper takes its plain PyTorch version (a multi-rank CPU run
needs a gloo process group first).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from dlrm_tpu_torch.config import DCNConfig, DLRMConfig, TrainConfig
from dlrm_tpu_torch.configs.presets import (
    CRITEO_1TB_COUNTS,
    CRITEO_KAGGLE_COUNTS,
)
from dlrm_tpu_torch.data.multi_hot import Multihot, RestartableMap
from dlrm_tpu_torch.data.multi_hot_criteo import MultiHotCriteoDataset
from dlrm_tpu_torch.data.random_data import RandomDataset
from dlrm_tpu_torch.device import process_count, resolve_device
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.ops.metrics import roc_auc_exact
from dlrm_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_tpu_torch.optim.optimizers import init_opt_state
from dlrm_tpu_torch.train.fused_step import (
    make_fused_train_step,
    supports_fused,
)
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
from dlrm_tpu_torch.train.step import make_eval_step, make_train_step
from dlrm_tpu_torch.train.stream_step import (
    cast_emb,
    init_stream_opt_state,
    make_stream_eval_step,
    make_stream_train_step,
    pad_params,
    plan_for_model,
)

# _pick_stream's cost model, from this card's own figures (chip_smoke.py
# phase 5 on NVIDIA H100 80GB HBM3, 700.00 W): a 2048-row block revolve
# streams 2,826-2,866 GB/s counting each byte read and written once
# (probes/revolve_probe.py; the lower end is taken), and index_add_ adds
# 1.00 ns per unique 512-byte row (probes/pallas_probe.py).
STREAM_BYTES_PER_S = 2.826e12
SCATTER_S_PER_HIT = 1.00e-9


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DLRM-v2 (torchrec-parity) on a CUDA card")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--test_batch_size", type=int, default=None)
    p.add_argument("--limit_train_batches", type=int, default=None)
    p.add_argument("--limit_val_batches", type=int, default=None)
    p.add_argument("--limit_test_batches", type=int, default=None)
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--num_embeddings", type=int, default=100_000)
    p.add_argument("--num_embeddings_per_feature", type=str, default=None)
    p.add_argument(
        "--dataset_name", type=str, default="criteo_1tb",
        choices=["criteo_1tb", "criteo_kaggle"],
        help="selects the default per-feature table sizes when "
        "--num_embeddings_per_feature is not given",
    )
    p.add_argument("--shuffle_training_set", action="store_true",
                   default=False)
    p.add_argument("--drop_last_training_batch", action="store_true",
                   default=False)
    p.add_argument("--print_sharding_plan", action="store_true",
                   default=False)
    p.add_argument("--allow_tf32", action="store_true", default=False,
                   help="let fp32 matmuls and convolutions use TF32 "
                   "(torch.backends.cuda.matmul / cudnn.allow_tf32); off "
                   "unless given")
    p.add_argument("--pin_memory", action="store_true", default=False)
    p.add_argument("--mmap_mode", action="store_true", default=False)
    p.add_argument("--undersampling_rate", type=float, default=None)
    p.add_argument("--dense_arch_layer_sizes", type=str, default="512,256,64")
    p.add_argument("--over_arch_layer_sizes", type=str, default="512,512,256,1")
    p.add_argument(
        "--interaction_type", type=str, default="original",
        choices=["original", "dcn", "projection"],
    )
    p.add_argument("--dcn_num_layers", type=int, default=3)
    p.add_argument("--dcn_low_rank_dim", type=int, default=512)
    p.add_argument("--interaction_branch1_layer_sizes", type=str, default="2048,2048")
    p.add_argument("--interaction_branch2_layer_sizes", type=str, default="2048,2048")
    p.add_argument("--learning_rate", type=float, default=15.0)
    p.add_argument("--adagrad", action="store_true", default=False)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--multi_hot_sizes", type=str, default=None)
    p.add_argument(
        "--multi_hot_distribution_type", type=str, default="uniform",
        choices=["uniform", "pareto"],
    )
    p.add_argument("--synthetic_multi_hot_criteo_path", type=str, default=None)
    p.add_argument("--in_memory_binary_criteo_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--validation_freq_within_epoch", type=int, default=None)
    p.add_argument("--shuffle_batches", action="store_true", default=False)
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lr_decay_start", type=int, default=0)
    p.add_argument("--lr_decay_steps", type=int, default=0)
    p.add_argument("--print_lr", action="store_true", default=False)
    p.add_argument(
        "--embedding_impl", choices=["auto", "dense", "fused", "stream"],
        default="auto",
        help="table update path: stream = the U-layout update (K2); fused "
        "= coalesce+scatter in the backward (fp32 tables); dense = plain "
        "autograd with the dense table gradient; auto picks stream or "
        "fused by the card's cost model (_pick_stream), or dense where "
        "fused does not apply (weighted pooling)",
    )
    p.add_argument(
        "--embedding_dtype", choices=["float32", "bfloat16"],
        default="float32",
        help="table storage dtype; bfloat16 halves the table's memory and "
        "pairs with stochastic-rounding updates on the stream path",
    )
    p.add_argument("--collect_multi_hot_freqs_stats", action="store_true")
    p.add_argument(
        "--weighted_pooling", choices=["fixed", "learned"], default=None,
        help="per-row pooling weights v_w (fixed = frozen, learned = "
        "trained), on the stream and dense paths",
    )
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=0)
    p.add_argument("--sharded", action="store_true", default=False)
    p.add_argument(
        "--sharding_strategy",
        choices=["auto", "round_robin", "table_wise", "mixed"],
        default="auto",
        help="table placement over the model axis of a multi-rank --sharded "
        "run (the TorchRec planner's role, dlrm_main.py:654-667). The "
        "streamed butterfly slots tables by size rank; auto adds the "
        "per-shard row budget of --hbm_gb, striping over-budget tables "
        "row-wise across every shard",
    )
    p.add_argument(
        "--hbm_gb", type=float, default=16.0,
        help="per-device memory (GiB) for the auto sharding capacity "
        "budget; the default, 16, is a TPU v5e figure kept for parity "
        "with the JAX trainer (an H100 holds 80)",
    )
    p.add_argument(
        "--column_wise_tables", type=str, default="",
        help="comma-separated table ids to shard column-wise over the model "
        "axis (the fused butterfly's layout)",
    )
    p.add_argument(
        "--rw_bucket", choices=["off", "on", "shared"], default="off",
        help="host-side OWNER BUCKETING of row-wise-striped tables' hits "
        "(parallel/rw_bucket.py): each shard gathers only the hits whose "
        "rows it owns (~hot/M + spill per bag) instead of masking all of "
        "them. 'on' = per-table caps; 'shared' = one owned-hits segment "
        "across all striped tables (the sigma padding is paid once). "
        "Requires a sharded plan that stripes",
    )
    p.add_argument(
        "--allow_capacity_overflow", action="store_true", default=False,
        help="proceed (with a warning) when even full row-wise striping "
        "cannot meet the per-shard row budget; default is a loud error",
    )
    p.add_argument("--auroc_target", type=float, default=None)
    return p


def _pick_stream(args, model_cfg, hot_sizes=None) -> bool:
    """embedding_impl=auto cost model: the streamed update's cost is one
    table stream (2 x table_bytes at the card's revolve rate,
    batch-independent); the scatter path costs one index_add_ row per
    hit. Pick stream when the stream is cheaper, i.e. medium tables / large
    batch. Explicit 'stream' always opts in."""
    if args.embedding_impl == "stream":
        return True
    if not supports_fused(DLRMModel(model_cfg)):
        return False
    bytes_per_el = 2 if args.embedding_dtype == "bfloat16" else 4
    table_bytes = sum(model_cfg.table_sizes) * model_cfg.embedding_dim * (
        bytes_per_el
    )
    stream_s = 2 * table_bytes / STREAM_BYTES_PER_S
    # per-sample hits = sum of the REAL per-table hot sizes (ragged configs
    # pad num_indices_per_lookup to the max)
    hits_per_sample = (
        sum(hot_sizes)
        if hot_sizes
        else model_cfg.num_tables * model_cfg.num_indices_per_lookup
    )
    scatter_s = args.batch_size * hits_per_sample * SCATTER_S_PER_HIT
    return stream_s < scatter_s


def _evaluate(eval_step, params, loader, to_device, stage: str,
              device) -> float:
    """AUROC over a stage (dlrm_main.py:314-366 analog), the same on every
    rank. One rank, or a world inside one node: the exact rank-sum AUC over
    every rank's scores (the JAX package's single controller sees the whole
    eval output). A world over several nodes: each rank folds its own rows
    into the additive score histogram and the bucket counts are summed over
    the ranks (torchmetrics AUROC's sync, dlrm_main.py:337-366). Pad rows
    (label < 0) are left out."""
    from dlrm_tpu_torch.ops.metrics import (
        AucState,
        allreduce_auc_state,
        auc_compute,
        auc_update,
        gather_scores_labels,
        shards_scores_labels,
    )
    from dlrm_tpu_torch.parallel.multihost import (
        local_world_size,
        world_size,
    )

    nodes = world_size() > local_world_size()
    hist = AucState.create()
    scores, labels = [], []
    for batch in DevicePrefetcher(loader, to_device, device=device):
        s, lbl = shards_scores_labels(eval_step(params, batch), batch.labels)
        if nodes:
            hist = auc_update(hist, s, lbl)  # label<0 pad rows masked inside
        else:
            keep = lbl >= 0
            scores.append(s[keep])
            labels.append(lbl[keep])
    if nodes:
        hist = allreduce_auc_state(
            hist, device if device.type == "cuda" else "cpu")
        n = int(hist.pos.sum() + hist.neg.sum())
        if n == 0:
            print(f"AUROC over {stage} set: n/a (empty loader)")
            return 0.0
        auroc = auc_compute(hist)
    else:
        s, l = gather_scores_labels(
            np.concatenate(scores) if scores else np.zeros(0),
            np.concatenate(labels) if labels else np.zeros(0))
        n = len(s)
        if n == 0:
            print(f"AUROC over {stage} set: n/a (empty loader)")
            return 0.0
        auroc = roc_auc_exact(s, l)
    print(f"AUROC over {stage} set: {auroc}")
    print(f"Number of {stage} samples: {n}")
    return auroc


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    """The trainer. A multi-rank --sharded run (torchrun, or a process group
    the caller made first) trains the streamed butterfly, one model shard
    per rank; every rank runs main and only rank 0 prints."""
    from dlrm_tpu_torch.parallel.multihost import rank, rank_device

    args = build_parser().parse_args(argv)
    world = process_count()
    if world > 1:
        device = rank_device(device)
    dev = resolve_device(device)
    if world > 1 and rank() != 0:
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            return _main(args, dev, world)
    return _main(args, dev, world)


def _main(args, dev, world: int) -> int:
    if args.undersampling_rate is not None:
        # the reference parses this flag but never consumes it either
        # (dlrm_main.py:183-188, no use site); subsampling belongs to
        # preprocessing (--data-sub-sample-rate on the v1 pipeline)
        raise SystemExit(
            "ERROR: --undersampling_rate is not implemented (the reference "
            "never consumes it; use preprocessing-time subsampling)"
        )
    torch.backends.cuda.matmul.allow_tf32 = args.allow_tf32
    torch.backends.cudnn.allow_tf32 = args.allow_tf32
    if args.pin_memory:
        print("NOTE: --pin_memory: batches already reach the card through "
              "pinned host memory (HostBatch.to_device)")
    if args.mmap_mode:
        print("NOTE: --mmap_mode: the materialized loader already "
              "memory-maps its .npy files")
    if args.num_embeddings_per_feature is not None:
        table_sizes = tuple(
            int(x) for x in args.num_embeddings_per_feature.split(",")
        )
    elif (args.in_memory_binary_criteo_path
          or args.synthetic_multi_hot_criteo_path):
        # dataset runs default to the dataset's published counts
        # (dlrm_dataloader.py:84-92 semantics)
        table_sizes = tuple(
            CRITEO_KAGGLE_COUNTS
            if args.dataset_name == "criteo_kaggle"
            else CRITEO_1TB_COUNTS
        )
    else:
        table_sizes = tuple([args.num_embeddings] * 26)
    hot_sizes = (
        [int(x) for x in args.multi_hot_sizes.split(",")]
        if args.multi_hot_sizes
        else None
    )
    interaction = {"original": "dot", "dcn": "dcn", "projection": "projection"}[
        args.interaction_type
    ]
    dense_arch = tuple(int(x) for x in args.dense_arch_layer_sizes.split(","))
    over_arch = tuple(int(x) for x in args.over_arch_layer_sizes.split(","))
    # torchrec's DLRM_Projection: both branches' layer sizes, whole
    branches = (None, None)
    if interaction == "projection":
        branches = tuple(
            tuple(int(x) for x in sizes.split(","))
            for sizes in (args.interaction_branch1_layer_sizes,
                          args.interaction_branch2_layer_sizes))
    model_cfg = DLRMConfig(
        embedding_dim=args.embedding_dim,
        table_sizes=table_sizes,
        mlp_bot=(13,) + dense_arch,
        mlp_top=over_arch,
        interaction=interaction,
        dcn=DCNConfig(args.dcn_num_layers, args.dcn_low_rank_dim)
        if interaction == "dcn"
        else None,
        interaction_branch1_layer_sizes=branches[0],
        interaction_branch2_layer_sizes=branches[1],
        loss="bce",
        num_indices_per_lookup=max(hot_sizes) if hot_sizes else 1,
        compute_dtype="bfloat16",
        weighted_pooling=args.weighted_pooling,
    )
    optimizer = "rwsadagrad" if args.adagrad else "sgd"
    model = DLRMModel(model_cfg)

    # ---------------- the path: sharded over the ranks (--sharded with a
    # world of more than one rank, the JAX trainer's multi-device mesh), or
    # one of the single-device branches
    multi = args.sharded and world > 1
    if world > 1 and not args.sharded:
        raise NotImplementedError(
            "a multi-rank run without --sharded is not supported (the JAX "
            "trainer would train one unsynchronized replica per process, "
            "which ROADMAP.md leaves out); pass --sharded"
        )
    if args.rw_bucket != "off" and not multi:
        raise SystemExit(
            "ERROR: --rw_bucket only applies to --sharded runs on a "
            "multi-device mesh (single-device training has no striped "
            "tables to bucket)"
        )
    if args.column_wise_tables and not multi:
        raise SystemExit(
            "ERROR: --column_wise_tables only applies to --sharded runs on "
            "a multi-device mesh (it splits the feature dim over the model "
            "axis)"
        )
    if multi:
        # auto applies the single-device cost model: per rank both sides
        # scale 1/model, so the comparison carries over
        stream_ok = args.embedding_impl == "stream" or (
            args.embedding_impl == "auto"
            and _pick_stream(args, model_cfg, hot_sizes)
        )
        if args.column_wise_tables and stream_ok:
            raise SystemExit(
                "ERROR: --column_wise_tables requires the fused "
                "coalesce+scatter embedding impl (pass --embedding_impl "
                "fused); the stream butterfly has no column-sharded layout"
            )
        if args.weighted_pooling and stream_ok:
            raise SystemExit(
                "ERROR: --weighted_pooling on a SHARDED mesh requires the "
                "fused butterfly (--embedding_impl fused) — the stream "
                "butterfly has no v_w slot layout; single-chip "
                "--embedding_impl stream trains v_w"
            )
    stream = stream_ok if multi else (
        args.embedding_impl in ("stream", "auto")
        and _pick_stream(args, model_cfg, hot_sizes))
    if stream and not model.fused:
        raise SystemExit("--embedding_impl stream needs plain uniform "
                         "tables (no qr/md)")

    # ---------------- data (dlrm_main.py:577-579 + get_dataloader dispatch)
    def make_loader(stage: str, limit: Optional[int]):
        if args.synthetic_multi_hot_criteo_path:
            with open(
                f"{args.synthetic_multi_hot_criteo_path}/meta.json"
            ) as f:
                meta = json.load(f)
            days = meta["days"]
            # the dataset's geometry is authoritative — a silent mismatch
            # with the CLI flags would gather garbage rows (indices wrap)
            if list(meta["table_sizes"]) != list(table_sizes):
                raise SystemExit(
                    f"--num_embeddings_per_feature {list(table_sizes)} != "
                    f"materialized table_sizes {meta['table_sizes']}"
                )
            if hot_sizes and list(meta["hot_sizes"]) != list(hot_sizes):
                raise SystemExit(
                    f"--multi_hot_sizes {list(hot_sizes)} != materialized "
                    f"hot_sizes {meta['hot_sizes']}"
                )
            day_sel = list(range(days - 1)) if stage == "train" else [days - 1]
            # last day splits into DISJOINT val/test halves (reference
            # day-23 split) — eval metrics must not leak into test
            split = {"train": None, "val": "first_half",
                     "test": "second_half"}[stage]
            ds = MultiHotCriteoDataset(
                args.synthetic_multi_hot_criteo_path,
                args.batch_size if stage == "train" else (
                    args.test_batch_size or args.batch_size
                ),
                days=day_sel,
                split=split,
            )
            # the JAX trainer lists the limited batches up front; the same
            # batches in the same order are read lazily here, because at
            # full width each padded batch holds ~340 MB of host arrays
            return ds if limit is None else _Limited(ds, limit)
        if args.in_memory_binary_criteo_path:
            loader = _binary_loader(args, stage, table_sizes)
        else:
            tc = TrainConfig(
                mini_batch_size=args.batch_size,
                num_batches=limit if limit is not None else 10,
                numpy_rand_seed=args.seed + {"train": 0, "val": 1,
                                             "test": 2}[stage],
                num_indices_per_lookup_fixed=True,
                round_targets=True,
            )
            # with --multi_hot_sizes the base loader generates ONE-hot
            # batches which the Multihot synthesizer expands below (the
            # reference wraps whatever loader is active,
            # dlrm_main.py:697-710)
            base_cfg = (
                model_cfg.replace(num_indices_per_lookup=1)
                if hot_sizes
                else model_cfg
            )
            loader = RandomDataset(base_cfg, tc, pad_last_batch=True)
        if hot_sizes:
            mh = Multihot(
                hot_sizes, table_sizes, args.batch_size,
                collect_freqs_stats=args.collect_multi_hot_freqs_stats,
                dist_type=args.multi_hot_distribution_type,
            )
            loader = mh.convert_dataloader(loader)
        if limit is not None:
            return RestartableMap(lambda x: x, _Limited(loader, limit))
        return loader

    train_loader = make_loader("train", args.limit_train_batches)
    val_loader = make_loader("val", args.limit_val_batches)
    test_loader = make_loader("test", args.limit_test_batches)

    # ---------------- model/optimizer (v2_main.py:454-734)
    if multi:
        sharded = _sharded if stream else _sharded_fused
        train_step, eval_step, params, opt_state, to_device, \
            eval_to_device = sharded(args, model, optimizer, hot_sizes, dev)
        rows_per_step = args.batch_size
    else:
        train_step, eval_step, params, opt_state, to_device, \
            eval_to_device = _single_device(args, model, optimizer,
                                            hot_sizes, stream, dev)
        rows_per_step = None

    lr_policy = LRPolicy(
        args.learning_rate, args.lr_warmup_steps, args.lr_decay_start,
        args.lr_decay_steps,
    )

    # ---------------- train/val/test (dlrm_main.py:451-500)
    def evaluate(loader, stage):
        return _evaluate(eval_step, params, loader, eval_to_device, stage,
                         dev)

    best_auroc = 0.0
    it = 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        n = 0
        loss = float("nan")  # stays NaN only if the train loader is empty
        for batch in DevicePrefetcher(train_loader, to_device, device=dev):
            if args.print_lr:
                print(f"lr: {it} {lr_policy.lr}")
            params, opt_state, loss, _ = train_step(
                params, opt_state, batch, lr_policy.lr
            )
            lr_policy.step()
            it += 1
            n += rows_per_step or batch.dense.shape[0]  # the global batch
            if (
                args.validation_freq_within_epoch
                and it % args.validation_freq_within_epoch == 0
            ):
                auroc = evaluate(val_loader, "val")
                best_auroc = max(best_auroc, auroc)
                if args.auroc_target and best_auroc >= args.auroc_target:
                    print(f"AUROC target {args.auroc_target} reached, stop early")
                    return 0
        # the epoch's one read of the device, taken before the clock stops
        # so that the samples/s count the device's work to its end
        final = float(loss)
        dt = time.perf_counter() - t0
        print(
            f"Epoch {epoch}: {n} samples in {dt:.1f}s "
            f"({n / dt:,.0f} samples/s), final loss {final:.6f}"
        )
        auroc = evaluate(val_loader, "val")
        best_auroc = max(best_auroc, auroc)
        if args.auroc_target and best_auroc >= args.auroc_target:
            print(f"AUROC target {args.auroc_target} reached, stop early")
            break
    evaluate(test_loader, "test")
    return 0


def _single_device(args, model, optimizer, hot_sizes, stream, dev):
    """The single-device branches: the stream path, else the fused step
    where it applies and dense was not asked for, else the dense step.
    Returns (train_step, eval_step, params, opt_state, to_device,
    eval_to_device)."""
    model_cfg = model.cfg
    params = model.init_params(seed=args.seed, device=dev)
    if stream:
        plan = plan_for_model(
            model, args.batch_size,
            hot_sizes=hot_sizes if hot_sizes else None,
        )
        params = pad_params(params, model, plan)
        bf16 = args.embedding_dtype == "bfloat16"
        if bf16:
            params = cast_emb(params, torch.bfloat16)
        opt_state = init_stream_opt_state(optimizer, params, plan)
        train_step = make_stream_train_step(
            model, optimizer, plan, grad_impl="gather",
            mm_dtype=torch.bfloat16 if bf16 else torch.float32,
            stochastic_round=bf16,
            eps=args.eps,
            device=dev,
        )
        eval_step = make_stream_eval_step(model, plan, device=dev)
        hot = plan.hot
        # the touched-only item list suits this path (gather forward, K2 in
        # place), and DLRM_K2_NO_ALIAS restores the full list as in the JAX
        # trainer
        touched = not os.environ.get("DLRM_K2_NO_ALIAS")

        def to_device(hb):  # the U-layout work rides each train batch
            return hb.with_stream_work(
                plan, update_touched_only=touched
            ).to_device(dev, flat_hots=hot)
    else:
        # the JAX trainer's last branch: the fused step where it applies
        # and dense was not asked for, else the dense autograd step (which
        # keeps the torch default eps, as the JAX trainer's does); both
        # keep fp32 tables
        hot = (tuple(hot_sizes) if hot_sizes
               else (model_cfg.num_indices_per_lookup,) * model_cfg.num_tables)
        opt_state = init_opt_state(optimizer, params)
        if supports_fused(model) and args.embedding_impl != "dense":
            print("embedding update: fused coalesce+scatter step")
            train_step = make_fused_train_step(model, optimizer, eps=args.eps,
                                               hot_sizes=hot)
        else:
            print("embedding update: dense autograd step")
            train_step = make_train_step(model, optimizer, hot_sizes=hot)
        eval_step = make_eval_step(model, hot_sizes=hot)

        def to_device(hb):
            return hb.to_device(dev, flat_hots=hot)

    # every path ships the flat per-hit layout: each table's real hot[t]
    # hits, not the padded [T, B, Hmax] block
    def eval_to_device(hb):
        return hb.to_device(dev, flat_hots=hot)

    return train_step, eval_step, params, opt_state, to_device, \
        eval_to_device


def _rank_mesh(args, dev):
    """The rank grid of a multi-rank --sharded run (the process group made
    first where the caller has not)."""
    import torch.distributed as dist

    from dlrm_tpu_torch.parallel.mesh import make_mesh
    from dlrm_tpu_torch.parallel.multihost import init_multihost

    init_multihost(dev)
    # a gloo group with CUDA tensors (ranks sharing a card) stages its
    # collectives through host memory; NCCL and gloo-on-CPU do not
    stage = dist.get_backend() == "gloo" and dev.type == "cuda"
    return make_mesh(
        data=args.mesh_data,
        model=args.mesh_model if args.mesh_model > 0 else None,
        stage=stage,
    )


def _sharded(args, model, optimizer, hot_sizes, dev):
    """The multi-rank --sharded stream path (the JAX trainer's
    StreamButterfly branch, v2_main.py:454-568): the grid over the ranks,
    this rank's shard of the plan, its params drawn directly (only its
    tables reach its device), per-rank batches. Returns what
    _single_device does."""
    from dlrm_tpu_torch.parallel.stream_butterfly import StreamButterfly

    mesh = _rank_mesh(args, dev)
    model_cfg = model.cfg
    cap = None
    if args.sharding_strategy == "auto":
        # the HBM-derived per-shard row budget: over-budget tables become
        # row-wise striped STREAM slots
        d = model_cfg.embedding_dim
        table_b = 2 if args.embedding_dtype == "bfloat16" else 4
        acc_b = {"adagrad": 4 * d, "rwsadagrad": 4}.get(optimizer, 0)
        cap = int(args.hbm_gb * (2**30) * 0.7 // (d * table_b + acc_b))
    bf16 = args.embedding_dtype == "bfloat16"
    sb_kw = dict(
        batch_size=args.batch_size,
        table_dtype=torch.bfloat16 if bf16 else torch.float32,
        hot_sizes=hot_sizes if hot_sizes else None,
        capacity_rows=cap,
        allow_capacity_overflow=args.allow_capacity_overflow,
        device=dev,
    )
    bf = StreamButterfly(model, mesh, **sb_kw)
    if args.rw_bucket != "off" and bf.num_rw == 0:
        raise SystemExit(
            f"ERROR: --rw_bucket {args.rw_bucket}, but the sharding plan "
            "stripes no table row-wise (nothing to bucket)"
        )
    rw_hots = [int(bf.hots_all[int(t)]) for t in bf.rw_ids]
    if args.rw_bucket == "shared":
        # ONE owned-hits segment per (shard, bag) across all striped tables
        bf = StreamButterfly(
            model, mesh, **sb_kw, rw_shared_cap="auto",
            rw_spill=max(6, max(rw_hots) // mesh.msize + 2),
        )
        print(f"rw bucketing: SHARED cap={bf.rw_shared} "
              f"spill={bf.rw_spill} over {bf.num_rw} striped slots")
    elif args.rw_bucket == "on":
        from dlrm_tpu_torch.parallel.rw_bucket import default_bucket_caps

        bf = StreamButterfly(
            model, mesh, **sb_kw,
            rw_bucket_caps=default_bucket_caps(rw_hots, mesh.msize),
            rw_spill=max(4, max(rw_hots) // mesh.msize + 2),
        )
        print(f"rw bucketing: caps={list(bf.rw_bucket_caps)} "
              f"spill={bf.rw_spill} over {bf.num_rw} striped slots")
    params = bf.init_params(seed=args.seed)
    opt_state = bf.init_opt_state(optimizer, params)
    train_step = bf.make_train_step(optimizer, args.batch_size, params,
                                    opt_state, eps=args.eps)
    eval_step = bf.make_eval_step(params)
    print(
        f"sharded stream-butterfly over {mesh.shape}, "
        f"{bf.num_rw} striped + "
        f"{model_cfg.num_tables - bf.num_rw} table-wise slots"
    )
    return (train_step, eval_step, params, opt_state, bf.shard_batch,
            lambda hb: bf.shard_batch(hb, with_stream=False))


def _sharded_fused(args, model, optimizer, hot_sizes, dev):
    """The multi-rank --sharded fused butterfly (the JAX trainer's
    ButterflyDLRM branch, v2_main.py:572-669): the planner's placement
    (--sharding_strategy, auto with the --hbm_gb budget of fp32 tables,
    --column_wise_tables), --rw_bucket on, the plan line and
    --print_sharding_plan's dump; this rank's params drawn directly. Returns
    what _single_device does."""
    from dlrm_tpu_torch.parallel.butterfly import ButterflyDLRM

    mesh = _rank_mesh(args, dev)
    model_cfg = model.cfg
    try:
        cw = [int(t) for t in args.column_wise_tables.split(",")
              if t.strip()] or None
    except ValueError:
        raise SystemExit(
            "ERROR: --column_wise_tables must be a comma-separated "
            f"list of table ids, got {args.column_wise_tables!r}"
        )
    if args.sharding_strategy == "auto":
        # the HBM-derived per-shard row budget (the TorchRec planner's
        # HeuristicalStorageReservation role, dlrm_main.py:658-666); the
        # fused butterfly's tables are fp32 whatever --embedding_dtype says
        d = model_cfg.embedding_dim
        acc_b = {"adagrad": 4 * d, "rwsadagrad": 4}.get(optimizer, 0)
        cap = int(args.hbm_gb * (2**30) * 0.7 // (d * 4 + acc_b))
        plan_kw = dict(
            strategy="mixed", capacity_rows=cap, cw_tables=cw,
            allow_capacity_overflow=args.allow_capacity_overflow,
        )
    else:
        plan_kw = dict(strategy=args.sharding_strategy, cw_tables=cw)
    plan_kw.update(hot_sizes=hot_sizes if hot_sizes else None, device=dev)
    bf = ButterflyDLRM(model, mesh, **plan_kw)
    if args.rw_bucket == "shared":
        raise SystemExit(
            "ERROR: --rw_bucket shared is a stream-butterfly "
            "layout (pass --embedding_impl stream); the fused "
            "butterfly supports --rw_bucket on (per-table caps)"
        )
    if args.rw_bucket == "on":
        if bf.num_rw == 0:
            raise SystemExit(
                "ERROR: --rw_bucket on, but the sharding plan "
                "stripes no table row-wise (nothing to bucket)"
            )
        # caps from the striped tables' real hot sizes (binomial mean + 3
        # sigma per owning shard)
        from dlrm_tpu_torch.parallel.rw_bucket import default_bucket_caps

        hs = hot_sizes or [1] * model_cfg.num_tables
        rw_hots = [int(hs[int(t)]) for t in bf.rw_ids]
        bf = ButterflyDLRM(
            model, mesh, **plan_kw,
            rw_bucket_caps=default_bucket_caps(rw_hots, mesh.msize),
            rw_spill=max(4, max(rw_hots) // mesh.msize + 2),
        )
        print(f"rw bucketing: caps={list(bf.rw_bucket_caps)} "
              f"spill={bf.rw_spill} over {bf.num_rw} striped tables")
    params = bf.init_params(seed=args.seed)
    # the JAX package's init on the sharded tree: a per-row rwsadagrad
    # accumulator of the column-wise block spans all its rows, the same on
    # every shard
    opt_state = init_opt_state(optimizer, params)
    rw, ncw = bf.num_rw, bf.num_cw
    print(
        f"sharding plan: {bf.placement.strategy}, "
        f"{rw} row-wise + {ncw} column-wise + "
        f"{model_cfg.num_tables - rw - ncw} table-wise "
        f"tables, {bf.placement.shard_rows} rows/shard"
    )
    if args.print_sharding_plan:
        # the per-table dump (dlrm_main.py:674-678)
        pl = bf.placement
        for t, n in enumerate(model_cfg.table_sizes):
            if pl.table_shard[t] == -2:
                d = model_cfg.embedding_dim
                print(f"  table {t}: column_wise, {d // mesh.msize} of {d} "
                      f"dims/shard ({n} rows)")
            elif pl.table_shard[t] < 0:
                print(f"  table {t}: row_wise, {pl.slice_len(t)} "
                      f"rows/shard of {n}")
            else:
                print(f"  table {t}: table_wise on shard "
                      f"{pl.table_shard[t]} ({n} rows)")
    train_step = bf.make_train_step(optimizer, args.batch_size, params,
                                    opt_state, eps=args.eps)
    return (train_step, bf.make_eval_step(params), params, opt_state,
            bf.shard_batch, bf.shard_batch)


def _binary_loader(args, stage: str, table_sizes):
    """The packed Criteo bins ({train,val,test}_data.bin and
    day_fea_count.npz, data/criteo.py's format) at --batch_size, as the
    JAX trainer reads them: --shuffle_batches permutes the train batches'
    order, --shuffle_training_set the train samples across the whole set
    (multi_hot_criteo.py:36-37 semantics). The dataset's counts must fit
    the model's tables, or its indices would wrap silently."""
    from dlrm_tpu_torch.data.criteo import CriteoBinFile

    path = args.in_memory_binary_criteo_path
    ds = CriteoBinFile(
        f"{path}/{stage}_data.bin",
        f"{path}/day_fea_count.npz",
        args.batch_size,
        drop_last=args.drop_last_training_batch if stage == "train" else False,
        shuffle_batches=args.shuffle_batches and stage == "train",
        shuffle_samples=args.shuffle_training_set and stage == "train",
        seed=args.seed,
    )
    over = [
        (i, int(c), int(t))
        for i, (c, t) in enumerate(zip(ds.counts, table_sizes))
        if int(c) > int(t)
    ]
    if over:
        raise SystemExit(
            f"ERROR: dataset counts exceed the model's table sizes for "
            f"columns {over[:4]}...; pass --num_embeddings_per_feature "
            "matching day_fea_count.npz"
        )
    return ds


class _Limited:
    def __init__(self, src, limit):
        self.src, self.limit = src, limit

    def __len__(self):
        return min(len(self.src), self.limit)

    def __iter__(self):
        return itertools.islice(iter(self.src), self.limit)


if __name__ == "__main__":
    sys.exit(main())
