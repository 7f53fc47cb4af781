"""DLRM-v2 trainer on one CUDA card (the port of dlrm_tpu/v2_main.py, the
torchrec_dlrm/dlrm_main.py equivalent).

The flag surface is the JAX trainer's (dlrm_main.py:75-311, underscore
style). Ported: the single-device stream path (the U-layout update, K2 on
the card), the random-data, Multihot and materialized multi-hot loaders,
the overlapped host pipeline (train/pipeline.py::DevicePrefetcher, a host
thread and a CUDA side stream), the LR policy, and per-epoch train/val/test
with the exact AUROC. Branches that are not ported raise
NotImplementedError naming their ROADMAP queue A item; none falls back.

Usage:
  python -m dlrm_tpu_torch.v2_main --embedding_dim 128 \\
      --num_embeddings_per_feature 200000,... --multi_hot_sizes 3,2,... \\
      --adagrad --embedding_impl stream --embedding_dtype bfloat16

It runs on the card; main(argv, device="cpu") runs it on the CPU, where
every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import argparse
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
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
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
        help="table update path: stream = the U-layout update (K2), ported; "
        "fused (coalesce+scatter in the backward) and dense (plain "
        "autograd) are not ported yet; auto picks stream or fused by the "
        "card's cost model (_pick_stream)",
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
        "trained); not ported yet",
    )
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=0)
    p.add_argument("--sharded", action="store_true", default=False)
    p.add_argument(
        "--sharding_strategy",
        choices=["auto", "round_robin", "table_wise", "mixed"],
        default="auto",
        help="table placement over the model axis of a multi-device run "
        "(not ported yet)",
    )
    p.add_argument(
        "--hbm_gb", type=float, default=16.0,
        help="per-device memory (GiB) for the sharded plan's capacity "
        "budget (multi-device runs, not ported yet)",
    )
    p.add_argument(
        "--column_wise_tables", type=str, default="",
        help="comma-separated table ids to shard column-wise "
        "(multi-device runs, not ported yet)",
    )
    p.add_argument(
        "--rw_bucket", choices=["off", "on", "shared"], default="off",
        help="owner bucketing of row-wise-striped tables' hits "
        "(multi-device runs, not ported yet)",
    )
    p.add_argument(
        "--allow_capacity_overflow", action="store_true", default=False,
        help="proceed when the sharded plan cannot meet its per-device "
        "row budget (multi-device runs, not ported yet)",
    )
    p.add_argument("--auroc_target", type=float, default=None)
    return p


def supports_fused(model: DLRMModel) -> bool:
    """The fused step's precondition (dlrm_tpu/train/fused_step.py)."""
    return model.fused and model.cfg.weighted_pooling is None


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
    """AUROC over a stage (dlrm_main.py:314-366 analog): the exact
    rank-sum AUC over the concatenated scores of one process; pad rows
    (label < 0) are left out."""
    scores, labels = [], []
    for batch in DevicePrefetcher(loader, to_device, device=device):
        probs = eval_step(params, batch)
        lbl = batch.labels.cpu().numpy().ravel()
        keep = lbl >= 0
        scores.append(probs.float().cpu().numpy().ravel()[keep])
        labels.append(lbl[keep])
    if not scores:
        print(f"AUROC over {stage} set: n/a (empty loader)")
        return 0.0
    s, l = np.concatenate(scores), np.concatenate(labels)
    auroc = roc_auc_exact(s, l)
    print(f"AUROC over {stage} set: {auroc}")
    print(f"Number of {stage} samples: {len(s)}")
    return auroc


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    if process_count() > 1:
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP queue A "
            "item 11)"
        )
    if args.undersampling_rate is not None:
        # the reference parses this flag but never consumes it either
        # (dlrm_main.py:183-188, no use site); subsampling belongs to
        # preprocessing (--data-sub-sample-rate on the v1 pipeline)
        raise SystemExit(
            "ERROR: --undersampling_rate is not implemented (the reference "
            "never consumes it; use preprocessing-time subsampling)"
        )
    if args.in_memory_binary_criteo_path:
        raise NotImplementedError(
            "--in_memory_binary_criteo_path (data/criteo.py's binary "
            "loader) is not ported yet (ROADMAP queue A item 10)"
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
    elif args.synthetic_multi_hot_criteo_path:
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
    proj = None
    if interaction == "projection":
        b1 = tuple(int(x) for x in args.interaction_branch1_layer_sizes.split(","))
        proj = (b1[-1] // dense_arch[-1],)
    model_cfg = DLRMConfig(
        embedding_dim=args.embedding_dim,
        table_sizes=table_sizes,
        mlp_bot=(13,) + dense_arch,
        mlp_top=over_arch,
        interaction=interaction,
        dcn=DCNConfig(args.dcn_num_layers, args.dcn_low_rank_dim)
        if interaction == "dcn"
        else None,
        proj_interaction_dims=proj,
        loss="bce",
        num_indices_per_lookup=max(hot_sizes) if hot_sizes else 1,
        compute_dtype="bfloat16",
        weighted_pooling=args.weighted_pooling,
    )
    optimizer = "rwsadagrad" if args.adagrad else "sgd"
    model = DLRMModel(model_cfg)

    # ---------------- the path: only the single-device stream branch
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    multi = args.sharded and n_devices > 1
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
        raise NotImplementedError(
            "--sharded over more than one CUDA device is not ported yet "
            "(ROADMAP queue A item 11)"
        )
    if not (args.embedding_impl in ("stream", "auto")
            and _pick_stream(args, model_cfg, hot_sizes)):
        raise NotImplementedError(
            f"--embedding_impl {args.embedding_impl} takes the "
            + ("dense autograd step" if args.embedding_impl == "dense"
               else "fused coalesce+scatter step")
            + ", which is not ported yet (ROADMAP queue A item 8); pass "
            "--embedding_impl stream"
        )
    if not model.fused:
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
        tc = TrainConfig(
            mini_batch_size=args.batch_size,
            num_batches=limit if limit is not None else 10,
            numpy_rand_seed=args.seed + {"train": 0, "val": 1, "test": 2}[stage],
            num_indices_per_lookup_fixed=True,
            round_targets=True,
        )
        # with --multi_hot_sizes the base loader generates ONE-hot batches
        # which the Multihot synthesizer expands below (the reference wraps
        # whatever loader is active, dlrm_main.py:697-710)
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

    # ---------------- model/optimizer: the stream branch (v2_main.py:671-724)
    params = model.init_params(seed=args.seed, device=dev)
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
    # the flat per-hit layout ships each table's real plan.hot[t] hits, not
    # the padded [T, B, Hmax] block; the touched-only item list suits this
    # path (gather forward, K2 in place), and DLRM_K2_NO_ALIAS restores
    # the full list as in the JAX trainer
    touched = not os.environ.get("DLRM_K2_NO_ALIAS")

    def to_device(hb):  # the U-layout work rides each train batch
        return hb.with_stream_work(
            plan, update_touched_only=touched
        ).to_device(dev, flat_hots=plan.hot)

    def eval_to_device(hb):
        return hb.to_device(dev, flat_hots=plan.hot)

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
            n += batch.dense.shape[0]
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


class _Limited:
    def __init__(self, src, limit):
        self.src, self.limit = src, limit

    def __len__(self):
        return min(len(self.src), self.limit)

    def __iter__(self):
        return itertools.islice(iter(self.src), self.limit)


if __name__ == "__main__":
    sys.exit(main())
