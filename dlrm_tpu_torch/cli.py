"""The v1 trainer's entry point, with the reference's flags
(dlrm_s_pytorch.py:904-1021 argparse surface): the port of dlrm_tpu/cli.py,
on one CUDA card.

Usage:  python -m dlrm_tpu_torch.cli --mini-batch-size=2 --data-size=6

Every flag keeps the JAX package's name and default, so reference
invocations run unchanged. main(argv, device="cuda") trains on the card;
main(argv, device="cpu") runs the same trainer on the CPU (the tests do).
What is not ported raises NotImplementedError naming its ROADMAP item:
--sharded and multi-process launches (item 11), --plot-compute-graph,
--save-onnx and quantized --inference-only (item 12).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from dlrm_tpu_torch.config import (
    DCNConfig,
    DLRMConfig,
    MDConfig,
    QRConfig,
    TrainConfig,
)


def dash_separated_ints(value: str) -> str:
    """Validator matching the reference's flag format (dlrm_s_pytorch.py:733-744)."""
    vals = value.split("-")
    for val in vals:
        try:
            int(val)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{value} is not a valid dash-separated list of ints"
            )
    return value


def dash_separated_floats(value: str) -> str:
    vals = value.split("-")
    for val in vals:
        try:
            float(val)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{value} is not a valid dash-separated list of floats"
            )
    return value


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DLRM v1 trainer on one CUDA card")
    # model arch
    p.add_argument("--arch-sparse-feature-size", type=int, default=2)
    p.add_argument("--arch-embedding-size", type=dash_separated_ints, default="4-3-2")
    p.add_argument("--arch-mlp-bot", type=dash_separated_ints, default="4-3-2")
    p.add_argument("--arch-mlp-top", type=dash_separated_ints, default="4-2-1")
    p.add_argument(
        "--arch-interaction-op", type=str, default="dot",
        choices=["dot", "cat", "dcn", "projection"],
    )
    p.add_argument("--arch-interaction-itself", action="store_true", default=False)
    p.add_argument("--weighted-pooling", type=str, default=None)
    # dcn / projection (torchrec_dlrm/dlrm_main.py:170-194)
    p.add_argument("--dcn-num-layers", type=int, default=3)
    p.add_argument("--dcn-low-rank-dim", type=int, default=512)
    p.add_argument("--interaction-branch1-layer-sizes", type=dash_separated_ints, default="2048-2048")
    p.add_argument("--interaction-branch2-layer-sizes", type=dash_separated_ints, default="2048-2048")
    # embedding tricks
    p.add_argument("--md-flag", action="store_true", default=False)
    p.add_argument("--md-threshold", type=int, default=200)
    p.add_argument("--md-temperature", type=float, default=0.3)
    p.add_argument("--md-round-dims", action="store_true", default=False)
    p.add_argument("--qr-flag", action="store_true", default=False)
    p.add_argument("--qr-threshold", type=int, default=200)
    p.add_argument("--qr-operation", type=str, default="mult")
    p.add_argument("--qr-collisions", type=int, default=4)
    # activations and loss
    p.add_argument("--activation-function", type=str, default="relu")
    p.add_argument("--loss-function", type=str, default="mse")
    p.add_argument("--loss-weights", type=dash_separated_floats, default="1.0-1.0")
    p.add_argument("--loss-threshold", type=float, default=0.0)
    p.add_argument("--round-targets", type=bool, default=False)
    # data
    p.add_argument("--data-size", type=int, default=1)
    p.add_argument("--num-batches", type=int, default=0)
    p.add_argument(
        "--data-generation", type=str, default="random",
        choices=["random", "synthetic", "dataset"],
    )
    p.add_argument("--rand-data-dist", type=str, default="uniform")
    p.add_argument("--rand-data-min", type=float, default=0)
    p.add_argument("--rand-data-max", type=float, default=1)
    p.add_argument("--rand-data-mu", type=float, default=-1)
    p.add_argument("--rand-data-sigma", type=float, default=1)
    p.add_argument("--data-trace-file", type=str, default="./input/dist_emb_j.log")
    p.add_argument("--data-set", type=str, default="kaggle")
    p.add_argument("--raw-data-file", type=str, default="")
    p.add_argument("--processed-data-file", type=str, default="")
    p.add_argument("--data-randomize", type=str, default="total")
    p.add_argument("--data-trace-enable-padding", type=bool, default=False)
    p.add_argument("--max-ind-range", type=int, default=-1)
    p.add_argument("--data-sub-sample-rate", type=float, default=0.0)
    p.add_argument("--num-indices-per-lookup", type=int, default=10)
    p.add_argument("--num-indices-per-lookup-fixed", type=bool, default=False)
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--memory-map", action="store_true", default=False)
    # training
    p.add_argument("--mini-batch-size", type=int, default=1)
    p.add_argument("--nepochs", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.01)
    # LR policy (LRPolicyScheduler, dlrm_s_pytorch.py:169-203)
    p.add_argument("--lr-num-warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-start-step", type=int, default=0)
    p.add_argument("--lr-num-decay-steps", type=int, default=0)
    # DDP dense sync toggle (dlrm_s_pytorch.py:971): one device has no
    # dense all-reduce, so False only prints a notice. (The reference uses
    # type=bool, which parses "False" as True; _str2bool does not.)
    p.add_argument(
        "--sync-dense-params", type=_str2bool, default=True
    )
    p.add_argument("--print-precision", type=int, default=5)
    p.add_argument("--numpy-rand-seed", type=int, default=123)
    p.add_argument("--optimizer", type=str, default="sgd")
    p.add_argument(
        "--dataset-multiprocessing", action="store_true", default=False
    )
    # inference / quantization
    p.add_argument("--inference-only", action="store_true", default=False)
    p.add_argument("--quantize-mlp-with-bit", type=int, default=32)
    p.add_argument("--quantize-emb-with-bit", type=int, default=32)
    # the JAX package's extension: 16 quantized rows per packed line
    p.add_argument("--quantize-group16", action="store_true", default=False)
    # serialized-model export (dlrm_s_pytorch.py:987, 1828+)
    p.add_argument("--save-onnx", action="store_true", default=False)
    # device / distributed
    p.add_argument("--use-gpu", action="store_true", default=False)  # ignored
    p.add_argument("--use-tpu", action="store_true", default=True)
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--dist-backend", type=str, default="")
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-model", type=int, default=0)  # 0 = all remaining
    p.add_argument("--sharded", action="store_true", default=False)
    # planner controls under --sharded (same semantics as v2_main; default
    # round_robin = v1 parity, dlrm_s_pytorch.py:636 `k % ndevices`)
    p.add_argument(
        "--sharding-strategy",
        choices=["round_robin", "table_wise", "mixed", "auto"],
        default="round_robin",
        help="table placement over the model axis; auto = mixed with an "
        "HBM-derived per-shard row budget (--hbm-gb)",
    )
    # default None = "not given" (resolved to 16.0 after the misuse check
    # in main): an explicit --hbm-gb off the auto plan is rejected
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-chip HBM (GiB) for the auto capacity budget "
                   "(default 16)")
    p.add_argument(
        "--column-wise-tables", type=str, default="",
        help="comma-separated table ids to shard column-wise (feature dim "
        "splits over the model axis)",
    )
    p.add_argument(
        "--rw-bucket", choices=["off", "on"], default="off",
        help="owner-bucket row-wise-striped tables' hits so each shard "
        "gathers only rows it owns (requires a plan that stripes)",
    )
    p.add_argument("--allow-capacity-overflow", action="store_true",
                   default=False)
    # debug / profiling
    p.add_argument("--print-freq", type=int, default=1)
    p.add_argument("--test-freq", type=int, default=-1)
    p.add_argument("--test-mini-batch-size", type=int, default=-1)
    p.add_argument("--test-num-workers", type=int, default=-1)
    p.add_argument("--print-time", action="store_true", default=False)
    p.add_argument("--print-wall-time", action="store_true", default=False)
    p.add_argument("--debug-mode", action="store_true", default=False)
    p.add_argument("--enable-profiling", action="store_true", default=False)
    p.add_argument("--plot-compute-graph", action="store_true", default=False)
    p.add_argument("--tensor-board-filename", type=str, default="")
    # checkpointing
    p.add_argument("--save-model", type=str, default="")
    p.add_argument("--load-model", type=str, default="")
    # mlperf
    p.add_argument("--mlperf-logging", action="store_true", default=False)
    p.add_argument("--mlperf-acc-threshold", type=float, default=0.0)
    p.add_argument("--mlperf-auc-threshold", type=float, default=0.0)
    p.add_argument("--mlperf-bin-loader", action="store_true", default=False)
    p.add_argument("--mlperf-bin-shuffle", action="store_true", default=False)
    p.add_argument("--mlperf-grad-accum-iter", type=int, default=1)
    # compute
    p.add_argument("--compute-dtype", type=str, default="float32")
    return p


def configs_from_args(args) -> tuple[DLRMConfig, TrainConfig]:
    ln_emb = tuple(int(x) for x in args.arch_embedding_size.split("-"))
    mlp_bot = tuple(int(x) for x in args.arch_mlp_bot.split("-"))
    mlp_top = tuple(int(x) for x in args.arch_mlp_top.split("-"))
    loss_w = tuple(float(x) for x in args.loss_weights.split("-"))
    qr = (
        QRConfig(
            collisions=args.qr_collisions,
            threshold=args.qr_threshold,
            operation=args.qr_operation,
        )
        if args.qr_flag
        else None
    )
    md = (
        MDConfig(
            temperature=args.md_temperature,
            threshold=args.md_threshold,
            round_dims=args.md_round_dims,
        )
        if args.md_flag
        else None
    )
    dcn = (
        DCNConfig(num_layers=args.dcn_num_layers, low_rank_dim=args.dcn_low_rank_dim)
        if args.arch_interaction_op == "dcn"
        else None
    )
    proj = None
    if args.arch_interaction_op == "projection":
        b1 = tuple(int(x) for x in args.interaction_branch1_layer_sizes.split("-"))
        d = mlp_bot[-1]
        if b1[-1] % d != 0:
            sys.exit(
                "ERROR: interaction branch1 layer sizes must be divisible by "
                "embedding dim"
            )
        proj = (b1[-1] // d,)
    model_cfg = DLRMConfig(
        embedding_dim=args.arch_sparse_feature_size,
        table_sizes=ln_emb,
        mlp_bot=mlp_bot,
        mlp_top=mlp_top,
        interaction=args.arch_interaction_op,
        interaction_itself=args.arch_interaction_itself,
        num_indices_per_lookup=args.num_indices_per_lookup,
        dcn=dcn,
        proj_interaction_dims=proj,
        qr=qr,
        md=md,
        weighted_pooling=args.weighted_pooling,
        loss=args.loss_function,
        loss_weights=loss_w,
        loss_threshold=args.loss_threshold,
        compute_dtype=args.compute_dtype,
    )
    train_cfg = TrainConfig(
        mini_batch_size=args.mini_batch_size,
        test_mini_batch_size=args.test_mini_batch_size,
        nepochs=args.nepochs,
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        lr_num_warmup_steps=args.lr_num_warmup_steps,
        lr_decay_start_step=args.lr_decay_start_step,
        lr_num_decay_steps=args.lr_num_decay_steps,
        data_generation=args.data_generation,
        data_size=args.data_size,
        num_batches=args.num_batches,
        numpy_rand_seed=args.numpy_rand_seed,
        round_targets=args.round_targets,
        num_indices_per_lookup_fixed=args.num_indices_per_lookup_fixed,
        rand_data_dist=args.rand_data_dist,
        rand_data_min=args.rand_data_min,
        rand_data_max=args.rand_data_max,
        rand_data_mu=args.rand_data_mu,
        rand_data_sigma=args.rand_data_sigma,
        print_freq=args.print_freq,
        test_freq=args.test_freq,
        print_time=args.print_time,
        print_wall_time=args.print_wall_time,
        debug_mode=args.debug_mode,
        grad_accum_iter=args.mlperf_grad_accum_iter,
        mlperf_logging=args.mlperf_logging,
        mlperf_acc_threshold=args.mlperf_acc_threshold,
        mlperf_auc_threshold=args.mlperf_auc_threshold,
        save_model=args.save_model,
        load_model=args.load_model,
        inference_only=args.inference_only,
    )
    return model_cfg, train_cfg


def _unported(args) -> Optional[str]:
    """The message of the first flag that asks for an unported branch."""
    if args.sharded:
        return ("--sharded (multi-GPU training) is not ported yet (ROADMAP "
                "queue A item 11)")
    if args.plot_compute_graph:
        return ("--plot-compute-graph is not ported yet (ROADMAP queue A "
                "item 12)")
    if args.save_onnx:
        return "--save-onnx is not ported yet (ROADMAP queue A item 12)"
    if args.inference_only and (args.quantize_emb_with_bit in (4, 8)
                                or args.quantize_mlp_with_bit in (8, 16)):
        return ("quantized --inference-only (--quantize-emb-with-bit / "
                "--quantize-mlp-with-bit) is not ported yet (ROADMAP queue "
                "A item 12)")
    return None


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    np.set_printoptions(precision=args.print_precision)

    from dlrm_tpu_torch.data.random_data import RandomDataset
    from dlrm_tpu_torch.device import process_count, resolve_device
    from dlrm_tpu_torch.models.dlrm import DLRMModel
    from dlrm_tpu_torch.train.harness import Trainer, dump_parameters
    from dlrm_tpu_torch.utils import logging as obs
    from dlrm_tpu_torch.utils.profiling import profile

    dev = resolve_device(device)
    if process_count() > 1:
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP queue A "
            "item 11)"
        )

    if args.quantize_group16 and not (
        args.quantize_emb_with_bit in (4, 8) and args.inference_only
    ):
        sys.exit(
            "ERROR: --quantize-group16 requires --quantize-emb-with-bit 4|8 "
            "AND --inference-only (it would otherwise be a silent no-op)"
        )
    if not args.sharded and (
        args.sharding_strategy != "round_robin"
        or args.column_wise_tables
        or args.rw_bucket == "on"
    ):
        sys.exit(
            "ERROR: --sharding-strategy/--column-wise-tables/--rw-bucket "
            "plan the model-axis table placement and require --sharded"
        )
    # --allow-capacity-overflow / --hbm-gb only feed the auto capacity plan;
    # anywhere else they would be silent no-ops
    if args.allow_capacity_overflow and not (
        args.sharded and args.sharding_strategy == "auto"
    ):
        sys.exit(
            "ERROR: --allow-capacity-overflow only affects the HBM-budget "
            "capacity plan; it requires --sharded --sharding-strategy auto"
        )
    if args.hbm_gb is not None and not (
        args.sharded and args.sharding_strategy == "auto"
    ):
        sys.exit(
            "ERROR: --hbm-gb only sets the auto plan's per-shard row "
            "budget; it requires --sharded --sharding-strategy auto"
        )
    if not args.sync_dense_params:
        print(
            "NOTE: --sync-dense-params=False has no effect on one device "
            "(there is no dense-gradient all-reduce to skip)"
        )
    if args.activation_function != "relu":
        # the reference parses this flag but never consumes it
        # (dlrm_s_pytorch.py:930 has no use site): relu is its only
        # activation too
        sys.exit(
            f"ERROR: --activation-function {args.activation_function!r} is "
            "not supported (only 'relu' is implemented, matching the "
            "reference's actual behavior)"
        )
    unported = _unported(args)
    if unported:
        raise NotImplementedError(unported)

    # the INIT block opens before any setup work (dlrm_s_pytorch.py:1036-1040)
    # and after the flag checks, so a rejected invocation leaves no open
    # INIT block; the harness closes it with INIT_STOP as training starts
    mlperf = obs.MLPerfLogger(enabled=args.mlperf_logging)
    mlperf.event(obs.CACHE_CLEAR, value=True)
    mlperf.start(obs.INIT_START)

    model_cfg, train_cfg = configs_from_args(args)
    train_data = test_data = None
    if train_cfg.data_generation == "dataset":
        from dlrm_tpu_torch.data.criteo import NUM_DENSE, make_criteo_datasets

        train_data, test_data = make_criteo_datasets(
            model_cfg, train_cfg, args
        )
        # dataset runs take the table sizes from the data's counts and the
        # bottom MLP's input width from the dense feature count
        # (dlrm_s_pytorch.py:1123-1124, 1139-1151; the counts are already
        # hashed down by --max-ind-range)
        model_cfg = model_cfg.replace(
            table_sizes=tuple(int(c) for c in train_data.counts),
            mlp_bot=(NUM_DENSE,) + tuple(model_cfg.mlp_bot[1:]),
        )
    model = DLRMModel(model_cfg)

    if args.debug_mode:
        print("model arch:")
        print(
            f"mlp top arch {len(model_cfg.ln_top) - 1} layers, with input to "
            f"output dimensions:"
        )
        print(np.asarray(model_cfg.ln_top))
        print("# of interactions")
        print(model_cfg.interaction_output_dim)
        print(
            f"mlp bot arch {len(model_cfg.mlp_bot) - 1} layers, with input to "
            f"output dimensions:"
        )
        print(np.asarray(model_cfg.mlp_bot))
        print("# of features (sparse and dense)")
        print(model_cfg.num_features)
        print("dense feature size")
        print(model_cfg.num_dense)
        print("sparse feature size")
        print(model_cfg.embedding_dim)
        print(
            f"# of embeddings (= # of sparse features) {model_cfg.num_tables}, "
            f"with dimensions {model_cfg.embedding_dim}x:"
        )
        print(np.asarray(model_cfg.table_sizes))

    if train_cfg.data_generation in ("random", "synthetic"):
        train_data = RandomDataset(
            model_cfg, train_cfg,
            trace_file=args.data_trace_file,
            enable_padding=args.data_trace_enable_padding,
        )
        test_data = RandomDataset(
            model_cfg, train_cfg, pad_last_batch=True,
            trace_file=args.data_trace_file,
            enable_padding=args.data_trace_enable_padding,
        )

    if args.num_workers > 0:
        # torch DataLoader(num_workers) analog: a producer thread builds the
        # host batches ahead (dlrm_s_pytorch.py:997)
        from dlrm_tpu_torch.train.pipeline import HostPrefetcher

        train_data = HostPrefetcher(train_data, depth=2 * args.num_workers)
    test_workers = (
        args.test_num_workers if args.test_num_workers >= 0 else args.num_workers
    )
    if test_workers > 0 and test_data is not None:
        from dlrm_tpu_torch.train.pipeline import HostPrefetcher

        test_data = HostPrefetcher(test_data, depth=2 * test_workers)

    scalar_log = obs.ScalarLogger(
        args.tensor_board_filename + ".scalars.jsonl"
        if args.tensor_board_filename
        else None,
        # TB event files too: the reference treats the flag as
        # SummaryWriter's logdir (dlrm_s_pytorch.py:1509-1510)
        tb_dir=args.tensor_board_filename or None,
    )
    evaluates = (train_cfg.test_freq > 0 or train_cfg.inference_only
                 or train_cfg.mlperf_logging)
    trainer = Trainer(
        model, train_cfg, train_data, test_data if evaluates else None,
        scalar_log=scalar_log, mlperf=mlperf, device=dev,
    )
    state = trainer.init_state()
    if args.debug_mode:
        print("initial parameters (weights and bias):")
        dump_parameters(state.params, args.print_precision)
    with profile(args.enable_profiling,
                 args.tensor_board_filename or "dlrm_profile"):
        state = trainer.train(state)
    if args.debug_mode:
        print("updated parameters (weights and bias):")
        dump_parameters(state.params, args.print_precision)
    scalar_log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
