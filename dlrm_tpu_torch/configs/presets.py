"""Named config presets matching the reference's published run configurations
(the port's copy of dlrm_tpu/configs/presets.py).

Sources:
  * kaggle    — bench/dlrm_s_criteo_kaggle.sh:24
  * terabyte  — bench/dlrm_s_criteo_terabyte.sh:24 (0.875-subsample 64-dim run)
  * mlperf_v1 — bench/run_and_time.sh:17 (MLPerf v0.7, 128-dim, AUC 0.8025)
  * dlrm_v2 / dlrm_v2_dcn — torchrec_dlrm/README.MD:155-230 and
    dlrm_main.py:75-311 defaults (26 multi-hot features, 128-dim)
  * bench_sweep — bench/dlrm_s_benchmark.sh:20-45 (8x1M-row 64-dim tables)
"""

from __future__ import annotations

from typing import Tuple

from dlrm_tpu_torch.config import DCNConfig, DLRMConfig, TrainConfig

# Criteo 1TB per-feature row counts (capped at 40M, the MLPerf convention;
# torchrec_dlrm/README.MD:157 --num_embeddings_per_feature)
CRITEO_1TB_COUNTS: Tuple[int, ...] = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
    40000000, 40000000, 590152, 12973, 108, 36,
)
# DLRM-v2 synthetic multi-hot bag sizes (torchrec_dlrm/README.MD:159)
MULTI_HOT_SIZES: Tuple[int, ...] = (
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
    100, 27, 10, 3, 1, 1,
)
# Criteo Kaggle DAC per-feature counts (from the published processed dataset)
CRITEO_KAGGLE_COUNTS: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
)


def kaggle(table_sizes=CRITEO_KAGGLE_COUNTS) -> Tuple[DLRMConfig, TrainConfig]:
    model = DLRMConfig(
        embedding_dim=16,
        table_sizes=tuple(table_sizes),
        mlp_bot=(13, 512, 256, 64, 16),
        mlp_top=(512, 256, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=1,
    )
    train = TrainConfig(
        mini_batch_size=128,
        test_mini_batch_size=16384,
        learning_rate=0.1,
        round_targets=True,
        print_freq=1024,
        print_time=True,
        mlperf_acc_threshold=0.789,
    )
    return model, train


def terabyte(max_ind_range=10_000_000) -> Tuple[DLRMConfig, TrainConfig]:
    sizes = tuple(min(n, max_ind_range) for n in CRITEO_1TB_COUNTS)
    model = DLRMConfig(
        embedding_dim=64,
        table_sizes=sizes,
        mlp_bot=(13, 512, 256, 64),
        mlp_top=(512, 512, 256, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=1,
    )
    train = TrainConfig(
        mini_batch_size=2048,
        test_mini_batch_size=16384,
        learning_rate=0.1,
        round_targets=True,
        print_freq=1024,
        print_time=True,
        mlperf_acc_threshold=0.8107,
    )
    return model, train


def mlperf_v1(max_ind_range=40_000_000) -> Tuple[DLRMConfig, TrainConfig]:
    sizes = tuple(min(n, max_ind_range) for n in CRITEO_1TB_COUNTS)
    model = DLRMConfig(
        embedding_dim=128,
        table_sizes=sizes,
        mlp_bot=(13, 512, 256, 128),
        mlp_top=(1024, 1024, 512, 256, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=1,
    )
    train = TrainConfig(
        mini_batch_size=2048,
        test_mini_batch_size=16384,
        learning_rate=1.0,
        round_targets=True,
        print_freq=2048,
        test_freq=102400,
        print_time=True,
        mlperf_logging=True,
        mlperf_auc_threshold=0.8025,
    )
    return model, train


def dlrm_v2(
    interaction: str = "dot",
    local_batch: int = 2048,
    adagrad: bool = True,
) -> Tuple[DLRMConfig, TrainConfig]:
    """torchrec DLRM-v2 multi-hot config (README.MD:35-53 table rows).

    The learning rates are tied to the cited GLOBAL batch sizes:
    adagrad -> lr 0.006 @ global 16384 (README.MD:51-53, local 2048 x 8);
    sgd -> lr 1.0 @ global 2048 (README.MD:48-50, local 256 x 8). Scale lr
    if you change the global batch (e.g. 0.004 @ 65536, README.MD:196)."""
    model = DLRMConfig(
        embedding_dim=128,
        table_sizes=CRITEO_1TB_COUNTS,
        mlp_bot=(13, 512, 256, 128),
        mlp_top=(1024, 1024, 512, 256, 1),
        interaction=interaction,
        dcn=DCNConfig(num_layers=3, low_rank_dim=512)
        if interaction == "dcn"
        else None,
        loss="bce",
        num_indices_per_lookup=max(MULTI_HOT_SIZES),
        compute_dtype="bfloat16",
    )
    train = TrainConfig(
        mini_batch_size=local_batch,
        learning_rate=0.006 if adagrad else 1.0,
        optimizer="rwsadagrad" if adagrad else "sgd",
        mlperf_auc_threshold=0.8030,
        mlperf_logging=True,
    )
    return model, train


def bench_sweep() -> Tuple[DLRMConfig, TrainConfig]:
    """bench/dlrm_s_benchmark.sh:20-45 shape: 8 x 1M-row 64-dim tables,
    100 indices per lookup, mb 2048."""
    model = DLRMConfig(
        embedding_dim=64,
        table_sizes=(1_000_000,) * 8,
        mlp_bot=(512, 512, 64),
        mlp_top=(1024, 1024, 1024, 1),
        interaction="dot",
        loss="mse",
        num_indices_per_lookup=100,
    )
    train = TrainConfig(
        mini_batch_size=2048,
        num_batches=100,
        num_indices_per_lookup_fixed=True,
        print_freq=10,
        print_time=True,
    )
    return model, train


PRESETS = {
    "kaggle": kaggle,
    "terabyte": terabyte,
    "mlperf_v1": mlperf_v1,
    "dlrm_v2": dlrm_v2,
    "dlrm_v2_dcn": lambda: dlrm_v2(interaction="dcn"),
    "bench_sweep": bench_sweep,
}
