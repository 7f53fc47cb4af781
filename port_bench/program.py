"""The one place the harness reaches into the program (dlrm_tpu_torch):
the model a configuration describes, and the host batch it is fed. The
drivers take the step, the prefetcher and the forward from here too, so
what the benchmark calls is listed in one file."""

from __future__ import annotations

import numpy as np

from dlrm_tpu_torch.config import DCNConfig, DLRMConfig
from dlrm_tpu_torch.data.random_data import HostBatch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
from dlrm_tpu_torch.train.stream_step import (
    init_stream_opt_state,
    make_stream_train_step,
    plan_for_model,
)
from dlrm_tpu_torch.utils import profiling

__all__ = ["DevicePrefetcher", "HostBatch", "host_batch",
           "init_stream_opt_state", "make_stream_train_step", "model",
           "plan_for_model", "profiling"]


def model(m: dict) -> DLRMModel:
    """The DLRM-v2 DCN model of a configuration's "model" entry."""
    return DLRMModel(DLRMConfig(
        embedding_dim=m["embedding_dim"],
        table_sizes=tuple(m["table_sizes"]),
        mlp_bot=tuple(m["mlp_bot"]),
        mlp_top=tuple(m["mlp_top"]),
        interaction="dcn",
        dcn=DCNConfig(num_layers=m["dcn_num_layers"],
                      low_rank_dim=m["dcn_low_rank_dim"]),
        loss=m["loss"],
        num_indices_per_lookup=max(m["hot_sizes"]),
        compute_dtype=m["compute_dtype"],
    ))


def host_batch(raw: dict) -> HostBatch:
    """A generator's batch as the program's host batch: the flat
    [B, sum(hot)] layout, unit weights."""
    return HostBatch(dense=raw["dense"], idx=raw["idx"], wt=None,
                     labels=raw["labels"].astype(np.float32))
