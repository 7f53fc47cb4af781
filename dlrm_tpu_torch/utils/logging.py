"""Observability: scalar logging and the MLPerf event log (the port of
dlrm_tpu/utils/logging.py).

ScalarLogger writes TensorBoard-style scalars as JSONL (one {"tag", "step",
"value"} per line) and, given a directory, real TensorBoard event files
through the port's own writer (utils/tfevents.py), in place of the
reference's SummaryWriter (dlrm_s_pytorch.py:1509-1510, 1668). MLPerfLogger
prints mlperf_logger.py's events (:25-113) as `:::MLLOG <json>` lines with
the same event keys, on rank 0 only.
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings
from typing import Optional


class ScalarLogger:
    """JSONL scalar writer, plus TensorBoard event files in `tb_dir`. An
    unwritable `tb_dir` degrades to the JSONL alone with a warning instead
    of failing the run. The JSONL is what the tests read."""

    def __init__(self, path: Optional[str] = None,
                 tb_dir: Optional[str] = None):
        self.path = path
        self._f = None
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        if tb_dir:
            from dlrm_tpu_torch.utils import tfevents

            try:
                self._tb = tfevents.TFEventsWriter(tb_dir)
            except OSError as e:
                warnings.warn(
                    f"cannot write TensorBoard events to {tb_dir!r} ({e}); "
                    "continuing with JSONL scalars only"
                )
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is not None:
            self._f.write(
                json.dumps(
                    {"tag": tag, "step": int(step), "value": float(value)}
                )
                + "\n"
            )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self._f:
            self._f.flush()
        if self._tb:
            self._tb.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
        if self._tb:
            self._tb.close()
            self._tb = None


# MLPerf event keys (mlperf_logger.py usage in dlrm_s_pytorch.py:1036-1040,
# 1097-1102, 1389-1396, 1487-1507, 1520-1533, 1676-1683, 1717-1724)
INIT_START = "init_start"
INIT_STOP = "init_stop"
RUN_START = "run_start"
RUN_STOP = "run_stop"
EPOCH_START = "epoch_start"
EPOCH_STOP = "epoch_stop"
BLOCK_START = "block_start"
BLOCK_STOP = "block_stop"
EVAL_START = "eval_start"
EVAL_STOP = "eval_stop"
EVAL_ACCURACY = "eval_accuracy"
CACHE_CLEAR = "cache_clear"
SEED = "seed"
GLOBAL_BATCH_SIZE = "global_batch_size"
OPT_BASE_LR = "opt_base_learning_rate"
OPT_LR_WARMUP_STEPS = "opt_learning_rate_warmup_steps"


def process_rank() -> int:
    """torch.distributed's rank where a process group exists, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MLPerfLogger:
    """Structured event logger in the mlperf_logging line format
    (:::MLLOG <json>), gated to rank 0 like mlperf_logger._log_print
    (:40-53)."""

    def __init__(self, enabled: bool = False, stream=None,
                 rank: Optional[int] = None):
        if rank is None:
            rank = process_rank()
        self.enabled = enabled and rank == 0
        self.stream = stream or sys.stdout

    def _emit(self, event_type: str, key: str, value=None, metadata=None):
        if not self.enabled:
            return
        rec = {
            "namespace": "",
            "time_ms": int(time.time() * 1000),
            "event_type": event_type,
            "key": key,
            "value": value,
            "metadata": metadata or {},
        }
        print(":::MLLOG " + json.dumps(rec), file=self.stream)

    def start(self, key: str, value=None, metadata=None):
        self._emit("INTERVAL_START", key, value, metadata)

    def end(self, key: str, value=None, metadata=None):
        self._emit("INTERVAL_END", key, value, metadata)

    def event(self, key: str, value=None, metadata=None):
        self._emit("POINT_IN_TIME", key, value, metadata)

    def submission(self, benchmark: str = "dlrm", platform: str = "tpu") -> None:
        """Submission metadata block (mlperf_logger.py:88-113). The platform
        value stays the JAX package's, so the two event logs are equal apart
        from their time stamps."""
        for k, v in {
            "submission_benchmark": benchmark,
            "submission_division": "closed",
            "submission_org": "reference",
            "submission_platform": platform,
            "submission_status": "onprem",
        }.items():
            self.event(k, v)
