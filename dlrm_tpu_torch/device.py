"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes device="cpu" (as the
CPU tests do). Asking for CUDA where there is none raises: there is no
silent CPU fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def process_count() -> int:
    """Processes in this run: torch.distributed's world size once a process
    group exists, else what the launcher environment says (the JAX
    package's DLRM_NUM_PROCESSES, or torchrun's WORLD_SIZE), else 1."""
    import os

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    for var in ("DLRM_NUM_PROCESSES", "WORLD_SIZE"):
        if os.environ.get(var):
            return int(os.environ[var])
    return 1
