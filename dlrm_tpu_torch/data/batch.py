"""Device batch layout (the port of dlrm_tpu/data/batch.py).

    dense:  float32[B, D]
    idx:    int32[T, B, H] padded multi-hot indices, or int32[sum_t B*h_t]
            in the flat per-hit layout (table-major)
    wt:     float32, same layout as idx; 0 marks padding (None => every real
            hit weighs 1.0)
    labels: float32[B, 1]; a label < 0 marks a pad row
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class StreamArrays(NamedTuple):
    """Device copies of the host-built U-layout work plan
    (dlrm_tpu_torch/ops/stream_plan.py) consumed by the streamed update."""

    rows_u: torch.Tensor  # [Uw, 8, 128] int32
    vals_u: torch.Tensor  # [Uw, 8, 128] int32
    wts_u: Optional[torch.Tensor]  # [Uw, 8, 128] float32 (None: unit weights)
    w2t: torch.Tensor  # [Uw] int32
    item_block: torch.Tensor  # [M] int32
    item_row0: torch.Tensor  # [M] int32
    item_u: torch.Tensor  # [M] int32


class Batch(NamedTuple):
    dense: torch.Tensor
    idx: torch.Tensor
    wt: Optional[torch.Tensor]
    labels: Optional[torch.Tensor]
    stream: Optional[StreamArrays] = None
