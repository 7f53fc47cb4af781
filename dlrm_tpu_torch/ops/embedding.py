"""Sum-pooled multi-hot embedding lookups (the port of dlrm_tpu/ops/
embedding.py's fused_embedding_bag, flat_hit_offsets and
grouped_embedding_bag).

All equal-width tables live in one stacked [rows, d] array; per-table row
offsets are added to the table-local indices, and every bag of every table
is pooled by ONE F.embedding_bag call. That is an ATen op: the JAX package
leaves this gather to XLA, so the port has no hand kernel here. The sum is
taken in fp32 and the result comes back in the TABLE's dtype (bf16 tables
give bf16 pooled vectors), as in dlrm_tpu/ops/embedding.py:72-77. With
weights, embedding_bag multiplies row by weight in fp32 where the JAX package
rounds each product to the table dtype first: the same sums in fp32, at most
one bf16 rounding apart in bf16.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def flat_hit_offsets(hot_sizes: Sequence[int], batch: int):
    """Per-table start offsets into the flat per-hit layout (table-major
    blocks of batch*hot_sizes[t] hits each), and the total hit count."""
    offs, acc = [], 0
    for h in hot_sizes:
        offs.append(acc)
        acc += batch * int(h)
    return offs, acc


@functools.lru_cache(maxsize=16)
def _flat_layout(hot_sizes: tuple, batch: int, device: torch.device):
    """(table id of every flat hit, start of every bag) on `device`, built
    once per layout: a copy from pageable host memory on every call would
    wait on the card."""
    hot = torch.tensor(hot_sizes, dtype=torch.int64)
    tid = torch.repeat_interleave(torch.arange(len(hot_sizes)), hot * batch)
    bag_len = torch.repeat_interleave(hot, batch)
    bag_off = torch.cumsum(bag_len, 0) - bag_len
    return tid.to(device), bag_off.to(device)


def _pool_flat(stacked, row_offsets, idx, wt, hot_sizes, batch):
    """idx/wt: [sum_t B*h_t] table-major flat hits -> [B, T, d]."""
    tid, bag_off = _flat_layout(tuple(int(h) for h in hot_sizes), int(batch),
                                idx.device)
    rows = idx + row_offsets.to(idx.dtype)[tid]
    pooled = F.embedding_bag(
        rows, stacked, bag_off.to(idx.dtype), mode="sum",
        per_sample_weights=None if wt is None else wt.to(stacked.dtype),
    )  # [T*B, d], fp32 sums, table dtype out
    return pooled.reshape(len(hot_sizes), batch, -1).transpose(0, 1)


def fused_embedding_bag(
    stacked: torch.Tensor,  # [sum_n, d]
    row_offsets: torch.Tensor,  # [T] int
    idx: torch.Tensor,  # [T, B, H] int32 (per-table local indices)
    wt: Optional[torch.Tensor] = None,  # [T, B, H] float32
) -> torch.Tensor:  # [B, T, d]
    """Sum-pooled lookup over ALL tables at once, every bag H long."""
    t, b, h = idx.shape
    return _pool_flat(
        stacked, row_offsets, idx.reshape(-1),
        None if wt is None else wt.reshape(-1), (h,) * t, b,
    )


def grouped_embedding_bag(
    stacked: torch.Tensor,  # [sum_n, d]
    row_offsets: torch.Tensor,  # [T] int
    idx: torch.Tensor,  # [T, B, Hmax] padded multi-hot OR [N] flat per-hit
    wt: Optional[torch.Tensor],  # same layout as idx, or None
    hot_sizes: Sequence[int],  # per-table real hot size
    batch: Optional[int] = None,  # required for the flat layout
) -> torch.Tensor:  # [B, T, d]
    """Ragged multi-hot lookup: table t pools only its first hot_sizes[t]
    columns (padded layout) or its B*hot_sizes[t] flat hits. Either layout
    becomes the flat one and is pooled in one call."""
    if idx.dim() == 1:
        if batch is None:
            raise ValueError("flat per-hit idx needs the batch size")
        _, total = flat_hit_offsets(hot_sizes, batch)
        if idx.shape[0] != total:
            raise ValueError(
                f"flat idx has {idx.shape[0]} hits, layout expects {total}"
            )
        return _pool_flat(stacked, row_offsets, idx, wt, hot_sizes, batch)
    b = idx.shape[1]
    flat_idx = torch.cat(
        [idx[t, :, : int(h)].reshape(-1) for t, h in enumerate(hot_sizes)]
    )
    flat_wt = None if wt is None else torch.cat(
        [wt[t, :, : int(h)].reshape(-1) for t, h in enumerate(hot_sizes)]
    )
    return _pool_flat(stacked, row_offsets, flat_idx, flat_wt, hot_sizes, b)
