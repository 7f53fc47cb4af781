"""Sum-pooled multi-hot embedding lookups (the port of dlrm_tpu/ops/
embedding.py's embedding_bag, fused_embedding_bag, qr_embedding_bag,
flat_hit_offsets and grouped_embedding_bag).

All equal-width tables live in one stacked [rows, d] array; per-table row
offsets are added to the table-local indices, and every bag of every table
is pooled by ONE F.embedding_bag call. That is an ATen op: the JAX package
leaves this gather to XLA, so the port has no hand kernel here. The sum is
taken in fp32 and the result comes back in the TABLE's dtype (bf16 tables
give bf16 pooled vectors), as in dlrm_tpu/ops/embedding.py:72-77. With
weights, embedding_bag multiplies row by weight in fp32 where the JAX package
rounds each product to the table dtype first: the same sums in fp32, at most
one bf16 rounding apart in bf16. Under autograd, F.embedding_bag gives the
table its dense gradient and the weights theirs (mode="sum"), which is how
learned pooling weights train.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

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
def flat_layout(hot_sizes: tuple, batch: int, device: torch.device):
    """For the flat layout of (hot_sizes, batch) on `device`: the table of
    every hit, the start of every bag (table-major), and every hit's row in
    the [B*T, d] view of the pooled [B, T, d] output (b*T + t). Built once
    per layout: a copy from pageable host memory on every call would wait
    on the card."""
    hot = torch.tensor(hot_sizes, dtype=torch.int64)
    t = len(hot_sizes)
    tid = torch.repeat_interleave(torch.arange(t), hot * batch)
    bag_len = torch.repeat_interleave(hot, batch)
    bag_off = torch.cumsum(bag_len, 0) - bag_len
    smp = torch.repeat_interleave(
        torch.arange(batch).repeat(t), bag_len)  # each hit's sample
    pooled_row = (smp * t + tid).int()
    return tid.to(device), bag_off.to(device), pooled_row.to(device)


def to_flat(
    idx: torch.Tensor,  # [T, B, Hmax] padded OR [sum_t B*h_t] flat
    wt: Optional[torch.Tensor],  # same layout as idx, or None
    hot_sizes: Sequence[int],
    batch: Optional[int] = None,  # required for the flat layout
) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """(idx, wt, batch) in the flat per-hit layout: table t keeps the
    first hot_sizes[t] columns of the padded layout, table-major; a flat
    layout is checked against hot_sizes and passed through."""
    if idx.dim() == 1:
        if batch is None:
            raise ValueError("flat per-hit idx needs the batch size")
        _, total = flat_hit_offsets(hot_sizes, batch)
        if idx.shape[0] != total:
            raise ValueError(
                f"flat idx has {idx.shape[0]} hits, layout expects {total}"
            )
        return idx, wt, int(batch)
    b = idx.shape[1]
    if len(set(int(h) for h in hot_sizes)) == 1 and int(
            hot_sizes[0]) == idx.shape[2]:  # every column: no copy
        return (idx.reshape(-1), None if wt is None else wt.reshape(-1), b)
    flat_idx = torch.cat(
        [idx[t, :, : int(h)].reshape(-1) for t, h in enumerate(hot_sizes)]
    )
    flat_wt = None if wt is None else torch.cat(
        [wt[t, :, : int(h)].reshape(-1) for t, h in enumerate(hot_sizes)]
    )
    return flat_idx, flat_wt, b


def flat_rows(row_offsets: torch.Tensor, idx: torch.Tensor,
              hot_sizes: Sequence[int], batch: int) -> torch.Tensor:
    """Each flat hit's row in the stacked table: idx + its table's offset."""
    tid = flat_layout(tuple(int(h) for h in hot_sizes), int(batch),
                      idx.device)[0]
    return idx + row_offsets.to(idx.dtype)[tid]


def pool_flat_rows(stacked: torch.Tensor, rows: torch.Tensor,
                   wt: Optional[torch.Tensor], hot_sizes: Sequence[int],
                   batch: int) -> torch.Tensor:
    """Flat hits already offset to stacked rows -> pooled [B, T, d]."""
    bag_off = flat_layout(tuple(int(h) for h in hot_sizes), int(batch),
                          rows.device)[1]
    pooled = F.embedding_bag(
        rows, stacked, bag_off.to(rows.dtype), mode="sum",
        per_sample_weights=None if wt is None else wt.to(stacked.dtype),
    )  # [T*B, d], fp32 sums, table dtype out
    return pooled.reshape(len(hot_sizes), batch, -1).transpose(0, 1)


def embedding_bag(
    table: torch.Tensor,  # [n, d]
    idx: torch.Tensor,  # [B, H] int
    wt: Optional[torch.Tensor] = None,  # [B, H] float32, 0 = padding
) -> torch.Tensor:  # [B, d]
    """Sum-pooled lookup on a single table (EmbeddingBag mode='sum')."""
    return F.embedding_bag(
        idx, table, mode="sum",
        per_sample_weights=None if wt is None else wt.to(table.dtype),
    )


def qr_embedding_bag(
    q_table: torch.Tensor,  # [ceil(n / c), m]
    r_table: torch.Tensor,  # [c, m]
    collisions: int,
    operation: str,
    idx: torch.Tensor,  # [B, H] int
    wt: Optional[torch.Tensor] = None,  # [B, H]
) -> torch.Tensor:
    """Quotient-remainder lookup (tricks/qr_embedding_bag.py:192-226):
    index -> index // c into the quotient table and index % c into the
    remainder table; each bag is pooled in both tables first and the two
    pooled vectors are then combined by mult, add or concat (for mult that
    is not the sum of per-index products), as the reference does."""
    vq = embedding_bag(q_table, torch.div(idx, collisions,
                                          rounding_mode="floor"), wt)
    vr = embedding_bag(r_table, torch.remainder(idx, collisions), wt)
    if operation == "mult":
        return vq * vr
    if operation == "add":
        return vq + vr
    if operation == "concat":
        return torch.cat([vq, vr], dim=1)
    raise ValueError(f"qr operation {operation!r} not supported")


def fused_embedding_bag(
    stacked: torch.Tensor,  # [sum_n, d]
    row_offsets: torch.Tensor,  # [T] int
    idx: torch.Tensor,  # [T, B, H] int32 (per-table local indices)
    wt: Optional[torch.Tensor] = None,  # [T, B, H] float32
) -> torch.Tensor:  # [B, T, d]
    """Sum-pooled lookup over ALL tables at once, every bag H long."""
    t, _, h = idx.shape
    return grouped_embedding_bag(stacked, row_offsets, idx, wt, (h,) * t)


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
    idx, wt, b = to_flat(idx, wt, hot_sizes, batch)
    rows = flat_rows(row_offsets, idx, hot_sizes, b)
    return pool_flat_rows(stacked, rows, wt, hot_sizes, b)
