"""Sparse embedding updates that touch only the rows a batch hit (the port of
dlrm_tpu/ops/sparse_update.py; FBGEMM's fused EXACT_* optimizers, which
torchrec applies in the backward, torchrec_dlrm/dlrm_main.py:649-653).

  1. sort the hits' global rows (torch.sort, stable: each row's hits stay
     in hit order);
  2. EXACT duplicate coalescing: one gradient row per touched table row,
     each row's hits summed in that order (Adagrad's accumulator update is
     nonlinear, so duplicate hits must be summed before squaring,
     optim/rwsadagrad.py:117-120);
  3. one update per state array on the unique rows only.

As in the JAX package, every shape is static: all N hit slots are kept,
and the slots past the last touched row get distinct rows past the table
(total_rows + slot) that every update skips. So the card never needs the
unique count on the host: nothing here calls unique, nonzero or item().

The kernels (csrc/*.cu, built and launched as K1-K4 are):
  coalesce_rows     step 2 and the gather and weighting of each hit's
                    cotangent row, in a fixed order (csrc/coalesce_rows.cu):
                    a run of up to COALESCE_CHUNK hits in slot order (the
                    bits of the JAX package's segment_sum on the CPU), a
                    longer run as slot-order chunks of COALESCE_CHUNK hits
                    added in chunk order. A port-side kernel with no TPU
                    counterpart: the JAX package leaves the sum to XLA's
                    segment_sum. On the card index_add_'s atomics would add
                    in another order on every run.
  row_scatter_add_  the table update, table[urows] += delta on unique rows,
                    skipping rows outside the table
                    (ops/probe_kernels.py, csrc/probe_rows.cu; the port of
                    bench_scripts/pallas_probe.py's pallas_scatter_add).
The accumulators ([rows] for rwsadagrad, [rows, d] for adagrad) are
updated and read with ATen index_add_ / index_select, each invalid slot
sent to a row inside the table (slot mod rows) and weighted 0: adding +0
to an accumulator (>= 0) leaves it unchanged in any order, and spreading
the slots keeps index_add_'s atomics off any one row.

Tables and accumulators are updated IN PLACE (the JAX step donates them)
and returned.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dlrm_tpu_torch.ops.embedding import flat_layout, flat_rows, to_flat
from dlrm_tpu_torch.ops.probe_kernels import row_scatter_add_
from dlrm_tpu_torch.ops.stream_kernels import (
    _add_in_rounds,
    _check,
    _check_rows4,
    _device,
    _launch,
    kernel_library,
    register_kernels,
)
from dlrm_tpu_torch.optim.optimizers import ADAGRAD_EPS

SOURCES = ("coalesce_rows",)
_P = ctypes.c_void_p
register_kernels({
    "coalesce_rows": ("coalesce_rows", "coalesce_rows", [
        _P, _P, _P, _P, _P,  # r_s, seg, bag_s, w_s (or null), dly
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64,  # n, d, total_rows
        _P, _P, _P, _P,  # G, urows, scratch: start, partials
        _P,  # stream
    ]),
})
_I32 = (torch.int32,)
_F32 = (torch.float32,)
MAX_ROW_WIDTH = 512  # coalesce_rows holds a row in registers
# C: coalesce_rows sums a run of more than C hits as chunks of C in slot
# order, then the chunks' sums in chunk order (kChunk in the kernel source)
COALESCE_CHUNK = 512


# ------------------------------------------------------------ the kernel
def coalesce_rows_plain(r_s, seg, bag_s, w_s, dly, total_rows):
    """coalesce_rows' contract in plain PyTorch: each run's weighted rows
    cut into chunks of COALESCE_CHUNK slots from its head, each chunk
    summed from zero in slot order, then each run's chunk sums added from
    zero in chunk order (_add_in_rounds twice: the same bits on every run
    and device; a run of one chunk keeps its slot-order bits, since 0 + x
    is x for a sum that starts from +0). The slots past the last run are
    zero and given rows past the table. It reads counts back to the
    host."""
    n = r_s.numel()
    g = dly[bag_s.long()]
    if w_s is not None:
        g = g * w_s[:, None]
    slot = torch.arange(n, device=r_s.device)
    head = torch.ones((n,), dtype=torch.bool, device=r_s.device)
    head[1:] = r_s[1:] != r_s[:-1]
    run_start = torch.cummax(torch.where(head, slot, 0), 0).values
    chunk_head = (slot - run_start) % COALESCE_CHUNK == 0
    chunk = torch.cumsum(chunk_head, 0) - 1
    P = torch.zeros((int(chunk[-1]) + 1 if n else 0, dly.shape[1]),
                    dtype=torch.float32, device=dly.device)
    _add_in_rounds(P, chunk, g)
    G = torch.zeros((n, dly.shape[1]), dtype=torch.float32,
                    device=dly.device)
    _add_in_rounds(G, seg.long()[chunk_head], P)
    urows = (total_rows + slot).int()
    urows[seg.long()] = r_s
    return G, urows


@functools.lru_cache(maxsize=None)
def _kernel_chunk() -> int:
    """The kernel's C, checked once against COALESCE_CHUNK."""
    c = kernel_library("coalesce_rows").coalesce_chunk()
    if c != COALESCE_CHUNK:
        raise RuntimeError(f"csrc/coalesce_rows.cu sums chunks of {c} hits, "
                           f"sparse_update.COALESCE_CHUNK is {COALESCE_CHUNK}")
    return c


def coalesce_rows(
    r_s: torch.Tensor,  # [n] int32 rows, sorted ascending
    seg: torch.Tensor,  # [n] int32 run index of every slot (from 0)
    bag_s: torch.Tensor,  # [n] int32 row of dly each hit reads
    w_s: Optional[torch.Tensor],  # [n] f32 hit weight, None: every 1
    dly: torch.Tensor,  # [rows_dly, d] f32 contiguous
    total_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:  # G [n, d] f32, urows [n] int32
    """G[seg[k]] = sum of dly[bag_s[j]] * w_s[j] over the run of r_s[k]'s
    row: in slot order for a run of up to COALESCE_CHUNK hits, else the
    slot-order sums of its chunks of COALESCE_CHUNK hits added in chunk
    order; urows[seg[k]] = r_s[k]; the slots past the last run are zero
    with urows = total_rows + slot."""
    n = r_s.numel()
    for name, t in (("r_s", r_s), ("seg", seg), ("bag_s", bag_s)):
        _check(name, t, _I32, shape=(n,))
    if w_s is not None:
        _check("w_s", w_s, _F32, shape=(n,))
    _check("dly", dly, _F32)
    if dly.dim() != 2:
        raise ValueError(f"dly must be 2-D, got shape {tuple(dly.shape)}")
    d = dly.shape[1]
    if total_rows < 0 or total_rows + n >= 2**31:
        raise ValueError(f"rows past the table overflow int32 "
                         f"({total_rows} + {n})")
    dev = _device("coalesce_rows", r_s, seg, bag_s, w_s, dly)
    if dev.type == "cpu":
        return coalesce_rows_plain(r_s, seg, bag_s, w_s, dly, total_rows)
    if d % 4:
        # the kernel moves rows as float4: a row of any other width runs
        # zero-padded to the next multiple of 4 (every column is summed on
        # its own, so the first d columns keep their bits)
        G, urows = coalesce_rows(
            r_s, seg, bag_s, w_s,
            F.pad(dly, (0, -d % 4)).contiguous(), total_rows)
        return G[:, :d].contiguous(), urows
    _check_rows4("dly", dly)
    if d > MAX_ROW_WIDTH:
        raise ValueError(f"coalesce_rows holds a row in registers: d = {d} "
                         f"> {MAX_ROW_WIDTH}")
    G = torch.empty((n, d), dtype=torch.float32, device=dev)
    urows = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        c = _kernel_chunk()
        # scratch: each run's first slot, and the chunk sums of the runs
        # longer than C (two rows for each window of C slots)
        start = torch.empty((n,), dtype=torch.int32, device=dev)
        P = torch.empty((2 * -(-n // c), d), dtype=torch.float32, device=dev)
        _launch("coalesce_rows", dev, r_s.data_ptr(), seg.data_ptr(),
                bag_s.data_ptr(), 0 if w_s is None else w_s.data_ptr(),
                dly.data_ptr(), n, d, int(total_rows), G.data_ptr(),
                urows.data_ptr(), start.data_ptr(), P.data_ptr())
    return G, urows


# ---------------------------------------------------------- coalescing
def sorted_hits(rows, bag, wt):
    """coalesce_rows' inputs from the hits in hit order: (r_s, seg, bag_s,
    w_s), the rows sorted stably with each hit's run index, bag row and
    weight in the same order."""
    n = rows.numel()
    r_s, order = torch.sort(rows.int(), stable=True)
    head = torch.ones((n,), dtype=torch.int32, device=rows.device)
    if n > 1:
        head[1:] = (r_s[1:] != r_s[:-1]).int()
    seg = torch.cumsum(head, 0, dtype=torch.int32) - 1
    bag_s = bag[order].int()
    w_s = None if wt is None else wt[order].float().contiguous()
    return r_s, seg, bag_s, w_s


def _coalesce_sorted(rows, bag, wt, dly, total_rows):
    """Sort the hits' rows, then coalesce_rows: (urows, G, valid)."""
    r_s, seg, bag_s, w_s = sorted_hits(rows, bag, wt)
    G, urows = coalesce_rows(r_s, seg, bag_s, w_s,
                             dly.float().contiguous(), total_rows)
    slot = torch.arange(rows.numel(), device=rows.device)
    return urows, G, slot < (seg[-1:] + 1)


def hit_rows(idx, wt, row_offsets, batch, hot_sizes):
    """(global row, dly row, weight) of every hit, flat: coalesce_hits'
    view of a batch in either layout."""
    hot_sizes = tuple(int(h) for h in hot_sizes)
    idx, wt, b = to_flat(idx, wt, hot_sizes, batch)
    rows = flat_rows(row_offsets, idx, hot_sizes, b)
    return rows, flat_layout(hot_sizes, b, idx.device)[2], wt


def per_hit_gradients(
    dpooled: torch.Tensor,  # [B, T, d] cotangent of the pooled embeddings
    idx: torch.Tensor,  # [T, B, H] table-local row indices
    wt: Optional[torch.Tensor],  # [T, B, H] or None (pure sum pooling)
    row_offsets: torch.Tensor,  # [T] table start rows in the stacked array
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [N], grads [N, d] fp32): every hit's global row and its
    gradient row, dpooled of its bag times its weight."""
    t, b, h = idx.shape
    d = dpooled.shape[-1]
    rows = (idx + row_offsets.to(idx.dtype)[:, None, None]).reshape(-1)
    g = dpooled.transpose(0, 1)[:, :, None, :].expand(t, b, h, d)
    if wt is not None:
        g = g * wt[..., None].to(g.dtype)
    return rows, g.reshape(-1, d).float()


def coalesce_hits(
    dpooled: torch.Tensor,  # [B, T, d]
    idx: torch.Tensor,  # [T, B, H] padded OR [sum_t B*h_t] flat per-hit
    wt: Optional[torch.Tensor],  # same layout as idx, or None
    row_offsets: torch.Tensor,  # [T] int
    total_rows: int,
    hot_sizes: Optional[Sequence[int]] = None,  # needed for the flat layout
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(urows [N] int32, coalesced grads G [N, d] fp32, valid [N] bool):
    the touched rows ascending, then distinct rows past the table. The
    padded layout takes every column of every table (the JAX package's
    coalesce_hits) unless hot_sizes names the real ones; its padding
    weighs 0 and changes no sum."""
    b, t = dpooled.shape[0], dpooled.shape[1]
    if hot_sizes is None:
        if idx.dim() != 3:
            raise ValueError("the flat per-hit layout needs hot_sizes")
        hot_sizes = (idx.shape[2],) * t
    rows, bag, wt = hit_rows(idx, wt, row_offsets, b, hot_sizes)
    return _coalesce_sorted(rows, bag, wt, dpooled.reshape(b * t, -1),
                            total_rows)


def coalesce(rows: torch.Tensor, grads: torch.Tensor, total_rows: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coalesce materialized (rows [N], grads [N, d]): the legacy API."""
    bag = torch.arange(rows.numel(), dtype=torch.int32, device=rows.device)
    return _coalesce_sorted(rows, bag, None, grads, total_rows)


# ------------------------------------------------------------ appliers
# All take the COALESCED (urows, G, valid) triple of coalesce_hits/coalesce.


def _in_table(urows: torch.Tensor, valid: torch.Tensor,
              rows: int) -> torch.Tensor:
    """urows with each slot past the table sent to row (slot mod rows);
    its terms are weighted 0."""
    slot = torch.arange(urows.numel(), device=urows.device)
    return torch.where(valid, urows.long(), slot % rows)


def sgd_from_coalesced(table, urows, G, valid, lr):
    delta = (-lr * G) * valid[:, None]
    return row_scatter_add_(table, urows, delta.contiguous())


def rowwise_adagrad_from_coalesced(table, accum, urows, G, valid, lr,
                                   eps: float = ADAGRAD_EPS, row_sq=None):
    """Exact RWSAdagrad row update (optim/rwsadagrad.py:117-143):
    acc_r += mean(G_r^2); row -= lr * G_r / (sqrt(acc_r) + eps). row_sq
    overrides the per-row mean(G^2) (the JAX package's column-wise
    sharded tables)."""
    m = (row_sq if row_sq is not None else (G * G).mean(dim=1)) * valid
    rows = _in_table(urows, valid, accum.shape[0])
    accum.index_add_(0, rows, m)
    denom = torch.sqrt(accum.index_select(0, rows)) + eps
    delta = ((-lr * G) / denom[:, None]) * valid[:, None]
    row_scatter_add_(table, urows, delta.contiguous())
    return table, accum


def adagrad_from_coalesced(table, accum, urows, G, valid, lr,
                           eps: float = ADAGRAD_EPS):
    """Element-wise Adagrad restricted to the touched rows (torch.optim.
    Adagrad's sparse semantics: coalesce, then sum += G^2;
    p -= lr*G/(sqrt(sum)+eps))."""
    rows = _in_table(urows, valid, accum.shape[0])
    accum.index_add_(0, rows, (G * G) * valid[:, None])
    denom = torch.sqrt(accum.index_select(0, rows)) + eps
    delta = ((-lr * G) / denom) * valid[:, None]
    row_scatter_add_(table, urows, delta.contiguous())
    return table, accum


# ------------------------------------------------- legacy (rows, grads) API


def apply_sparse_sgd(table, rows, grads, lr):
    urows, G, valid = coalesce(rows, grads, table.shape[0])
    return sgd_from_coalesced(table, urows, G, valid, lr)


def apply_sparse_rowwise_adagrad(table, accum, rows, grads, lr,
                                 eps: float = ADAGRAD_EPS):
    urows, G, valid = coalesce(rows, grads, table.shape[0])
    return rowwise_adagrad_from_coalesced(table, accum, urows, G, valid, lr,
                                          eps)


def apply_sparse_adagrad(table, accum, rows, grads, lr,
                         eps: float = ADAGRAD_EPS):
    urows, G, valid = coalesce(rows, grads, table.shape[0])
    return adagrad_from_coalesced(table, accum, urows, G, valid, lr, eps)
