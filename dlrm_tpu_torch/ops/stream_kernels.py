"""The streamed embedding update over the U-layout (the port of
dlrm_tpu/ops/stream_kernels.py's gather_grads and K2 stream_update).

  gather_grads   dly [T, B, d] -> per-hit grads G_u [U, d] in U-order: one
                 index_select times the weight (XLA work in the JAX package,
                 an ATen op here).
  stream_update  K2: for every table block named by the work items, sum the
                 G_u rows of its hits into Gsum (fp32) and apply the sgd,
                 row-wise Adagrad or Adagrad update to the block's rows IN
                 PLACE (the JAX kernel aliases table and accumulator,
                 dlrm_tpu/ops/stream_kernels.py:517/548/573).

K2 on the card is the hand-written CUDA kernel csrc/stream_update.cu.

  Replaces:  dlrm_tpu/ops/stream_kernels.py:stream_update (Pallas: _sgd_kernel,
             _rowwise_adagrad_kernel, _adagrad_kernel, _accumulate_gsum,
             _flags, _cast_out).
  Bound:     bytes (each hit's G row read once, each touched table row and
             its accumulator read and written once; no matrix product).
  Design:    one CTA per (block, 128-row tile) with the tile's Gsum in
             shared memory; warps own fixed rows and add slots in item order,
             so the sum is deterministic without atomics; untouched blocks
             and rows are skipped (see the source's header).

stream_update_plain is the same contract in plain PyTorch. The wrapper uses
it only for tensors that lie on the CPU (the CPU tests); for CUDA tensors it
launches the kernel or raises, never falls back. LAUNCHES counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from typing import Optional

import torch

from dlrm_tpu_torch.buildlib import build_shared
from dlrm_tpu_torch.ops.stream_plan import CHUNK, SENTINEL_ROW, StreamPlan
from dlrm_tpu_torch.optim.optimizers import ADAGRAD_EPS

LAUNCHES = {"stream_update": 0}

_OPTIMIZERS = {"sgd": 0, "rwsadagrad": 1, "adagrad": 2}
_U32 = 0xFFFFFFFF


def gather_grads(
    dly: torch.Tensor,  # [T, B, d] pooled-embedding cotangent
    vals_u: torch.Tensor,  # [Uw, 8, 128] int32 bag index (0 at sentinels)
    wts_u: torch.Tensor,  # [Uw, 8, 128] f32 weight (0 at sentinels)
    w2t: torch.Tensor,  # [Uw] int32 window -> table
) -> torch.Tensor:  # G_u [Uw*1024, d] float32
    """G_u[u] = wts_u[u] * dly[w2t[u // 1024], vals_u[u]] in fp32. Sentinel
    slots gather bag 0 of the window's table and are zeroed by the weight.
    A bf16 dly times the fp32 weight promotes to fp32 inside the one
    multiply, with no fp32 copy of the gathered rows."""
    t, b, d = dly.shape
    idx = (w2t.long()[:, None, None] * b + vals_u).reshape(-1)
    g = dly.reshape(t * b, d).index_select(0, idx)
    return torch.mul(g, wts_u.reshape(-1, 1).float())


# ----------------------------------------------------- stochastic rounding
def _hash32(x):
    """The kernel's hash32 on uint32 values held in int64 tensors (or ints):
    every multiplier is < 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _U32
    x = x ^ (x >> 16)
    x = (x * 0x297A2D39) & _U32
    return x ^ (x >> 15)


def sr_bits(seed: int, rows: torch.Tensor, d: int) -> torch.Tensor:
    """[len(rows), d] int64: the 16 random low bits that stochastic rounding
    adds at (global row, column) for optimizer step `seed` — the same hash
    as csrc/stream_update.cu."""
    key = _hash32((rows.long() & _U32) ^ _hash32(int(seed) & _U32))
    cols = torch.arange(d, device=rows.device, dtype=torch.int64)
    return _hash32(key[:, None] ^ cols[None, :]) >> 16


def cast_out(val: torch.Tensor, dtype, sr: bool, seed: int,
             rows: torch.Tensor) -> torch.Tensor:
    """fp32 [n, d] -> table dtype. With sr and a bf16 table: add the
    hashed random bits below the bf16 mantissa to the fp32 pattern and
    truncate (FBGEMM's stochastic rounding, dlrm_tpu's _cast_out)."""
    if not sr or dtype != torch.bfloat16:
        return val.to(dtype)
    u = (val.contiguous().view(torch.int32).long() & _U32)
    u = (u + sr_bits(seed, rows, val.shape[1])) & 0xFFFF0000
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    return u.view(torch.float32).to(torch.bfloat16)


# ------------------------------------------------------------- plain K2
def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x [n, d] in the kernel's order: lane j adds columns j,
    j+32, ... in turn, then five xor-butterfly rounds combine the lanes."""
    n, d = x.shape
    lanes = -(-d // 32) * 32
    x = torch.nn.functional.pad(x, (0, lanes - d)).view(n, lanes // 32, 32)
    s = x[:, 0]
    for i in range(1, lanes // 32):
        s = s + x[:, i]
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    return s[:, 0]


@torch.no_grad()
def stream_update_plain(
    optimizer: str, plan: StreamPlan, table, acc, g_u, rows_u,
    item_block, item_row0, item_u, lr, *, mm_dtype=torch.float32,
    eps: float = ADAGRAD_EPS, stochastic_round: bool = False, seed: int = 0,
):
    """K2's contract in plain PyTorch: expand every item to its 256 slots,
    keep the slots whose row lies in the item's block, sum their G rows per
    table row with index_add_, and update the rows that received a hit in
    place.

    The sums are taken in the kernel's order, so that on the card the two
    agree to the bit: each row's hits are added in item/slot order (round k
    adds every row's k-th hit; rows are unique within a round, so index_add_
    meets no conflicting writes), and rwsadagrad's sum over d follows the
    kernel's warp (32 lane partials, then an xor butterfly)."""
    br = plan.block_rows
    d = table.shape[1]
    dev = table.device
    slots = (item_u.long()[:, None]
             + torch.arange(CHUNK, device=dev)).reshape(-1)
    blk = item_block.long().repeat_interleave(CHUNK)
    row0 = item_row0.long().repeat_interleave(CHUNK)
    r = rows_u.reshape(-1).long()[slots]
    keep = ((blk < plan.num_blocks) & (r != SENTINEL_ROW)
            & (r >= row0) & (r < row0 + br))
    grow = (blk * br + r - row0)[keep]
    g = g_u[slots[keep]]
    if mm_dtype == torch.bfloat16:
        g = g.to(torch.bfloat16).float()
    rows, inv, counts = torch.unique(grow, return_inverse=True,
                                     return_counts=True)
    order = torch.argsort(inv, stable=True)
    rank = torch.empty_like(inv)
    rank[order] = torch.arange(inv.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    gs = torch.zeros((rows.numel(), d), dtype=torch.float32, device=dev)
    for k in range(int(counts.max()) if counts.numel() else 0):
        sel = (rank == k).nonzero().squeeze(1)
        gs.index_add_(0, inv[sel], g[sel])
    w = table[rows].float()
    sr = bool(stochastic_round) and table.dtype == torch.bfloat16
    if optimizer == "sgd":
        new = w - lr * gs
    elif optimizer == "rwsadagrad":
        acc_flat = acc.view(-1)
        a = acc_flat[rows] + _warp_sum(gs * gs) / d
        acc_flat[rows] = a
        new = w - (lr * gs) / (torch.sqrt(a) + eps)[:, None]
    elif optimizer == "adagrad":
        a = acc[rows] + gs * gs
        acc[rows] = a
        new = w - (lr * gs) / (torch.sqrt(a) + eps)
    else:
        raise ValueError(f"optimizer {optimizer!r} not supported")
    table[rows] = cast_out(new, table.dtype, sr, seed, rows)
    return (table,) if optimizer == "sgd" else (table, acc)


# ------------------------------------------------------------ CUDA K2
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


@functools.lru_cache(maxsize=None)
def k2_library() -> ctypes.CDLL:
    """Build (at first use) and load csrc/stream_update.cu."""
    path = build_shared(
        "stream_update", ["csrc/stream_update.cu"],
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC"],
    )
    lib = ctypes.CDLL(path)
    fn = lib.k2_stream_update
    p = ctypes.c_void_p
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int,  # opt, table_bf16
        p, p, p, p, p, p, p,  # table, acc, g_u, rows_u, item_block/row0/u
        p, p,  # block_first, block_last scratch
        ctypes.c_int64, ctypes.c_int64,  # m_items, u_total
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # num_blocks, br, d
        ctypes.c_float, ctypes.c_float, ctypes.c_uint32,  # lr, eps, seed
        ctypes.c_int, ctypes.c_int,  # mm_bf16, sr
        p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtypes, shape=None, numel=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_update(
    optimizer: str,  # sgd | rwsadagrad | adagrad
    plan: StreamPlan,
    table: torch.Tensor,  # [padded_rows, d] f32 | bf16, updated in place
    acc: Optional[torch.Tensor],  # packed [padded_rows/128, 128] f32
    #                               (rwsadagrad), [padded_rows, d] f32
    #                               (adagrad), None (sgd); in place
    g_u: torch.Tensor,  # [U, d] f32 from gather_grads
    rows_u: torch.Tensor,  # [Uw, 8, 128] int32
    item_block: torch.Tensor,  # [M] int32
    item_row0: torch.Tensor,  # [M] int32
    item_u: torch.Tensor,  # [M] int32
    lr: float,
    *,
    mm_dtype=torch.float32,  # bfloat16: round each G row to bf16 first
    eps: float = ADAGRAD_EPS,
    stochastic_round: bool = False,  # SR the bf16 table writes
    seed: int = 0,  # SR stream: pass the optimizer step
):
    """Returns (table,) for sgd or (table, acc) otherwise — the SAME
    tensors, updated in place. The items of one block must be contiguous in
    the item list (build_stream_work and touched_update_items emit them so).
    lr and seed are host scalars: nothing here waits on the device."""
    if optimizer not in _OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r} not supported")
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mm_dtype must be float32 or bfloat16, got {mm_dtype}")
    if not isinstance(lr, (int, float)) or not isinstance(seed, int):
        raise TypeError("lr and seed must be host scalars (float, int)")
    fp = (torch.float32, torch.bfloat16)
    i32 = (torch.int32,)
    _check("table", table, fp)
    d = table.shape[1]
    _check("table", table, fp, shape=(plan.padded_rows, d))
    if optimizer == "rwsadagrad":
        _check("acc", acc, (torch.float32,), shape=(plan.acc_rows, 128))
    elif optimizer == "adagrad":
        _check("acc", acc, (torch.float32,), shape=tuple(table.shape))
    elif acc is not None:
        raise ValueError("sgd keeps no accumulator; pass acc=None")
    _check("g_u", g_u, (torch.float32,), shape=(plan.u_total, d))
    _check("rows_u", rows_u, i32, numel=plan.u_total)
    m = item_block.numel()
    for name, t in (("item_block", item_block), ("item_row0", item_row0),
                    ("item_u", item_u)):
        _check(name, t, i32, numel=m)
    tensors = [table, g_u, rows_u, item_block, item_row0, item_u]
    if acc is not None:
        tensors.append(acc)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"stream_update inputs span devices {devices}")
    dev = table.device
    if dev.type == "cpu":
        return stream_update_plain(
            optimizer, plan, table, acc, g_u, rows_u, item_block, item_row0,
            item_u, lr, mm_dtype=mm_dtype, eps=eps,
            stochastic_round=stochastic_round, seed=seed,
        )
    if dev.type != "cuda":
        raise ValueError(f"stream_update runs on cuda or cpu, not {dev}")

    lib = k2_library()
    scratch = torch.empty((2, max(plan.num_blocks, 1)), dtype=torch.int32,
                          device=dev)
    sr = bool(stochastic_round) and table.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.k2_stream_update(
            _OPTIMIZERS[optimizer], int(table.dtype == torch.bfloat16),
            table.data_ptr(), None if acc is None else acc.data_ptr(),
            g_u.data_ptr(), rows_u.data_ptr(), item_block.data_ptr(),
            item_row0.data_ptr(), item_u.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(),
            m, plan.u_total, plan.num_blocks, plan.block_rows, d,
            float(lr), float(eps), int(seed) & _U32,
            int(mm_dtype == torch.bfloat16), int(sr), stream,
        )
    if err != 0:
        raise RuntimeError(f"k2_stream_update failed: CUDA error {err}")
    LAUNCHES["stream_update"] += 1
    return (table,) if optimizer == "sgd" else (table, acc)
