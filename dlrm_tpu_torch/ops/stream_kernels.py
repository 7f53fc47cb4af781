"""The streamed embedding kernels over the U-layout (the port of
dlrm_tpu/ops/stream_kernels.py: gather_grads and the four Pallas kernels).

  gather_grads          dly [T, B, d] -> per-hit grads G_u [U, d] in
                        U-order: one index_select times the weight (XLA
                        work in the JAX package, an ATen op here).
  K1 window_grads       the same G_u, with both operands rounded to
                        mm_dtype first (the TPU's one-hot matmul).
  K2 stream_update      for every table block named by the work items, sum
                        the G_u rows of its hits into Gsum (fp32) and apply
                        the sgd, row-wise Adagrad or Adagrad update to the
                        block's rows IN PLACE (the JAX kernel aliases table
                        and accumulator, dlrm_tpu/ops/stream_kernels.py:
                        517/548/573). A row of more than K2_CHUNK hits is
                        summed as chunks of K2_CHUNK, then the chunks' sums.
  K3 stream_rows        R_u [U, d]: every slot's table row (0 at sentinels),
                        the first half of the streamed forward.
  K4 window_pool        pooled [T, B, d] = the weighted sum of each bag's
                        R_u rows in slot order, the second half.
  stream_embedding_fwd  K3 then K4.

The intermediates G_u and R_u are fp32 or bf16 (the step's g_dtype):
gather_grads, K1 and K3 take out_dtype and round their fp32 values once to
it (nearest, ties to even); K2 and K4 read either and sum in fp32.

Each kernel is hand-written CUDA C++ for sm_90a in csrc/<name>.cu, built at
first use by nvcc into a library with a plain C interface (kernel_library)
and called through ctypes. Each source's header says which TPU kernel it
replaces, what bounds it on the card (bytes, for all four: none does a
matrix product; the TPU kernels' one-hot MXU matmuls only emulated gathers
and scatter-adds) and what its design does about it.

Beside each kernel, <name>_plain is the same contract in plain PyTorch. A
wrapper uses it only for tensors that lie on the CPU (the CPU tests); for
CUDA tensors it launches the kernel or raises, never falls back. LAUNCHES
counts each kernel's launches; a process run with DLRM_TORCH_LAUNCHES_TO=<dir>
writes them at exit to <dir>/launches_<pid>.json, so that the processes a
launcher or a script starts report the kernels they ran.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import json
import os
import shutil
from typing import Optional

import torch

from dlrm_tpu_torch.buildlib import build_shared
from dlrm_tpu_torch.ops.stream_plan import (
    CHUNK,
    K2_CHUNK,
    SENTINEL_ROW,
    WINDOW,
    StreamPlan,
)
from dlrm_tpu_torch.optim.optimizers import ADAGRAD_EPS

LAUNCHES = {"window_grads": 0, "stream_update": 0, "stream_rows": 0,
            "window_pool": 0}

LAUNCHES_TO = "DLRM_TORCH_LAUNCHES_TO"


def _write_launches(out_dir: str) -> None:
    with open(os.path.join(out_dir, f"launches_{os.getpid()}.json"),
              "w") as f:
        json.dump(LAUNCHES, f)


if os.environ.get(LAUNCHES_TO):
    atexit.register(_write_launches, os.environ[LAUNCHES_TO])

_OPTIMIZERS = {"sgd": 0, "rwsadagrad": 1, "adagrad": 2}
_U32 = 0xFFFFFFFF


def gather_grads(
    dly: torch.Tensor,  # [T, B, d] pooled-embedding cotangent
    vals_u: torch.Tensor,  # [Uw, 8, 128] int32 bag index (0 at sentinels)
    wts_u: torch.Tensor,  # [Uw, 8, 128] f32 weight (0 at sentinels)
    w2t: torch.Tensor,  # [Uw] int32 window -> table
    *,
    out_dtype=torch.float32,  # float32 | bfloat16 (the step's g_dtype)
) -> torch.Tensor:  # G_u [Uw*1024, d] out_dtype
    """G_u[u] = wts_u[u] * dly[w2t[u // 1024], vals_u[u]] in fp32, then
    rounded once to out_dtype. Sentinel slots gather bag 0 of the window's
    table and are zeroed by the weight. A bf16 dly times the fp32 weight
    promotes to fp32 inside the one multiply, with no fp32 copy of the
    gathered rows."""
    _check_mm(out_dtype=out_dtype)
    t, b, d = dly.shape
    idx = (w2t.long()[:, None, None] * b + vals_u).reshape(-1)
    g = dly.reshape(t * b, d).index_select(0, idx)
    return torch.mul(g, wts_u.reshape(-1, 1).float()).to(out_dtype)


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
def _ranks(index: torch.Tensor) -> torch.Tensor:
    """rank[i]: how many j < i have index[j] == index[i]."""
    order = torch.argsort(index, stable=True)
    counts = torch.bincount(index)
    rank = torch.empty_like(index)
    rank[order] = (torch.arange(index.numel(), device=index.device)
                   - (torch.cumsum(counts, 0) - counts)[index[order]])
    return rank


def _add_in_rounds(out, index, src) -> None:
    """out[index[i]] += src[i], each row of out taking its terms in the
    order of i: round k adds every row's k-th term. Within a round the
    indices are distinct, so index_add_ adds each row once, with no
    conflicting writes: the same bits on every run and device."""
    rank = _ranks(index)
    by_round = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist() if rank.numel() else []
    for sel in torch.split(by_round, sizes):
        out.index_add_(0, index[sel], src[sel])


def _k2_sums(g: torch.Tensor, inv: torch.Tensor, n: int) -> torch.Tensor:
    """Gsum [n, d] fp32 of the hits' rows g (in slot order) by their row
    inv, in K2's order: a row of up to K2_CHUNK hits from zero in slot
    order; a longer one as chunks of K2_CHUNK hits from its first, each
    summed from zero in slot order, then the chunks' sums from zero in
    chunk order. So a row costs at most K2_CHUNK rounds of index_add_ and
    one a chunk, not one a hit."""
    gs = torch.zeros((n, g.shape[1]), dtype=torch.float32, device=g.device)
    counts = torch.bincount(inv, minlength=n)
    long = counts[inv] > K2_CHUNK
    _add_in_rounds(gs, inv[~long], g[~long])
    if bool(long.any()):
        inv_l = inv[long]
        per_row = int(counts.max()) // K2_CHUNK + 1  # chunks a row, at most
        key = inv_l * per_row + _ranks(inv_l) // K2_CHUNK
        chunks, chunk_of = torch.unique(key, return_inverse=True)
        part = torch.zeros((chunks.numel(), g.shape[1]), dtype=torch.float32,
                           device=g.device)
        _add_in_rounds(part, chunk_of, g[long])
        _add_in_rounds(gs, chunks // per_row, part)  # in chunk order
    return gs


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x [n, d] (x >= 0) in the kernel's order: lane j adds its
    columns 4j, 4j+1, 4j+2, 4j+3, then 128+4j, ... in turn from zero, then
    five xor-butterfly rounds combine the lanes. The zero padding past d
    adds +0 to a sum >= 0, which leaves it unchanged."""
    n, d = x.shape
    width = -(-d // 128) * 128
    x = torch.nn.functional.pad(x, (0, width - d)).view(n, width // 128, 32, 4)
    s = torch.zeros((n, 32), dtype=x.dtype, device=x.device)
    for k in range(width // 128):
        for q in range(4):
            s = s + x[:, k, :, q]
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
    agree to the bit: each row's hits in slot order (_k2_sums: from zero,
    or in chunks of K2_CHUNK for a longer row; round k adds every row's
    k-th term, and rows are unique within a round, so index_add_ meets no
    conflicting writes), and rwsadagrad's sum over d follows the kernel's
    warp (_warp_sum)."""
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
    # each slot lies in one item of its block, whatever the items' order
    kept, order = torch.sort(slots[keep])
    grow = (blk * br + r - row0)[keep][order]
    g = _mm(g_u[kept], mm_dtype)  # a bf16 G_u is widened: one dtype
    rows, inv = torch.unique(grow, return_inverse=True)
    gs = _k2_sums(g, inv, rows.numel())
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


# ------------------------------------------------- building and calling
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# kernel name -> (its source csrc/<source>.cu, its C entry point, argtypes
# with the stream last); ops/probe_kernels.py adds the probes' kernels
_ENTRY_POINTS = {
    "window_grads": ("window_grads", "k1_window_grads", [
        _I, _P, _I64, _I64,  # dly_bf16, dly, stride_t, stride_b
        _P, _P, _P, _P,  # vals_u, wts_u, w2t, g_u
        _I64, _I, _I, _I,  # u_total, d, mm_bf16, out_bf16
        _I, _P,  # grid, stream
    ]),
    "stream_update": ("stream_update", "k2_stream_update", [
        _I, _I, _I,  # opt, table_bf16, g_bf16
        _P, _P, _P, _P, _P, _P, _P,  # table, acc, g_u, rows_u, item_*
        _I64, _I64,  # m_items, u_total
        _I, _I, _I,  # num_blocks, br, d
        ctypes.c_float, ctypes.c_float, ctypes.c_uint32,  # lr, eps, seed
        _I, _I,  # mm_bf16, sr
        _P, _P,  # scratch: the long runs' int32 arrays, their partials
        _P,  # stream
    ]),
    "stream_rows": ("stream_rows", "k3_stream_rows", [
        _I, _P, _P,  # table_bf16, table, rows_u
        _P, _P, _P, _P,  # item_block, item_row0, item_u, r_u
        _I64, _I64, _I, _I, _I,  # m_items, u_total, num_blocks, br, d
        _I, _I, _P,  # mm_bf16, out_bf16, stream
    ]),
    "window_pool": ("window_pool", "k4_window_pool", [
        _P, _P, _P, _P, _P,  # r_u, vals_u, wts_u, w2t, pooled
        _P, _P, _P, _P, _P,  # scratch: cnt, loc, tile_sum, list, sorted
        _I64, _I, _I, _I,  # u_total, tables, batch, d
        _I, _I, _I, _P,  # tiles, mm_bf16, r_bf16, stream
    ]),
}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# headers the sources include: hashed into every library's name
_HEADERS = ("csrc/u_layout.cuh", "csrc/k2_update.cuh")
_SCAN_TILE = 2048  # counts per CTA of K4's scan (window_pool.cu kScanTile)


@functools.lru_cache(maxsize=None)
def kernel_library(source: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<source>.cu, one library per
    source so that several builds can run at once."""
    path = build_shared(source, [f"csrc/{source}.cu"], [_nvcc(), *_NVCC_FLAGS],
                        deps=_HEADERS)
    return ctypes.CDLL(path)


@functools.lru_cache(maxsize=None)
def _entry_point(name: str):
    source, symbol, argtypes = _ENTRY_POINTS[name]
    fn = getattr(kernel_library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def register_kernels(entry_points: dict) -> None:
    """Add kernels, name -> (source, C entry point, argtypes), to the table
    _launch reads and to LAUNCHES."""
    _ENTRY_POINTS.update(entry_points)
    for name in entry_points:
        LAUNCHES.setdefault(name, 0)


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch kernel `name` on dev's current stream with `args`, raise if
    its entry point reports a CUDA error, and count the launch. The stream
    goes as its raw handle, with no Stream object built, and the device is
    switched only when dev is not the current one (the host's cost of a
    launch: chip_smoke.py phase 2b)."""
    fn = _entry_point(name)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{_ENTRY_POINTS[name][1]} failed: CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def _check(name, t, dtypes, shape=None, numel=None, contiguous=True):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device(kernel: str, *tensors) -> torch.device:
    """The one device all of a call's tensors lie on: cpu (the plain
    version) or cuda (the kernel); anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{kernel} inputs span devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on cuda or cpu, not {dev}")
    return dev


_FP = (torch.float32, torch.bfloat16)


def _check_mm(mm_dtype=torch.float32, out_dtype=torch.float32):
    if mm_dtype not in _FP:
        raise TypeError(f"mm_dtype must be float32 or bfloat16, got "
                        f"{mm_dtype}")
    if out_dtype not in _FP:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
_I32 = (torch.int32,)


def _check_rows4(name: str, t: torch.Tensor) -> None:
    """The kernels move rows 4 elements at a time (16-byte fp32, 8-byte bf16
    accesses): the row width, the row strides and the start must allow it."""
    if (t.shape[-1] % 4 or any(s % 4 for s in t.stride()[:-1])
            or t.data_ptr() % (4 * t.element_size())):
        raise ValueError(
            f"{name}: the kernel reads rows 4 elements at a time; the row "
            f"width, row strides and start must be multiples of 4 elements "
            f"(shape {tuple(t.shape)}, strides {t.stride()})")


MAX_ROW_WIDTH = 512  # K2 and K4 hold a row in registers: 16 columns a lane


def _check_row_regs(d: int) -> None:
    if d > MAX_ROW_WIDTH:
        raise ValueError(f"the kernel holds a row in registers: d = {d} > "
                         f"{MAX_ROW_WIDTH}")


def _mm(x: torch.Tensor, mm_dtype) -> torch.Tensor:
    """x rounded to mm_dtype, as fp32."""
    return x.to(mm_dtype).float()


@functools.lru_cache(maxsize=None)
def _k2_chunk() -> int:
    """The kernel's C, checked once against K2_CHUNK."""
    c = kernel_library("stream_update").k2_chunk()
    if c != K2_CHUNK:
        raise RuntimeError(f"csrc/stream_update.cu sums chunks of {c} hits, "
                           f"stream_plan.K2_CHUNK is {K2_CHUNK}")
    return c


def stream_update(
    optimizer: str,  # sgd | rwsadagrad | adagrad
    plan: StreamPlan,
    table: torch.Tensor,  # [padded_rows, d] f32 | bf16, updated in place
    acc: Optional[torch.Tensor],  # packed [padded_rows/128, 128] f32
    #                               (rwsadagrad), [padded_rows, d] f32
    #                               (adagrad), None (sgd); in place
    g_u: torch.Tensor,  # [U, d] f32 | bf16 from gather_grads or K1
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
    tensors, updated in place. Each hit slot of a block must lie in exactly
    one of that block's items, in any order (build_stream_work and
    touched_update_items emit them so). lr and seed are host scalars:
    nothing here waits on the device."""
    if optimizer not in _OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r} not supported")
    _check_mm(mm_dtype)
    if not isinstance(lr, (int, float)) or not isinstance(seed, int):
        raise TypeError("lr and seed must be host scalars (float, int)")
    fp, i32 = _FP, _I32
    _check("table", table, fp)
    d = table.shape[1]
    _check("table", table, fp, shape=(plan.padded_rows, d))
    if optimizer == "rwsadagrad":
        _check("acc", acc, (torch.float32,), shape=(plan.acc_rows, 128))
    elif optimizer == "adagrad":
        _check("acc", acc, (torch.float32,), shape=tuple(table.shape))
    elif acc is not None:
        raise ValueError("sgd keeps no accumulator; pass acc=None")
    _check("g_u", g_u, fp, shape=(plan.u_total, d))
    _check("rows_u", rows_u, i32, numel=plan.u_total)
    m = item_block.numel()
    for name, t in (("item_block", item_block), ("item_row0", item_row0),
                    ("item_u", item_u)):
        _check(name, t, i32, numel=m)
    dev = _device("stream_update", table, g_u, rows_u, item_block, item_row0,
                  item_u, acc)
    if dev.type == "cpu":
        return stream_update_plain(
            optimizer, plan, table, acc, g_u, rows_u, item_block, item_row0,
            item_u, lr, mm_dtype=mm_dtype, eps=eps,
            stochastic_round=stochastic_round, seed=seed,
        )

    _check_row_regs(d)
    _check_rows4("table", table)
    _check_rows4("g_u", g_u)
    if optimizer == "adagrad":
        _check_rows4("acc", acc)
    sr = bool(stochastic_round) and table.dtype == torch.bfloat16
    # scratch of the runs of more than C hits, by C-window of U: the chunk
    # table (two entries a window), each long run's length, block and row,
    # and the chunks' fp32 sums (csrc/stream_update.cu)
    windows = -(-plan.u_total // _k2_chunk())
    runs_i = torch.empty(5 * windows, dtype=torch.int32, device=dev)
    part = torch.empty((2 * windows, d), dtype=torch.float32, device=dev)
    _launch(
        "stream_update", dev,
        _OPTIMIZERS[optimizer], int(table.dtype == torch.bfloat16),
        int(g_u.dtype == torch.bfloat16), table.data_ptr(),
        None if acc is None else acc.data_ptr(),
        g_u.data_ptr(), rows_u.data_ptr(), item_block.data_ptr(),
        item_row0.data_ptr(), item_u.data_ptr(),
        m, plan.u_total, plan.num_blocks, plan.block_rows, d,
        float(lr), float(eps), int(seed) & _U32,
        int(mm_dtype == torch.bfloat16), int(sr), runs_i.data_ptr(),
        part.data_ptr(),
    )
    return (table,) if optimizer == "sgd" else (table, acc)


# ------------------------------------------------------------------ K1
def window_grads_plain(dly, vals_u, wts_u, w2t, *, out_dtype=torch.float32,
                       mm_dtype=torch.float32) -> torch.Tensor:
    """K1's contract in plain PyTorch: one fp32 product per element of the
    weight and the gathered dly row, both rounded to mm_dtype first (the
    kernel's arithmetic, so the two agree to the bit)."""
    t_of = w2t.long().repeat_interleave(WINDOW)
    rows = dly[t_of, vals_u.reshape(-1).long()]
    g = _mm(rows, mm_dtype) * _mm(wts_u.reshape(-1, 1), mm_dtype)
    return g.to(out_dtype)


def window_grads(
    dly: torch.Tensor,  # [T, B, d] f32 | bf16, any strides with unit last
    vals_u: torch.Tensor,  # [Uw, 8, 128] int32 bag index (0 at sentinels)
    wts_u: torch.Tensor,  # [Uw, 8, 128] f32 weight (0 at sentinels)
    w2t: torch.Tensor,  # [Uw] int32 window -> table
    *,
    out_dtype=torch.float32,  # float32 | bfloat16 (the step's g_dtype)
    mm_dtype=torch.float32,  # bfloat16: round weight and dly to bf16 first
) -> torch.Tensor:  # G_u [Uw*1024, d] out_dtype
    """K1: G_u[u] = mm(wts_u[u]) * mm(dly[w2t[u // 1024], vals_u[u]]) in
    fp32, rounded once to out_dtype (nearest, ties to even). dly is read
    through its strides: the [B, T, d] cotangent's transpose(0, 1) view
    needs no copy. No batch limit (the TPU's VMEM guard does not apply)."""
    _check_mm(mm_dtype, out_dtype)
    _check("dly", dly, _FP, contiguous=False)
    if dly.dim() != 3 or dly.stride(2) != 1:
        raise ValueError(f"dly must be [T, B, d] with unit column stride, "
                         f"got shape {tuple(dly.shape)} strides {dly.stride()}")
    uw = w2t.numel()
    _check("w2t", w2t, _I32, shape=(uw,))
    _check("vals_u", vals_u, _I32, numel=uw * WINDOW)
    _check("wts_u", wts_u, (torch.float32,), numel=uw * WINDOW)
    dev = _device("window_grads", dly, vals_u, wts_u, w2t)
    if dev.type == "cpu":
        return window_grads_plain(dly, vals_u, wts_u, w2t,
                                  out_dtype=out_dtype, mm_dtype=mm_dtype)
    _check_rows4("dly", dly)
    return _window_grads_launch(dly, vals_u, wts_u, w2t, uw * WINDOW,
                                out_dtype, mm_dtype)


K1_TILE = 32  # slots a warp tile (window_grads.cu kTile)
K1_WARPS = 8  # warps a block (u_layout.cuh kThreads / 32)


def window_grads_grid(u_total: int) -> tuple:
    """K1's launch for u_total slots: (its warp tiles of K1_TILE slots, its
    blocks: a warp a tile, K1_WARPS tiles a block; 0 blocks, no launch,
    for no slot)."""
    tiles = -(-u_total // K1_TILE)
    return tiles, -(-tiles // K1_WARPS)


def _window_grads_launch(dly, vals_u, wts_u, w2t, u_total, out_dtype,
                         mm_dtype) -> torch.Tensor:
    """K1 on the card over the first u_total slots: G_u [u_total, d].
    window_grads passes whole windows; a count that ends inside a warp
    tile reaches the kernel's ragged last tile (the CUDA tests)."""
    dev = dly.device
    g_u = torch.empty((u_total, dly.shape[2]), dtype=out_dtype, device=dev)
    _, grid = window_grads_grid(u_total)
    if grid:
        _launch("window_grads", dev, int(dly.dtype == torch.bfloat16),
                dly.data_ptr(), dly.stride(0), dly.stride(1),
                vals_u.data_ptr(), wts_u.data_ptr(), w2t.data_ptr(),
                g_u.data_ptr(), u_total, dly.shape[2],
                int(mm_dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), grid)
    return g_u


# ------------------------------------------------------------------ K3
@torch.no_grad()
def stream_rows_plain(plan: StreamPlan, table, rows_u, item_block, item_row0,
                      item_u, *, out_dtype=torch.float32,
                      mm_dtype=torch.float32) -> torch.Tensor:
    """K3's contract in plain PyTorch: each item writes the slots of its
    256-slot chunk whose row lies in its (real) block, and 0 at its sentinel
    slots. A slot that no item writes stays NaN, where the kernel leaves
    uninitialized memory."""
    br = plan.block_rows
    dev = table.device
    slots = (item_u.long()[:, None]
             + torch.arange(CHUNK, device=dev)).reshape(-1)
    blk = item_block.long().repeat_interleave(CHUNK)
    row0 = item_row0.long().repeat_interleave(CHUNK)
    r = rows_u.reshape(-1).long()[slots]
    owned = ((blk < plan.num_blocks) & (r != SENTINEL_ROW)
             & (r >= row0) & (r < row0 + br))
    out = torch.full((plan.u_total, table.shape[1]), float("nan"),
                     dtype=out_dtype, device=dev)
    out[slots[r == SENTINEL_ROW]] = 0
    out[slots[owned]] = _mm(table[(blk * br + r - row0)[owned]],
                            mm_dtype).to(out_dtype)
    return out


def _check_items(plan, rows_u, item_block, item_row0, item_u) -> int:
    _check("rows_u", rows_u, _I32, numel=plan.u_total)
    m = item_block.numel()
    for name, t in (("item_block", item_block), ("item_row0", item_row0),
                    ("item_u", item_u)):
        _check(name, t, _I32, numel=m)
    return m


def stream_rows(
    plan: StreamPlan,
    table: torch.Tensor,  # [padded_rows, d] f32 | bf16
    rows_u: torch.Tensor,  # [Uw, 8, 128] int32
    item_block: torch.Tensor,  # [M] int32: the FULL item list
    item_row0: torch.Tensor,  # [M] int32
    item_u: torch.Tensor,  # [M] int32
    *,
    out_dtype=torch.float32,  # float32 | bfloat16 (the step's g_dtype)
    mm_dtype=torch.float32,  # bfloat16: round each row to bf16
) -> torch.Tensor:  # R_u [U, d] out_dtype
    """K3: R_u[u] = mm(table[block * br + rows_u[u] - row0]) for the item
    whose block holds the slot's row, 0 at sentinel slots; rounded once to
    out_dtype (nearest, ties to even). Every slot is
    written only when the item list is the full cover list
    (HostBatch.with_stream_work without update_touched_only)."""
    _check_mm(mm_dtype, out_dtype)
    _check("table", table, _FP)
    d = table.shape[1]
    _check("table", table, _FP, shape=(plan.padded_rows, d))
    m = _check_items(plan, rows_u, item_block, item_row0, item_u)
    dev = _device("stream_rows", table, rows_u, item_block, item_row0, item_u)
    if dev.type == "cpu":
        return stream_rows_plain(plan, table, rows_u, item_block, item_row0,
                                 item_u, out_dtype=out_dtype,
                                 mm_dtype=mm_dtype)
    _check_rows4("table", table)
    r_u = torch.empty((plan.u_total, d), dtype=out_dtype, device=dev)
    _launch("stream_rows", dev, int(table.dtype == torch.bfloat16),
            table.data_ptr(), rows_u.data_ptr(), item_block.data_ptr(),
            item_row0.data_ptr(), item_u.data_ptr(), r_u.data_ptr(), m,
            plan.u_total, plan.num_blocks, plan.block_rows, d,
            int(mm_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
    return r_u


# ------------------------------------------------------------------ K4
@torch.no_grad()
def window_pool_plain(plan: StreamPlan, r_u, vals_u, wts_u, w2t, *,
                      mm_dtype=torch.float32) -> torch.Tensor:
    """K4's contract in plain PyTorch: each (table, bag) row of a zeroed
    output gets mm(weight) * mm(row) of its slots of nonzero weight added in
    ascending slot order (round k adds every bag's k-th slot; bags are
    unique within a round, so index_add_ meets no conflicting writes and the
    result is the same on every run, on the card too). A slot of weight 0
    adds +0 to a sum that is never -0 (for a finite row), so leaving it out
    changes no bit."""
    t, b, d = len(plan.table_sizes), plan.batch, r_u.shape[1]
    w = wts_u.reshape(-1)
    slots = (w != 0).nonzero().squeeze(1)  # ascending
    bag = (w2t.long().repeat_interleave(WINDOW) * b
           + vals_u.reshape(-1).long())[slots]
    contrib = _mm(r_u[slots], mm_dtype) * _mm(w[slots, None], mm_dtype)
    pooled = torch.zeros((t * b, d), dtype=torch.float32, device=r_u.device)
    _add_in_rounds(pooled, bag, contrib)
    return pooled.view(t, b, d)


def window_pool(
    plan: StreamPlan,
    r_u: torch.Tensor,  # [U, d] f32 | bf16 from stream_rows
    vals_u: torch.Tensor,  # [Uw, 8, 128] int32
    wts_u: torch.Tensor,  # [Uw, 8, 128] f32
    w2t: torch.Tensor,  # [Uw] int32
    *,
    mm_dtype=torch.float32,  # bfloat16: round weight and row to bf16 first
) -> torch.Tensor:  # pooled [T, B, d] float32
    """K4: pooled[t, b] = sum of mm(wts_u[u]) * mm(R_u[u]) over table t's
    slots with vals_u[u] == b, in fp32, in ascending slot order: the plain
    version's bits, the same on every run. No batch limit (the TPU's VMEM
    guard does not apply)."""
    _check_mm(mm_dtype)
    _check("r_u", r_u, _FP)
    d = r_u.shape[1]
    _check("r_u", r_u, _FP, shape=(plan.u_total, d))
    _check("vals_u", vals_u, _I32, numel=plan.u_total)
    _check("wts_u", wts_u, (torch.float32,), numel=plan.u_total)
    _check("w2t", w2t, _I32, shape=(plan.num_windows,))
    dev = _device("window_pool", r_u, vals_u, wts_u, w2t)
    if dev.type == "cpu":
        return window_pool_plain(plan, r_u, vals_u, wts_u, w2t,
                                 mm_dtype=mm_dtype)
    _check_rows4("r_u", r_u)
    _check_row_regs(d)
    t, b = len(plan.table_sizes), plan.batch
    pooled = torch.empty((t, b, d), dtype=torch.float32, device=dev)
    # int32 scratch: per-bag counts and offsets (one extra entry for the
    # end), the scan's tile totals, the bags' slot lists before and after
    # sorting
    n = t * b + 1
    tiles = -(-n // _SCAN_TILE)
    scratch = torch.empty(2 * n + tiles + 2 * plan.u_total, dtype=torch.int32,
                          device=dev)
    cnt, loc, tile_sum, lists, ordered = torch.split(
        scratch, [n, n, tiles, plan.u_total, plan.u_total])
    _launch("window_pool", dev, r_u.data_ptr(), vals_u.data_ptr(),
            wts_u.data_ptr(), w2t.data_ptr(), pooled.data_ptr(),
            cnt.data_ptr(), loc.data_ptr(), tile_sum.data_ptr(),
            lists.data_ptr(), ordered.data_ptr(), plan.u_total, t, b, d,
            tiles, int(mm_dtype == torch.bfloat16),
            int(r_u.dtype == torch.bfloat16))
    return pooled


def stream_embedding_fwd(
    plan: StreamPlan,
    table: torch.Tensor,
    rows_u, vals_u, wts_u, w2t, item_block, item_row0, item_u,
    *,
    mm_dtype=torch.float32,
    r_dtype=torch.float32,  # R_u's dtype: float32 | bfloat16 (g_dtype)
) -> torch.Tensor:  # pooled [T, B, d] float32
    """The streamed forward: K3 (stream rows) then K4 (window pool)."""
    r_u = stream_rows(plan, table, rows_u, item_block, item_row0, item_u,
                      out_dtype=r_dtype, mm_dtype=mm_dtype)
    return window_pool(plan, r_u, vals_u, wts_u, w2t, mm_dtype=mm_dtype)
