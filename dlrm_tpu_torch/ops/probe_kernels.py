"""The measurement probes' kernels (the port of the Pallas kernels under
bench_scripts/: scan_probe, stream_variants, k2_bisect, revolve_probe,
pallas_probe and kernel_feasibility).

  row_gather            out[k] = table[idx[k]] over any row and element
                        stride (P1, P5a; P2b and T1's takes)
  row_scatter_add_      table[idx[k]] += delta[k] in place, idx unique (P5b)
  block_stream          out[blk] = t[blk] * scale + shift over a static or
                        data-dependent block walk, in place or not, with 1,
                        2 or 4 loads in flight per thread (P2a, P4, T5)
  k2_bisect             K2's sgd update with its stages compiled in or out,
                        variants V1-V6 (P3)
  t2_contract           einsum("slr,sld->rd")                  (T2)
  t3_reshape_add        x.reshape(-1).reshape(x.shape) + 1    (T3)
  t4_onehot_accumulate  out[r] = sum of g[c] with idx[c] == r  (T4)
  t6_revolve_accumulate out block k = sum of x blocks k*steps + j (T6)

Each kernel is hand-written CUDA C++ for sm_90a in csrc/probe_rows.cu,
block_stream.cu, k2_bisect.cu or feasibility.cu, built and loaded as K1-K4
are, and launched and counted in stream_kernels.LAUNCHES through
stream_kernels' table, where this module registers them (KERNELS names
them). Beside each, <name>_plain is the same function in plain
PyTorch. A wrapper uses it only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dlrm_tpu_torch.ops.stream_kernels import (
    _check,
    _check_items,
    _check_rows4,
    _device,
    _launch,
    register_kernels,
    stream_update_plain,
)
from dlrm_tpu_torch.ops.stream_plan import StreamPlan

# the sources, each built into its own library
SOURCES = ("probe_rows", "block_stream", "k2_bisect", "feasibility")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# kernel -> (csrc/<source>.cu, its C entry point, argtypes with the stream last)
_ENTRY_POINTS = {
    "row_gather": ("probe_rows", "row_gather", [
        _P, _I64, _I64, _I64,  # table, rows, row_stride, elem_stride
        _P, _I64, _I, _I, _P, _P,  # idx, n, d, vec, out, stream
    ]),
    "row_scatter_add": ("probe_rows", "row_scatter_add", [
        _P, _I64, _P, _P, _I64, _I, _P,  # table, rows, idx, delta, n, d
    ]),
    "block_stream": ("block_stream", "block_stream", [
        _P, _P, _P, _I64, _I64, _I64,  # in, out, ib, n_walk, block4, total4
        _I, _F, _F, _P,  # depth, scale, shift, stream
    ]),
    "k2_bisect": ("k2_bisect", "k2_bisect", [
        _I, _P, _P, _P, _P, _P, _P,  # variant, table, g_u, rows_u, item_*
        _P, _P,  # block_first, block_last scratch
        _I64, _I64, _I, _I, _I, _F, _P,  # m, u_total, blocks, br, d, lr
    ]),
    "t2_contract": ("feasibility", "t2_contract", [
        _P, _P, _P, _I, _I, _I, _P,  # a, b, out, k_total, rows, cols
    ]),
    "t3_reshape_add": ("feasibility", "t3_reshape_add", [
        _P, _P, _I64, _I64, _P,  # x, out, rows, cols
    ]),
    "t4_onehot_accumulate": ("feasibility", "t4_onehot_accumulate", [
        _P, _P, _I, _I, _I, _P, _P,  # idx, g, cap, d, rows, out
    ]),
    "t6_revolve_accumulate": ("feasibility", "t6_revolve_accumulate", [
        _P, _P, _I64, _I, _I64, _P,  # x, out, n_out_blocks, steps, block
    ]),
}
register_kernels(_ENTRY_POINTS)
KERNELS = tuple(_ENTRY_POINTS)
_F32 = (torch.float32,)
_I32 = (torch.int32,)


# ------------------------------------------------------------- row gather
def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def row_gather(
    table: torch.Tensor,  # [rows, d] f32, any strides (a transposed view too)
    idx: torch.Tensor,  # int32, any shape, values in [0, rows)
) -> torch.Tensor:  # [*idx.shape, d] f32, contiguous
    """out[k] = table[idx[k]]. A transposed view gathers columns: P2b's lane
    take dlyT[:, i] is row_gather(dlyT.t(), i).t(). On the card an index
    outside [0, rows) gives a zero row (the plain version raises)."""
    _check("table", table, _F32, contiguous=False)
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got shape {tuple(table.shape)}")
    _check("idx", idx, _I32)
    dev = _device("row_gather", table, idx)
    if dev.type == "cpu":
        return row_gather_plain(table, idx)
    rows, d = table.shape
    out = torch.empty((*idx.shape, d), dtype=torch.float32, device=dev)
    row_stride, elem_stride = table.stride()
    vec = (elem_stride == 1 and d % 4 == 0 and row_stride % 4 == 0
           and table.data_ptr() % 16 == 0)
    _launch("row_gather", dev, table.data_ptr(), rows, row_stride,
            elem_stride, idx.data_ptr(), idx.numel(), d, int(vec),
            out.data_ptr())
    return out


# -------------------------------------------------------- row scatter-add
def row_scatter_add_plain(table, idx, delta) -> torch.Tensor:
    """The kernel's contract: an index outside [0, rows) is skipped (it
    selects its rows with a mask, which reads the count back to the
    host)."""
    keep = (idx >= 0) & (idx < table.shape[0])
    return table.index_add_(0, idx[keep].long(), delta[keep])


def row_scatter_add_(
    table: torch.Tensor,  # [rows, d] f32 contiguous, updated in place
    idx: torch.Tensor,  # [n] int32, unique
    delta: torch.Tensor,  # [n, d] f32 contiguous
    *,
    check_unique: bool = False,  # checks on the host: a device sync
) -> torch.Tensor:
    """table[idx[k]] += delta[k] in place; returns table. An index outside
    [0, rows) is skipped (JAX's FILL_OR_DROP scatter mode), so the fused
    step's slots past the table change nothing. The indices must be unique
    (each row has one writer on the card, no atomics); that is checked
    only when asked."""
    _check("table", table, _F32)
    d = table.shape[1]
    n = idx.numel()
    _check("idx", idx, _I32, shape=(n,))
    _check("delta", delta, _F32, shape=(n, d))
    dev = _device("row_scatter_add", table, idx, delta)
    if check_unique and torch.unique(idx).numel() != n:
        raise ValueError("row_scatter_add_: indices are not unique")
    if dev.type == "cpu":
        return row_scatter_add_plain(table, idx, delta)
    if d % 4 == 0:  # float4 rows; any other width element by element
        _check_rows4("table", table)
        _check_rows4("delta", delta)
    elif not (table.is_contiguous() and delta.is_contiguous()):
        raise ValueError("row_scatter_add_: table and delta must be "
                         "contiguous")
    _launch("row_scatter_add", dev, table.data_ptr(), table.shape[0],
            idx.data_ptr(), delta.data_ptr(), n, d)
    return table


# ----------------------------------------------------------- block stream
@torch.no_grad()
def block_stream_plain(t, ib=None, *, scale: float, shift: float, out=None,
                       depth: int = 1, block_rows: int = 2048):
    """The walk as a loop of slice updates (P4's XLA variant X); the static
    map as one expression (P4's E). depth changes nothing here."""
    dst = t if out is None else out
    if ib is None:
        return torch.add(torch.mul(t, scale), shift, out=dst)
    br = block_rows
    for blk in ib.tolist():
        dst[blk * br:(blk + 1) * br] = torch.add(
            torch.mul(t[blk * br:(blk + 1) * br], scale), shift)
    return dst


def block_stream(
    t: torch.Tensor,  # [rows, d] f32 contiguous
    ib: Optional[torch.Tensor] = None,  # [n_walk] int32 block walk; None:
    #                                     every block in order
    *,
    scale: float,
    shift: float,
    out: Optional[torch.Tensor] = None,  # None: update t in place
    depth: int = 1,  # 16-byte loads in flight per thread: 1, 2 or 4
    block_rows: int = 2048,
) -> torch.Tensor:
    """out[blk] = t[blk] * scale + shift (fp32, each op rounded, as the
    plain version) for every block blk = ib[g] of block_rows rows, or every
    block of t when ib is None. In place, the walk's blocks must be
    distinct. Returns the updated tensor."""
    _check("t", t, _F32)
    if t.dim() != 2:
        raise ValueError(f"t must be 2-D, got shape {tuple(t.shape)}")
    if depth not in (1, 2, 4):
        raise ValueError(f"depth must be 1, 2 or 4, got {depth}")
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    rows, d = t.shape
    if ib is not None:
        _check("ib", ib, _I32, shape=(ib.numel(),))
        if rows % block_rows:
            raise ValueError(f"{rows} rows are not whole blocks of "
                             f"{block_rows}")
    if out is not None:
        _check("out", out, _F32, shape=tuple(t.shape))
    dev = _device("block_stream", t, ib, out)
    kw = dict(scale=scale, shift=shift, out=out, depth=depth,
              block_rows=block_rows)
    if dev.type == "cpu":
        return block_stream_plain(t, ib, **kw)
    block_elems = block_rows * d
    if block_elems % 4 or t.data_ptr() % 16 or (
            out is not None and out.data_ptr() % 16):
        raise ValueError("block_stream moves 16 bytes at a time: a block "
                         "must hold a multiple of 4 elements and t and out "
                         "must start 16-byte aligned")
    dst = t if out is None else out
    n_walk = -(-rows // block_rows) if ib is None else ib.numel()
    _launch("block_stream", dev, t.data_ptr(), dst.data_ptr(),
            None if ib is None else ib.data_ptr(), n_walk, block_elems // 4,
            t.numel() // 4, depth, float(scale), float(shift))
    return dst


# ------------------------------------------------------------- k2 bisect
# variant -> does it apply the sums (V3 and V4 are skeletons: table unchanged)
K2_VARIANTS = {"V1": True, "V2": True, "V3": False, "V4": False, "V5": False,
               "V6": True}


def k2_bisect_plain(variant, plan: StreamPlan, table, g_u, rows_u,
                    item_block, item_row0, item_u, lr) -> torch.Tensor:
    """Every variant's values: sgd's update for V1, V2, V5 and V6 (K2's
    plain version), the table itself for the skeletons."""
    if K2_VARIANTS[variant]:
        stream_update_plain("sgd", plan, table, None, g_u, rows_u,
                            item_block, item_row0, item_u, lr)
    return table


def k2_bisect(
    variant: str,  # V1 .. V6 (csrc/k2_bisect.cu)
    plan: StreamPlan,
    table: torch.Tensor,  # [padded_rows, d] f32, updated in place
    g_u: torch.Tensor,  # [U, d] f32
    rows_u: torch.Tensor,  # [Uw, 8, 128] int32
    item_block: torch.Tensor,  # [M] int32
    item_row0: torch.Tensor,  # [M] int32
    item_u: torch.Tensor,  # [M] int32
    lr: float,
) -> torch.Tensor:
    """The sgd update (fp32 table) of K2's first, tile-per-CTA design with
    its stages switched as P3's variants: V1 gives K2's bits (both sum each
    row's hits in slot order from zero), V2 writes every row of each
    visited 128-row tile, V3 and V4 are the skeletons (no G row read), V5
    and V6 are V4 and V2 with the tile stored by one bulk copy. Returns
    table, in place."""
    if variant not in K2_VARIANTS:
        raise ValueError(f"variant must be one of {sorted(K2_VARIANTS)}, "
                         f"got {variant!r}")
    if not isinstance(lr, (int, float)):
        raise TypeError("lr must be a host scalar")
    _check("table", table, _F32)
    d = table.shape[1]
    _check("table", table, _F32, shape=(plan.padded_rows, d))
    _check("g_u", g_u, _F32, shape=(plan.u_total, d))
    m = _check_items(plan, rows_u, item_block, item_row0, item_u)
    dev = _device("k2_bisect", table, g_u, rows_u, item_block, item_row0,
                  item_u)
    if dev.type == "cpu":
        return k2_bisect_plain(variant, plan, table, g_u, rows_u, item_block,
                               item_row0, item_u, lr)
    scratch = torch.empty((2, max(plan.num_blocks, 1)), dtype=torch.int32,
                          device=dev)
    _launch("k2_bisect", dev, int(variant[1:]), table.data_ptr(),
            g_u.data_ptr(), rows_u.data_ptr(), item_block.data_ptr(),
            item_row0.data_ptr(), item_u.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), m, plan.u_total, plan.num_blocks,
            plan.block_rows, d, float(lr))
    return table


# ------------------------------------------------------ feasibility (P6)
def t2_contract_plain(a, b) -> torch.Tensor:
    return a.reshape(-1, a.shape[-1]).T @ b.reshape(-1, b.shape[-1])


def t2_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum("slr,sld->rd", a, b) in fp32: a [S, L, R], b [S, L, C]."""
    _check("a", a, _F32)
    _check("b", b, _F32)
    if a.dim() != 3 or b.dim() != 3 or a.shape[:2] != b.shape[:2]:
        raise ValueError(f"a [S, L, R] and b [S, L, C] must share S and L, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    dev = _device("t2_contract", a, b)
    if dev.type == "cpu":
        return t2_contract_plain(a, b)
    k, r, c = a.shape[0] * a.shape[1], a.shape[2], b.shape[2]
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    _launch("t2_contract", dev, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            k, r, c)
    return out


def t3_reshape_add_plain(x) -> torch.Tensor:
    return x.reshape(-1).reshape(x.shape) + 1


def t3_reshape_add(x: torch.Tensor) -> torch.Tensor:
    """x [rows, cols] int32 -> x.reshape(-1).reshape(rows, cols) + 1."""
    _check("x", x, _I32)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    dev = _device("t3_reshape_add", x)
    if dev.type == "cpu":
        return t3_reshape_add_plain(x)
    out = torch.empty_like(x)
    _launch("t3_reshape_add", dev, x.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1])
    return out


def t4_onehot_accumulate_plain(idx, g, rows: int) -> torch.Tensor:
    out = torch.zeros((rows, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, idx.reshape(-1).long(), g)


def t4_onehot_accumulate(idx: torch.Tensor, g: torch.Tensor,
                         rows: int) -> torch.Tensor:
    """out [rows, d] with out[r] = sum of g[c] over the c with idx[c] == r
    (T4's one-hot matmul oh.T @ g); on the card summed in index order."""
    _check("idx", idx, _I32)
    cap = idx.numel()
    _check("g", g, _F32)
    if g.dim() != 2 or g.shape[0] != cap:
        raise ValueError(f"g must be [{cap}, d], got {tuple(g.shape)}")
    dev = _device("t4_onehot_accumulate", idx, g)
    if dev.type == "cpu":
        return t4_onehot_accumulate_plain(idx, g, rows)
    out = torch.empty((rows, g.shape[1]), dtype=torch.float32, device=dev)
    _launch("t4_onehot_accumulate", dev, idx.data_ptr(), g.data_ptr(), cap,
            g.shape[1], rows, out.data_ptr())
    return out


def t6_revolve_accumulate_plain(x, steps: int, block_rows: int):
    xv = x.view(-1, steps, block_rows, x.shape[1])
    out = torch.zeros_like(xv[:, 0])
    for j in range(steps):
        out = out + xv[:, j]
    return out.reshape(-1, x.shape[1])


def t6_revolve_accumulate(x: torch.Tensor, steps: int,
                          block_rows: int) -> torch.Tensor:
    """x [nb * steps * block_rows, d] -> out [nb * block_rows, d]: out
    block k = x block k*steps + 0 + ... + x block k*steps + steps-1, added
    in that order from 0 (T6's output block carried across grid steps)."""
    _check("x", x, _F32)
    if x.dim() != 2 or steps <= 0 or block_rows <= 0 or x.shape[0] % (
            steps * block_rows):
        raise ValueError(f"x of shape {tuple(x.shape)} is not whole groups "
                         f"of {steps} blocks of {block_rows} rows")
    dev = _device("t6_revolve_accumulate", x)
    if dev.type == "cpu":
        return t6_revolve_accumulate_plain(x, steps, block_rows)
    nb = x.shape[0] // (steps * block_rows)
    out = torch.empty((nb * block_rows, x.shape[1]), dtype=torch.float32,
                      device=dev)
    _launch("t6_revolve_accumulate", dev, x.data_ptr(), out.data_ptr(), nb,
            steps, block_rows * x.shape[1])
    return out
