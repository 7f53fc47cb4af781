"""ctypes binding for the native stream-work builder (stream_work.cc).

The port's copy of dlrm_tpu/native/stream_native.py. Fast path for
ops/stream_plan.build_stream_work: same plan geometry, same outputs, except
intra-run slot order (the numpy path row-sorts each block's run; the native
path fills in scan order, and no kernel depends on it). Built with g++ at
first use into the package's build directory; where no compiler is present,
available() is False and build_stream_work takes the numpy path.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from typing import Optional

import numpy as np

from dlrm_tpu_torch.buildlib import build_shared

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        path = build_shared(
            "stream_work", ["native/stream_work.cc"],
            ["g++", "-O3", "-std=c++17", "-fPIC",
             "-shared", "-pthread"],
        )
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
    fn = lib.build_stream_work_native
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I32P, _F32P,
        ctypes.POINTER(ctypes.c_int64),  # per-table base offsets
        ctypes.c_int64,  # row stride
        ctypes.c_int32, ctypes.c_int32,
        _I32P,  # per-table hot sizes
        _I32P,  # per-table u budgets (-1 = unbudgeted)
        ctypes.c_int32,
        _I32P, _I32P, _I32P,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,  # write_wts
        _I32P, _I32P, _F32P, _I32P,
        _I32P, _I32P, _I32P,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def build_stream_work_native(plan, idx: np.ndarray,
                             wt: Optional[np.ndarray] = None,
                             skip_wts: bool = False):
    """Native twin of ops/stream_plan.build_stream_work. Returns a
    StreamWork (imported lazily to avoid a circular import)."""
    from dlrm_tpu_torch.ops.stream_plan import StreamWork

    lib = _load()
    if lib is None:
        raise RuntimeError("the native stream-work builder did not build")
    t_ = len(plan.hot)
    if wt is not None and not skip_wts and wt.shape != idx.shape:
        # full-shape check, not just ndim: two padded 3-D arrays with
        # different Hmax would share a row_stride derived from idx alone
        # and misaddress wt
        raise ValueError(
            f"native builder needs idx and wt in the SAME layout (one "
            f"t_off/row_stride addresses both); got idx.shape={idx.shape} "
            f"wt.shape={wt.shape} — use the numpy path for mixed layouts"
        )
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    wt_arr = (
        None if wt is None else np.ascontiguousarray(wt, dtype=np.float32)
    )
    if idx.ndim == 3:  # padded [T, B, Hmax]
        _, b_, h_ = idx.shape
        t_off = np.arange(t_, dtype=np.int64) * (b_ * h_)
        row_stride = h_
    else:  # flat [B, sum_t hot[t]] — the materialized on-disk layout
        b_, total = idx.shape
        t_off = plan.hot_col0  # the flat addressing contract, defined once
        row_stride = total
    hot = np.asarray(plan.hot, dtype=np.int32)
    budgets = np.asarray(
        plan.u_budget if plan.u_budget else (-1,) * t_, dtype=np.int32
    )
    if (wt_arr is None or skip_wts) and np.any(
        (budgets >= 0) & (budgets < b_ * hot.astype(np.int64))
    ):
        raise ValueError(
            "u_budget-ed tables drop weight-0 hits and need real weights; "
            "got wt=None/skip_wts (unit-weight batches cannot be budgeted)"
        )
    u_base = np.asarray(plan.u_base, dtype=np.int32)
    block_base = np.asarray(plan.block_base, dtype=np.int32)
    nblks = np.asarray(plan.blocks_per_table, dtype=np.int32)
    rows_u = np.empty(plan.u_total, dtype=np.int32)
    vals_u = np.empty(plan.u_total, dtype=np.int32)
    wts_u = None if skip_wts else np.empty(plan.u_total, dtype=np.float32)
    w2t = np.empty(plan.num_windows, dtype=np.int32)
    m = plan.max_items
    item_block = np.empty(m, dtype=np.int32)
    item_row0 = np.empty(m, dtype=np.int32)
    item_u = np.empty(m, dtype=np.int32)

    n = lib.build_stream_work_native(
        idx.ctypes.data_as(_I32P),
        None if wt_arr is None else wt_arr.ctypes.data_as(_F32P),
        t_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        row_stride,
        t_, b_,
        hot.ctypes.data_as(_I32P),
        budgets.ctypes.data_as(_I32P),
        plan.block_rows,
        u_base.ctypes.data_as(_I32P),
        block_base.ctypes.data_as(_I32P),
        nblks.ctypes.data_as(_I32P),
        plan.u_size, plan.u_total, plan.num_blocks,
        m, plan.num_windows,
        0 if skip_wts else 1,
        rows_u.ctypes.data_as(_I32P),
        vals_u.ctypes.data_as(_I32P),
        None if skip_wts else wts_u.ctypes.data_as(_F32P),
        w2t.ctypes.data_as(_I32P),
        item_block.ctypes.data_as(_I32P),
        item_row0.ctypes.data_as(_I32P),
        item_u.ctypes.data_as(_I32P),
    )
    if n <= -100:
        t_over = int(-n) - 100
        raise ValueError(
            f"table {t_over}: nonzero-weight hits exceed u_budget "
            f"{int(budgets[t_over])} — widen the budget margin"
        )
    if n < 0:
        raise AssertionError(f"items > static bound {m}")
    return StreamWork(
        rows_u=rows_u.reshape(-1, 8, 128),
        vals_u=vals_u.reshape(-1, 8, 128),
        wts_u=None if skip_wts else wts_u.reshape(-1, 8, 128),
        w2t=w2t,
        item_block=item_block,
        item_row0=item_row0,
        item_u=item_u,
        num_real_items=int(n),
    )
