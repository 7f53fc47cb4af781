"""ctypes binding for the native Criteo preprocessor (criteo_preproc.cc).

The port's copy of dlrm_tpu/native/criteo_native.py. The library is built
with g++ at first use into the package's build directory
(dlrm_tpu_torch/build/, under a name that carries a hash of the source);
where no compiler is present, available() is False and data/criteo.py takes
the numpy parser.

The native subsampler draws from xorshift64*, the numpy parser from MT19937:
with sub_sample_rate > 0 the two keep different (equally random) rows. Every
other output is bit-identical.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from typing import Dict, Optional

import numpy as np

from dlrm_tpu_torch.buildlib import build_shared

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        path = build_shared(
            "criteo_native", ["native/criteo_preproc.cc"],
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"],
        )
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
    lib.criteo_count_rows.restype = ctypes.c_int64
    lib.criteo_count_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_uint64,
    ]
    lib.criteo_parse.restype = ctypes.c_int64
    lib.criteo_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_uint64, ctypes.c_int64,
        _I32P, _I32P, _I64P, ctypes.c_int64,
    ]
    lib.criteo_write_bin.restype = ctypes.c_int64
    lib.criteo_write_bin.argtypes = [
        ctypes.c_char_p, _I32P, _I32P, _I32P, ctypes.c_int64,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native Criteo parser did not build")
    return lib


def parse_raw_day(
    path: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    seed: int = 123,
) -> Dict[str, np.ndarray]:
    """One raw tsv day -> {"y" [n] i32, "X_int" [n, 13] i32, "X_cat" [n, 26]
    i64}: two passes over the file, counting the kept rows, then filling
    buffers of that size (the same seed drops the same rows in both)."""
    lib = _lib()
    bpath = path.encode()
    n = lib.criteo_count_rows(bpath, sub_sample_rate, seed)
    if n < 0:
        raise FileNotFoundError(path)
    y = np.empty(n, dtype=np.int32)
    x_int = np.empty((n, 13), dtype=np.int32)
    x_cat = np.empty((n, 26), dtype=np.int64)
    got = lib.criteo_parse(
        bpath, sub_sample_rate, seed, max_ind_range,
        y.ctypes.data_as(_I32P), x_int.ctypes.data_as(_I32P),
        x_cat.ctypes.data_as(_I64P), n,
    )
    if got != n:
        raise RuntimeError(f"{path}: parsed {got} rows, counted {n}")
    return {"y": y, "X_int": x_int, "X_cat": x_cat}


def write_bin(path: str, y: np.ndarray, x_int: np.ndarray,
              x_cat: np.ndarray) -> int:
    """Append the rows to `path` in the packed int32 record layout [y, 13
    dense, 26 cat]; returns the rows written, or -1."""
    lib = _lib()
    y = np.ascontiguousarray(y, dtype=np.int32)
    x_int = np.ascontiguousarray(x_int, dtype=np.int32)
    x_cat = np.ascontiguousarray(x_cat, dtype=np.int32)
    if x_int.shape != (y.shape[0], 13) or x_cat.shape != (y.shape[0], 26):
        raise ValueError(
            f"write_bin: shapes {y.shape}, {x_int.shape}, {x_cat.shape}")
    return lib.criteo_write_bin(
        path.encode(), y.ctypes.data_as(_I32P), x_int.ctypes.data_as(_I32P),
        x_cat.ctypes.data_as(_I32P), y.shape[0],
    )
