"""Mixed-dimension assignment solver (numpy; host-side). The port's copy of
dlrm_tpu/ops/md_solver.py.

Same alpha-power temperature heuristic as tricks/md_embedding_bag.py:22-63:
sort tables by row count, assign dim_i = lambda * n_i^(-alpha) with lambda
anchored so the smallest table keeps the base dim d0 (or to a parameter budget
B), optionally round to powers of two, then undo the sort.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def alpha_power_rule(
    n: np.ndarray, alpha: float, d0: Optional[float] = None, B: Optional[float] = None
) -> np.ndarray:
    n = n.astype(np.float64)
    if d0 is not None:
        lamb = d0 * (n[0] ** alpha)
    elif B is not None:
        lamb = B / np.sum(n ** (1 - alpha))
    else:
        raise ValueError("Must specify either d0 or B")
    d = lamb * (n**-alpha)
    for i in range(len(d)):
        if i == 0 and d0 is not None:
            d[i] = d0
        elif d[i] < 1:
            d[i] = 1
    return np.round(d).astype(np.int64)


def pow_2_round(dims: np.ndarray) -> np.ndarray:
    return (2 ** np.round(np.log2(dims.astype(np.float64)))).astype(np.int64)


def md_solver(
    table_sizes: Sequence[int],
    alpha: float,
    d0: Optional[float] = None,
    B: Optional[float] = None,
    round_dim: bool = True,
    k: Optional[Sequence[float]] = None,
) -> Tuple[int, ...]:
    n = np.asarray(table_sizes, dtype=np.int64)
    order = np.argsort(n, kind="stable")
    n_sorted = n[order]
    kv = np.asarray(k, dtype=np.float64)[order] if k is not None else np.ones(len(n))
    d = alpha_power_rule(n_sorted.astype(np.float64) / kv, alpha, d0=d0, B=B)
    if round_dim:
        d = pow_2_round(d)
    undo = np.empty_like(order)
    undo[order] = np.arange(len(order))
    return tuple(int(x) for x in d[undo])
