"""The one traffic generator: a pool of host batches in the DLRM-v2
multi-hot layout, drawn from the seed, with the parameters of a traffic
file (port_bench/traffic/<mix>.json):

  batch       samples a batch
  pool        distinct batches; a loop cycles through them
  hot_dist    "uniform": every hit drawn i.i.d. uniform over its table's
              rows (the distribution torchrec_dlrm's uniform multi-hot
              synthesizer gives over a uniform one-hot base);
              "pareto": in a table with hot > 1 the first hit uniform and
              the other hot - 1 Pareto(a), cast to int32 and taken modulo
              the rows (torchrec_dlrm/multi_hot.py's pareto type), i.i.d.
              per hit
  pareto_a    the Pareto shape (hot_dist "pareto")
  click_rate  the share of labels that are 1

A batch is {"dense" float32 [B, D] (standard normal), "idx" int32
[B, sum(hot)] (table t's hits in columns col0[t] .. col0[t] + hot[t], the
materialized multi-hot format), "labels" float32 [B, 1]}. Batch i of a pool
comes from its own stream, SeedSequence([seed, i]), so every seed gives the
same sizes and the same amount of work. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def draw_batch(traffic: dict, table_sizes: Sequence[int],
               hot_sizes: Sequence[int], num_dense: int,
               seed: int, i: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(i)]))
    b = int(traffic["batch"])
    dist = traffic["hot_dist"]
    if dist not in ("uniform", "pareto"):
        raise ValueError(f"hot_dist {dist!r} not supported")
    idx = np.empty((b, int(sum(hot_sizes))), np.int32)
    col = 0
    for n, h in zip(table_sizes, hot_sizes):
        n, h = int(n), int(h)
        if dist == "uniform" or h == 1:
            idx[:, col: col + h] = rng.integers(0, n, (b, h), dtype=np.int64)
        else:
            idx[:, col] = rng.integers(0, n, b, dtype=np.int64)
            with np.errstate(invalid="ignore"):
                draws = rng.pareto(float(traffic["pareto_a"]),
                                   (b, h - 1)).astype(np.int32)
            idx[:, col + 1: col + h] = draws.astype(np.int64) % n
        col += h
    dense = rng.standard_normal((b, num_dense), dtype=np.float32)
    labels = (rng.random((b, 1)) < float(traffic["click_rate"])).astype(
        np.float32)
    return {"dense": dense, "idx": idx, "labels": labels}


def pool(traffic: dict, table_sizes: Sequence[int],
         hot_sizes: Sequence[int], num_dense: int,
         seed: int) -> List[Dict[str, np.ndarray]]:
    return [draw_batch(traffic, table_sizes, hot_sizes, num_dense, seed, i)
            for i in range(int(traffic["pool"]))]
