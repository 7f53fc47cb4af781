"""The weights every cell makes from its seed, on the card, in a few large
calls and in the dtype they are trained or served in. The program gets them
as its inputs, and the reference reads the same ones (the dense parameters,
the table rows a batch touches, the int8 bytes), never what the program
derived from them.

  dense parameters  the towers' W ~ N(0, sqrt(2 / (n_in + n_out))) and
                    b ~ N(0, sqrt(1 / n_out)) (the reference DLRM's init),
                    each cross layer's V [r, n] and W [n, r] Xavier-uniform
                    and its b [n] zero (torchrec's LowRankCrossNet), fp32
  training tables   table t's rows U(-sqrt(1 / n_t), sqrt(1 / n_t)) (the
                    reference DLRM's init), drawn straight into the table
                    dtype in the padded layout of the streamed step: each
                    table starts at a multiple of block_rows, the rows
                    between tables and one trailing block are zero
  int8 tables       row-wise int8 rows [data bytes | fp32 scale | fp32
                    bias] with random data bytes and one scale and bias for
                    every row, so that rows decode to [-amplitude,
                    amplitude] (the fill of dlrm_tpu_torch/probes/
                    serve_flagship.py, at a trained table's scale)

Every draw has a torch.Generator of its own on the device, seeded from
(seed, purpose[, table]), so a seed gives the same weights on one device
whatever else the run does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

DENSE, TABLES, INT8 = 1, 2, 3
FILL_ROWS = 1 << 24  # rows an int8 fill writes at once


def generator(dev, seed: int, *purpose: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), *purpose]).generate_state(
        1, np.uint64)[0] >> 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(state))
    return gen


def padded_layout(table_sizes: Sequence[int],
                  block_rows: int) -> Tuple[List[int], int]:
    """(each table's first row, rows in all): tables start at multiples of
    block_rows, and one trailing block follows the last."""
    offs, acc = [], 0
    for n in table_sizes:
        offs.append(acc)
        acc += max(1, -(-int(n) // block_rows)) * block_rows
    return offs, acc + block_rows


def draw_dense(model: dict, seed: int, dev) -> Dict[str, list]:
    gen = generator(dev, seed, DENSE)
    d = model["embedding_dim"]
    n = model["mlp_bot"][-1] + d * len(model["table_sizes"])
    r = model["dcn_low_rank_dim"]

    def tower(sizes):
        out = []
        for i, o in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((i, o), generator=gen, device=dev)
            b = torch.randn((o,), generator=gen, device=dev)
            out.append({"w": w * math.sqrt(2.0 / (i + o)),
                        "b": b * math.sqrt(1.0 / o)})
        return out

    def xavier(shape):
        a = math.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.empty(shape, device=dev).uniform_(-a, a, generator=gen)

    return {
        "bot": tower(list(model["mlp_bot"])),
        "dcn": [{"v": xavier((r, n)), "w": xavier((n, r)),
                 "b": torch.zeros((n,), device=dev)}
                for _ in range(model["dcn_num_layers"])],
        "top": tower([n] + list(model["mlp_top"])),
    }


def draw_tables(table_sizes: Sequence[int], offsets: Sequence[int],
                rows: int, d: int, dtype, seed: int, dev) -> torch.Tensor:
    table = torch.empty((rows, d), dtype=dtype, device=dev)
    end = 0
    for t, (off, n) in enumerate(zip(offsets, table_sizes)):
        table[end:off].zero_()
        bound = math.sqrt(1.0 / n)
        table[off: off + n].uniform_(-bound, bound,
                                     generator=generator(dev, seed, TABLES, t))
        end = off + n
    table[end:].zero_()
    return table


def fill_int8(rows: int, d: int, amplitude: float, seed: int,
              dev) -> torch.Tensor:
    packed = torch.empty((rows, d + 8), dtype=torch.uint8, device=dev)
    gen = generator(dev, seed, INT8)
    for start in range(0, rows, FILL_ROWS):
        packed[start: start + FILL_ROWS, :d].random_(0, 256, generator=gen)
    scale_bias = np.array([2.0 * amplitude / 255.0, -amplitude], np.float32)
    packed[:, d:] = torch.from_numpy(scale_bias.view(np.uint8)).to(dev)
    return packed
