"""The operations and bytes the yardstick counts, and the card's published
peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W
power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3. A share is the least
time the card could take (the larger of operations over the FLOP peak and
bytes over the byte peak) over the time measured; which of the two bounds
it is reported beside it, with the card's power limit.

Operations are the model's matrix products, 2 per multiply-add: the forward
of every tower and cross layer, and in training the backward's two products
a layer (the input's gradient and the weight's), less the input gradient of
the first bottom layer, which nothing needs. Bytes are what a step must move
once: every distinct table row the batch touches read (and in training
written, with its row accumulator), the batch's indices, dense features and
labels, and the dense parameters (in training with their accumulators, each
read and written). A row is never counted once a hit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12


def layers(model: dict) -> List[Tuple[int, int]]:
    """Every product's (n_in, n_out) a sample, in forward order: the
    bottom tower, then V and W of each cross layer, then the top tower."""
    d = model["embedding_dim"]
    bot = list(model["mlp_bot"])
    n = bot[-1] + d * len(model["table_sizes"])
    top = [n] + list(model["mlp_top"])
    r = model["dcn_low_rank_dim"]
    out = list(zip(bot[:-1], bot[1:]))
    for _ in range(model["dcn_num_layers"]):
        out += [(n, r), (r, n)]
    return out + list(zip(top[:-1], top[1:]))


def dense_params(model: dict) -> int:
    """Weights and biases of the towers and cross layers."""
    n = sum(i * o + o for i, o in layers(model))
    # a cross layer has one bias [n] for its two products: the (n, r)
    # product's bias of r counted above does not exist
    return n - model["dcn_num_layers"] * model["dcn_low_rank_dim"]


def model_flops(model: dict, batch: int, train: bool) -> int:
    ls = layers(model)
    fwd = sum(2 * i * o for i, o in ls)
    if not train:
        return fwd * batch
    i0, o0 = ls[0]
    return (3 * fwd - 2 * i0 * o0) * batch


def step_bytes(model: dict, batch: int, distinct_rows: int, train: bool,
               row_bytes: int) -> int:
    """Bytes a step must move: row_bytes a table row (its dtype's), 4 more
    for a row accumulator in training."""
    hits = batch * sum(model["hot_sizes"])
    inputs = hits * 4 + batch * (model["mlp_bot"][0] * 4 + 4)
    params = dense_params(model) * 4
    if train:
        return distinct_rows * (2 * row_bytes + 2 * 4) + inputs + params * 4
    return distinct_rows * row_bytes + inputs + params


def k2_bytes(hits: int, item_slots: int, items: int, touched: int, d: int,
             g_bytes: int, table_bytes: int) -> int:
    """K2 (csrc/stream_update.cu) on the touched-only item list: each real
    hit's G row read; rows_u read over the items' slots; the three item
    arrays read; each touched row's table row and float32 row accumulator
    read and written."""
    return (hits * d * g_bytes + item_slots * 4 + items * 12
            + touched * (2 * d * table_bytes + 2 * 4))


def share(flops: float, nbytes: float, seconds: float) -> Dict[str, object]:
    """The least time over `seconds`, in %, and which peak bounds it."""
    t_flops = flops / PEAK_FLOPS_BF16
    t_bytes = nbytes / PEAK_BYTES
    return {"pct": 100.0 * max(t_flops, t_bytes) / seconds,
            "bound_by": "flops" if t_flops >= t_bytes else "bytes"}
