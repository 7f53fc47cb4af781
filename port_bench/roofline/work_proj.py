"""The operations and bytes the yardstick counts for torchrec's
DLRM_Projection (configuration key "interaction" "projection"), as
roofline/work.py counts them for DLRM-v2 DCN, with its peaks.

Operations are the model's matrix products, 2 per multiply-add: the bottom
tower, the two branches (each torchrec's MLP over the F D features), the
bmm of Y [F1, D] and Z [D, F2] (F1 F2 D multiply-adds a sample) and the top
tower; in training the backward's two products a product (the gradient of
each operand), less the input gradient of the first bottom layer, which
nothing needs. The interaction's share (interaction_flops) is the branches
and the bmm, forward and backward. Bytes are work.py's: every distinct
table row the batch touches read and written with its row accumulator, the
batch, the dense parameters with their accumulators.
"""

from __future__ import annotations

from typing import List, Tuple

from port_bench.roofline.work import PEAK_BYTES, PEAK_FLOPS_BF16, share

__all__ = ["PEAK_BYTES", "PEAK_FLOPS_BF16", "branch_layers", "dense_params",
           "interaction_flops", "layers", "model_flops", "share",
           "step_bytes"]


def _pairs(sizes) -> List[Tuple[int, int]]:
    return list(zip(sizes[:-1], sizes[1:]))


def _widths(model: dict) -> Tuple[int, int, int]:
    """(D, F1, F2)."""
    d = model["embedding_dim"]
    return (d, model["interaction_branch1_layer_sizes"][-1] // d,
            model["interaction_branch2_layer_sizes"][-1] // d)


def branch_layers(model: dict) -> List[Tuple[int, int]]:
    """The two branches' (n_in, n_out) a sample, branch 1 first."""
    fd = model["embedding_dim"] * (len(model["table_sizes"]) + 1)
    return (_pairs([fd] + list(model["interaction_branch1_layer_sizes"]))
            + _pairs([fd] + list(model["interaction_branch2_layer_sizes"])))


def layers(model: dict) -> List[Tuple[int, int]]:
    """Every tower and branch product's (n_in, n_out) a sample, in forward
    order: the bottom tower, the branches, the top tower (input D + F1 F2);
    the bmm is not a layer."""
    d, f1, f2 = _widths(model)
    return (_pairs(list(model["mlp_bot"])) + branch_layers(model)
            + _pairs([d + f1 * f2] + list(model["mlp_top"])))


def dense_params(model: dict) -> int:
    """Weights and biases of the towers and branches."""
    return sum(i * o + o for i, o in layers(model))


def _bmm(model: dict) -> int:
    d, f1, f2 = _widths(model)
    return 2 * f1 * f2 * d


def interaction_flops(model: dict, batch: int, train: bool) -> int:
    fwd = sum(2 * i * o for i, o in branch_layers(model)) + _bmm(model)
    return (3 if train else 1) * fwd * batch


def model_flops(model: dict, batch: int, train: bool) -> int:
    ls = layers(model)
    fwd = sum(2 * i * o for i, o in ls) + _bmm(model)
    if not train:
        return fwd * batch
    i0, o0 = ls[0]
    return (3 * fwd - 2 * i0 * o0) * batch


def step_bytes(model: dict, batch: int, distinct_rows: int, train: bool,
               row_bytes: int) -> int:
    """Bytes a step must move, as work.step_bytes counts them."""
    hits = batch * sum(model["hot_sizes"])
    inputs = hits * 4 + batch * (model["mlp_bot"][0] * 4 + 4)
    params = dense_params(model) * 4
    if train:
        return distinct_rows * (2 * row_bytes + 2 * 4) + inputs + params * 4
    return distinct_rows * row_bytes + inputs + params
