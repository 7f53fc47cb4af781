"""Train step with the sparse optimizer update fused into the backward (the
port of dlrm_tpu/train/fused_step.py; torchrec's
apply_optimizer_in_backward with FBGEMM's EXACT_* kernels,
torchrec_dlrm/dlrm_main.py:649-653).

The table gradient is never materialized densely. The step differentiates
the dense network with respect to the POOLED embeddings [B, T, d]; the
chain rule through the weighted sum-pool is applied hit by hit, coalesced
per touched row (ops/sparse_update.py: sort, then the coalesce_rows
kernel) and added into the table in place by the row_scatter_add kernel:
O(touched rows) of device traffic instead of O(table rows).

Tables are fp32, as on the JAX package's fused branch. A batch comes in
the padded [T, B, H] layout (every column of every table pooled and
updated, the JAX step's semantics) or, given the per-table hot_sizes, in
the flat per-hit layout, which the trainer ships: at the v2 hot sizes a
padded batch of 16,384 holds 42.6 M slots for 3.5 M real hits. Padding
weighs 0, so both layouts give the same parameters to the bit.

Everything updates IN PLACE, where the JAX step donates its buffers: the
step returns the same params and opt_state objects it was given. The step
never waits on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.ops.embedding import grouped_embedding_bag, to_flat
from dlrm_tpu_torch.ops.sparse_update import (
    adagrad_from_coalesced,
    coalesce_hits,
    rowwise_adagrad_from_coalesced,
    sgd_from_coalesced,
)
from dlrm_tpu_torch.optim.optimizers import (
    ADAGRAD_EPS,
    apply_updates,
    tree_map,
)


def supports_fused(model: DLRMModel) -> bool:
    """Plain stacked tables without pooling weights."""
    return model.fused and model.cfg.weighted_pooling is None


def _check(model: DLRMModel, optimizer: str) -> None:
    if not supports_fused(model):
        raise ValueError(
            "the fused sparse step needs plain uniform-width tables without "
            "pooling weights; use dlrm_tpu_torch.train.step.make_train_step"
        )
    if optimizer not in ("sgd", "rwsadagrad", "adagrad"):
        raise ValueError(f"optimizer {optimizer!r} not supported")


def _hots(batch: Batch, hot_sizes) -> tuple:
    if hot_sizes is not None:
        return tuple(int(h) for h in hot_sizes)
    if batch.idx.dim() != 3:
        raise ValueError("the flat per-hit layout needs hot_sizes")
    return (batch.idx.shape[2],) * batch.idx.shape[0]


def _update_table(optimizer, emb, accum, dly, idx, wt, offsets, hots, lr,
                  eps):
    """The fused sparse update of the stacked table (and its accumulator)."""
    urows, G, valid = coalesce_hits(dly, idx, wt, offsets, emb.shape[0],
                                    hot_sizes=hots)
    if optimizer == "sgd":
        sgd_from_coalesced(emb, urows, G, valid, lr)
    elif optimizer == "rwsadagrad":
        rowwise_adagrad_from_coalesced(emb, accum, urows, G, valid, lr,
                                       eps=eps)
    else:
        adagrad_from_coalesced(emb, accum, urows, G, valid, lr, eps=eps)


def _split_state(opt_state):
    accum = opt_state.get("accum")
    if accum is None:
        return None, None
    return ({k: v for k, v in accum.items() if k != "emb"},
            accum["emb"]["stacked"])


def make_fused_train_step(model: DLRMModel, optimizer: str,
                          eps: float = None,
                          hot_sizes: Optional[Sequence[int]] = None):
    """train_step(params, opt_state, batch, lr) -> (params, opt_state, loss,
    probs), in place. eps: the Adagrad denominator epsilon (None -> the
    torch default 1e-10; the v2 trainer's --eps passes 1e-8). hot_sizes:
    the per-table hot sizes, needed for flat batches."""
    _check(model, optimizer)
    eps = ADAGRAD_EPS if eps is None else float(eps)

    def train_step(params, opt_state, batch: Batch, lr: float):
        emb = params["emb"]["stacked"]
        offsets = model.offsets(emb.device)
        hots = _hots(batch, hot_sizes)
        b = batch.dense.shape[0]
        dense = {k: v for k, v in params.items() if k != "emb"}
        with torch.no_grad():
            pooled = grouped_embedding_bag(emb, offsets, batch.idx, batch.wt,
                                           hots, batch=b)
        loss, probs, grads, dly = model.grads_from_pooled(dense, batch, pooled)
        dense_accum, emb_accum = _split_state(opt_state)
        with torch.no_grad():
            apply_updates(optimizer, dense, grads, dense_accum, lr, eps=eps)
            _update_table(optimizer, emb, emb_accum, dly, batch.idx,
                          batch.wt, offsets, hots, lr, eps)
        opt_state["step"] += 1
        return params, opt_state, loss, probs

    return train_step


def make_fused_grad_accum_train_step(
    model: DLRMModel, optimizer: str, accum_iters: int, eps: float = None,
    hot_sizes: Optional[Sequence[int]] = None,
):
    """Gradient accumulation composed with the fused sparse update: the
    micro-batches arrive stacked on a leading axis (every field of the
    Batch [accum_iters, ...]); the dense grads are meaned over them while
    the pooled cotangents of ALL micro-batches coalesce into ONE sparse
    update, so the accumulator advances once per optimizer step and
    Adagrad's semantics match one large batch. The JAX package's
    mean-over-accum scaling (PARITY.md). Returns the micro-batches' mean
    loss and None for probs."""
    _check(model, optimizer)
    eps = ADAGRAD_EPS if eps is None else float(eps)

    def train_step(params, opt_state, batches: Batch, lr: float):
        emb = params["emb"]["stacked"]
        offsets = model.offsets(emb.device)
        a = batches.dense.shape[0]
        b = batches.dense.shape[1]
        dense = {k: v for k, v in params.items() if k != "emb"}
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        dense)
        losses, dlys, flats = [], [], []
        for i in range(a):
            mb = Batch(batches.dense[i], batches.idx[i],
                       None if batches.wt is None else batches.wt[i],
                       batches.labels[i])
            hots = _hots(mb, hot_sizes)
            with torch.no_grad():
                pooled = grouped_embedding_bag(emb, offsets, mb.idx, mb.wt,
                                               hots, batch=b)
            loss, _, grads, dly = model.grads_from_pooled(dense, mb, pooled)
            gsum = tree_map(torch.add, gsum, grads)
            losses.append(loss)
            dlys.append(dly)
            flats.append(to_flat(mb.idx, mb.wt, hots, b))
        grads = tree_map(lambda g: g / accum_iters, gsum)
        dense_accum, emb_accum = _split_state(opt_state)
        # every micro-batch's hits as one flat batch of a*b samples: table
        # t's block holds micro-batch 0's hits, then 1's, ...
        idx_all, wt_all = [], []
        for t, h in enumerate(hots):
            lo = sum(b * hh for hh in hots[:t])
            idx_all += [f[0][lo: lo + b * h] for f in flats]
            if batches.wt is not None:
                wt_all += [f[1][lo: lo + b * h] for f in flats]
        dly_all = torch.cat(dlys, dim=0) / accum_iters  # [a*b, T, d]
        with torch.no_grad():
            apply_updates(optimizer, dense, grads, dense_accum, lr, eps=eps)
            _update_table(optimizer, emb, emb_accum, dly_all,
                          torch.cat(idx_all),
                          torch.cat(wt_all) if wt_all else None,
                          offsets, hots, lr, eps)
        opt_state["step"] += 1
        return params, opt_state, torch.stack(losses).mean(), None

    return train_step
