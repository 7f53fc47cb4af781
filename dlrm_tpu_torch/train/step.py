"""Train and eval steps by plain autograd over the whole params tree (the
port of dlrm_tpu/train/step.py, the single-device dense path).

The table takes its dense [rows, d] gradient, as the JAX package
materializes it (the backward of F.embedding_bag, where JAX's is the
scatter-add of its gather), and every leaf then takes the optimizer
(optim/optimizers.py: row-wise for the table under rwsadagrad). This is the
path of configurations the fused step does not take: pooling weights v_w
(learned: they train; fixed: detached, their zero gradient leaves them as
they are under every optimizer) and --embedding_impl dense.

A batch comes in the padded [T, B, H] layout (every column pooled, the JAX
step's semantics) or, given hot_sizes, in the flat per-hit layout. Params
and opt_state update IN PLACE and are returned. The step never waits on
the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import (
    ADAGRAD_EPS,
    apply_updates,
    tree_leaves,
    tree_map,
)


def _grads(model: DLRMModel, params, batch: Batch, hot_sizes):
    """(loss, probs, grads of the params tree). A leaf the loss does not
    reach (v_w under "fixed") gets a zero gradient, as JAX's
    stop_gradient gives it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, probs = model.loss_and_prob(leaves, batch, hot_sizes)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return loss.detach(), probs.detach(), tree_map(lambda _: next(it),
                                                   leaves)


def make_train_step(model: DLRMModel, optimizer: str, eps: float = None,
                    hot_sizes: Optional[Sequence[int]] = None):
    """train_step(params, opt_state, batch, lr) -> (params, opt_state, loss,
    probs), in place; opt_state from optim.optimizers.init_opt_state."""
    eps = ADAGRAD_EPS if eps is None else float(eps)

    def train_step(params, opt_state, batch: Batch, lr: float):
        loss, probs, grads = _grads(model, params, batch, hot_sizes)
        apply_updates(optimizer, params, grads, opt_state.get("accum"), lr,
                      eps=eps)
        opt_state["step"] += 1
        return params, opt_state, loss, probs

    return train_step


def make_eval_step(model: DLRMModel,
                   hot_sizes: Optional[Sequence[int]] = None):
    """eval_step(params, batch) -> probs [B, 1]."""

    @torch.no_grad()
    def eval_step(params, batch: Batch):
        return model.apply(params, batch, hot_sizes)

    return eval_step


def make_grad_accum_train_step(
    model: DLRMModel, optimizer: str, accum_iters: int, eps: float = None,
    hot_sizes: Optional[Sequence[int]] = None,
):
    """Gradient accumulation (--mlperf-grad-accum-iter,
    dlrm_s_pytorch.py:1604-1621): the micro-batches arrive stacked on a
    leading axis; their grads are summed from zero, meaned over the
    accum_iters (the JAX package's deliberate LR-invariant scaling,
    PARITY.md) and applied in one optimizer step. Returns the mean loss and
    None for probs."""
    eps = ADAGRAD_EPS if eps is None else float(eps)

    def train_step(params, opt_state, batches: Batch, lr: float):
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        losses = []
        for i in range(batches.dense.shape[0]):
            mb = Batch(batches.dense[i], batches.idx[i],
                       None if batches.wt is None else batches.wt[i],
                       batches.labels[i])
            loss, _, grads = _grads(model, params, mb, hot_sizes)
            gsum = tree_map(torch.add, gsum, grads)
            losses.append(loss)
        grads = tree_map(lambda g: g / accum_iters, gsum)
        apply_updates(optimizer, params, grads, opt_state.get("accum"), lr,
                      eps=eps)
        opt_state["step"] += 1
        return params, opt_state, torch.stack(losses).mean(), None

    return train_step
