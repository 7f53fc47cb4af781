"""Train and eval steps over the streamed U-layout update (the port of
dlrm_tpu/train/stream_step.py).

One train step:
  1. pooled [B, T, d] outside autograd, then marked requires_grad: the
     autograd region is (dense params, pooled), never the table.
     fwd_impl="gather": grouped_embedding_bag (one F.embedding_bag);
     fwd_impl="stream": K3 stream_rows + K4 window_pool, fp32 [T, B, d]
     transposed (needs the full item list, not the touched-only one);
  2. loss = masked BCE of the dense tower on pooled; one backward gives the
     dense grads and dly = d(loss)/d(pooled);
  3. the dense params take the regular optimizer (optim/optimizers.py);
  4. the table takes the per-hit grads G_u (grad_impl="onehot": K1
     window_grads; "gather": gather_grads) and K2 stream_update.

Everything updates IN PLACE, where the JAX step donates its buffers
(stream_step.py:336) and K2 aliases table and accumulator: the step returns
the same params and opt_state objects it was given, so a caller that wants
to keep the inputs clones them first. The step never waits on the device
(lr and the step counter are host scalars), so the host can build the next
batch while the card works.

Layouts:
  * params["emb"]["stacked"] is the PADDED block-aligned [padded_rows, d]
    table (pad_params);
  * rwsadagrad's row accumulator is packed [padded_rows/128, 128];
  * opt_state = {"step": int, "accum": {...}} with "accum" absent for sgd.
"""

from __future__ import annotations

import torch

from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.device import resolve_device
from dlrm_tpu_torch.models.dlrm import DLRMModel, masked_mean, per_example_loss
from dlrm_tpu_torch.ops.embedding import grouped_embedding_bag
from dlrm_tpu_torch.ops.stream_kernels import (
    gather_grads,
    stream_embedding_fwd,
    stream_update,
    window_grads,
)
from dlrm_tpu_torch.ops.stream_plan import (
    SENTINEL_ROW,
    StreamPlan,
    make_stream_plan,
)
from dlrm_tpu_torch.optim.optimizers import (
    ADAGRAD_EPS,
    apply_updates,
    init_dense_state,
    tree_leaves,
    tree_map,
)

def plan_for_model(model: DLRMModel, batch_size: int,
                   block_rows: int = 2048, hot_sizes=None) -> StreamPlan:
    """hot_sizes: per-table multi-hot sizes (the v2 ragged config); None
    uses the uniform cfg.num_indices_per_lookup."""
    cfg = model.cfg
    if not model.fused:
        raise ValueError("stream step requires plain uniform-width tables")
    return make_stream_plan(
        cfg.table_sizes, cfg.embedding_dim, batch_size,
        cfg.num_indices_per_lookup if hot_sizes is None else hot_sizes,
        block_rows=block_rows,
    )


def pad_params(params, model: DLRMModel, plan: StreamPlan):
    """Repack emb.stacked [total_rows, d] -> padded [plan.padded_rows, d]
    (every table starts at a block boundary). Returns a new dict; the dense
    params are shared, not copied."""
    stacked = params["emb"]["stacked"]
    padded = torch.zeros((plan.padded_rows, stacked.shape[1]),
                         dtype=stacked.dtype, device=stacked.device)
    for t, n in enumerate(plan.table_sizes):
        off = int(model.row_offsets[t])
        po = plan.padded_offsets[t]
        padded[po : po + n] = stacked[off : off + n]
    out = dict(params)
    out["emb"] = {"stacked": padded}
    return out


def unpad_params(params, model: DLRMModel, plan: StreamPlan):
    """Inverse of pad_params."""
    padded = params["emb"]["stacked"]
    stacked = torch.empty((model.total_rows, padded.shape[1]),
                          dtype=padded.dtype, device=padded.device)
    for t, n in enumerate(plan.table_sizes):
        off = int(model.row_offsets[t])
        po = plan.padded_offsets[t]
        stacked[off : off + n] = padded[po : po + n]
    out = dict(params)
    out["emb"] = {"stacked": stacked}
    return out


def cast_emb(params, dtype):
    """Cast the stacked table (e.g. to bfloat16; pair with
    stochastic_round=True in the step)."""
    out = dict(params)
    out["emb"] = {"stacked": params["emb"]["stacked"].to(dtype)}
    return out


def init_stream_opt_state(optimizer: str, params, plan: StreamPlan):
    """Optimizer state with the stream-layout table accumulator."""
    state = {"step": 0}
    if optimizer == "sgd":
        return state
    emb = params["emb"]["stacked"]
    accum = init_dense_state(
        optimizer, {k: v for k, v in params.items() if k != "emb"}
    )
    if optimizer == "rwsadagrad":
        acc = torch.zeros((plan.acc_rows, 128), dtype=torch.float32,
                          device=emb.device)
    elif optimizer == "adagrad":
        acc = torch.zeros(emb.shape, dtype=torch.float32, device=emb.device)
    else:
        raise ValueError(f"optimizer {optimizer!r} not supported")
    accum["emb"] = {"stacked": acc}
    state["accum"] = accum
    return state


def _offsets(plan: StreamPlan, dev) -> torch.Tensor:
    return torch.tensor(plan.padded_offsets, dtype=torch.int32, device=dev)


def make_stream_train_step(
    model: DLRMModel,
    optimizer: str,
    plan: StreamPlan,
    *,
    fwd_impl: str = "gather",  # gather (F.embedding_bag) | stream (K3+K4)
    grad_impl: str = "onehot",  # onehot (K1) | gather (gather_grads)
    mm_dtype=torch.float32,  # K1-K4: round operands to this dtype first
    stochastic_round: bool = False,  # SR the bf16 table writes
    eps: float = None,  # Adagrad epsilon (None -> torch default 1e-10)
    device="cuda",
):
    """train_step(params, opt_state, batch, lr) -> (params, opt_state, loss,
    probs), updating params and opt_state in place (see the module doc)."""
    if fwd_impl not in ("gather", "stream"):
        raise ValueError(f"fwd_impl must be gather|stream, got {fwd_impl!r}")
    if grad_impl not in ("onehot", "gather"):
        raise ValueError(
            f"grad_impl must be onehot|gather, got {grad_impl!r}")
    if optimizer not in ("sgd", "rwsadagrad", "adagrad"):
        raise ValueError(f"optimizer {optimizer!r} not supported")
    model._check_supported()
    cfg = model.cfg
    eps = ADAGRAD_EPS if eps is None else float(eps)
    offsets = _offsets(plan, resolve_device(device))

    def train_step(params, opt_state, batch: Batch, lr: float):
        sw = batch.stream
        if sw is None:
            raise ValueError(
                "batch has no stream work; build it host-side with "
                "HostBatch.with_stream_work(plan)"
            )
        emb = params["emb"]["stacked"]
        wts_u = sw.wts_u
        if wts_u is None:
            # unit-weight batches skip host wts: every real slot weighs 1
            wts_u = (sw.rows_u != SENTINEL_ROW).float()
        dense = {k: v for k, v in params.items() if k != "emb"}
        b = batch.dense.shape[0]

        with torch.no_grad():
            if fwd_impl == "stream":
                if sw.touched_only:
                    raise ValueError(
                        "fwd_impl='stream' needs the full item list (K3 "
                        "must write every slot); build the batch without "
                        "update_touched_only")
                pooled = stream_embedding_fwd(
                    plan, emb, sw.rows_u, sw.vals_u, wts_u, sw.w2t,
                    sw.item_block, sw.item_row0, sw.item_u,
                    mm_dtype=mm_dtype,
                ).transpose(0, 1)
            else:
                pooled = grouped_embedding_bag(
                    emb, offsets, batch.idx, batch.wt, plan.hot, batch=b
                )
        pooled.requires_grad_()
        leaves = tree_map(lambda p: p.detach().requires_grad_(), dense)
        with torch.enable_grad():
            probs, logits = model.forward_from_pooled(
                leaves, batch.dense, pooled
            )
            loss = masked_mean(
                per_example_loss(cfg, probs, batch.labels, logits),
                batch.labels,
            )
            *dgrads, dly = torch.autograd.grad(
                loss, tree_leaves(leaves) + [pooled]
            )
        it = iter(dgrads)
        grads = tree_map(lambda _: next(it), leaves)

        with torch.no_grad():
            accum = opt_state.get("accum")
            dense_accum = (None if accum is None else
                           {k: v for k, v in accum.items() if k != "emb"})
            apply_updates(optimizer, dense, grads, dense_accum, lr, eps=eps)
            dly_t = dly.transpose(0, 1)  # [T, B, d] view, no copy
            if grad_impl == "onehot":
                g_u = window_grads(dly_t, sw.vals_u, wts_u, sw.w2t,
                                   mm_dtype=mm_dtype)
            else:
                g_u = gather_grads(dly_t, sw.vals_u, wts_u, sw.w2t)
            stream_update(
                optimizer, plan, emb,
                None if accum is None else accum["emb"]["stacked"],
                g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u, lr,
                mm_dtype=mm_dtype, eps=eps,
                stochastic_round=stochastic_round, seed=opt_state["step"],
            )
        opt_state["step"] += 1
        return params, opt_state, loss.detach(), probs.detach()

    return train_step


def make_stream_eval_step(model: DLRMModel, plan: StreamPlan,
                          device="cuda"):
    """Forward-only step over the stream-layout (padded) table: the same
    gather + pool as training, no stream work needed on eval batches.
    eval_step(params, batch) -> probs [B, 1]."""
    model._check_supported()
    offsets = _offsets(plan, resolve_device(device))

    @torch.no_grad()
    def eval_step(params, batch: Batch):
        pooled = grouped_embedding_bag(
            params["emb"]["stacked"], offsets, batch.idx, batch.wt, plan.hot,
            batch=batch.dense.shape[0],
        )
        dense = {k: v for k, v in params.items() if k != "emb"}
        probs, _ = model.forward_from_pooled(dense, batch.dense, pooled)
        return probs

    return eval_step
