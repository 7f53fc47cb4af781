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
G_u and K3's rows R_u are held in g_dtype (fp32, or bf16: half the bytes,
each element rounded once to the nearest bf16), as in the JAX step.
While utils/profiling.py's profile() traces, steps 1-4 are its spans
EMB_FWD, LOSS and BWD (in grads_from_pooled), "DLRM dense update",
"DLRM table grads" (timed on the card by two CUDA events) and "DLRM
table update".

Under weighted pooling (cfg.weighted_pooling, the per-row weights v_w in
the padded row layout) the forward must be the gather, with v_w folded into
the hits' weights; d(loss)/d(v_w) is each hit's weight times the dot of its
row with its bag's dly, summed per row ("fixed": zero, which leaves v_w as
it is); the table's per-hit weights take v_w at the step's input
(dlrm_tpu/train/stream_step.py:207-245, :290-300).

Everything updates IN PLACE, where the JAX step donates its buffers
(stream_step.py:336) and K2 aliases table and accumulator: the step returns
the same params and opt_state objects it was given, so a caller that wants
to keep the inputs clones them first. The step never waits on the device
(lr and the step counter are host scalars), so the host can build the next
batch while the card works.

Layouts:
  * params["emb"]["stacked"] is the PADDED block-aligned [padded_rows, d]
    table (pad_params);
  * params["v_w"], under weighted pooling, is [padded_rows] in the same
    row layout;
  * rwsadagrad's row accumulator is packed [padded_rows/128, 128];
  * opt_state = {"step": int, "accum": {...}} with "accum" absent for sgd.
"""

from __future__ import annotations

import torch

from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.device import resolve_device
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.ops.embedding import (
    flat_layout,
    flat_rows,
    grouped_embedding_bag,
    to_flat,
)
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
)
from dlrm_tpu_torch.utils import profiling as prof


def _check_plain(model: DLRMModel) -> None:
    if not model.fused:
        raise ValueError("stream step requires plain uniform-width tables")


def plan_for_model(model: DLRMModel, batch_size: int,
                   block_rows: int = 2048, hot_sizes=None) -> StreamPlan:
    """hot_sizes: per-table multi-hot sizes (the v2 ragged config); None
    uses the uniform cfg.num_indices_per_lookup."""
    cfg = model.cfg
    _check_plain(model)
    return make_stream_plan(
        cfg.table_sizes, cfg.embedding_dim, batch_size,
        cfg.num_indices_per_lookup if hot_sizes is None else hot_sizes,
        block_rows=block_rows,
    )


def _repack(x, rows, src_offsets, dst_offsets, sizes, fill):
    """x's rows of each table moved from src_offsets to dst_offsets in a new
    [rows, ...] tensor (filled with 0 or left empty between tables)."""
    make = torch.zeros if fill else torch.empty
    out = make((rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    for src, dst, n in zip(src_offsets, dst_offsets, sizes):
        out[dst : dst + n] = x[src : src + n]
    return out


def pad_params(params, model: DLRMModel, plan: StreamPlan):
    """Repack emb.stacked [total_rows, d] -> padded [plan.padded_rows, d]
    (every table starts at a block boundary), and v_w [total_rows] into
    the same row layout. Returns a new dict; the dense params are shared,
    not copied."""
    src = [int(o) for o in model.row_offsets]
    args = (plan.padded_rows, src, plan.padded_offsets, plan.table_sizes,
            True)
    out = dict(params)
    out["emb"] = {"stacked": _repack(params["emb"]["stacked"], *args)}
    if "v_w" in params:
        out["v_w"] = _repack(params["v_w"], *args)
    return out


def unpad_params(params, model: DLRMModel, plan: StreamPlan):
    """Inverse of pad_params."""
    dst = [int(o) for o in model.row_offsets]
    args = (model.total_rows, plan.padded_offsets, dst, plan.table_sizes,
            False)
    out = dict(params)
    out["emb"] = {"stacked": _repack(params["emb"]["stacked"], *args)}
    if "v_w" in params:
        out["v_w"] = _repack(params["v_w"], *args)
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


def _padded_hit_ids(plan: StreamPlan, idx, offsets, batch=None):
    """Every hit's row in the PADDED layout (the index space of the stream
    table and of v_w after pad_params), in idx's own layout: flat
    [sum_t B*h_t] table-major, or padded [T, B, Hmax]. batch: the flat
    layout's batch size when it differs from plan.batch (eval batches)."""
    if idx.dim() == 1:
        return flat_rows(offsets, idx, plan.hot,
                         plan.batch if batch is None else int(batch))
    return idx + offsets[:, None, None]


def _weighted(wt, vw, hit_ids):
    """The hits' weights times their rows' v_w."""
    vw_hits = vw[hit_ids.long()]
    return vw_hits if wt is None else wt * vw_hits


def make_stream_train_step(
    model: DLRMModel,
    optimizer: str,
    plan: StreamPlan,
    *,
    fwd_impl: str = "gather",  # gather (F.embedding_bag) | stream (K3+K4)
    grad_impl: str = "onehot",  # onehot (K1) | gather (gather_grads)
    mm_dtype=torch.float32,  # K1-K4: round operands to this dtype first
    g_dtype=torch.float32,  # dtype of the G_u / R_u intermediates
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
    _check_plain(model)
    cfg = model.cfg
    weighted = cfg.weighted_pooling  # None | "fixed" | "learned"
    if weighted is not None and fwd_impl != "gather":
        raise ValueError(
            "weighted pooling on the stream step requires fwd_impl='gather', "
            "as the JAX step does (K3/K4 pool with the host-built slot "
            "weights, which do not carry v_w)")
    eps = ADAGRAD_EPS if eps is None else float(eps)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    offsets = _offsets(plan, dev)

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
        with torch.no_grad(), prof.scope(prof.EMB_FWD):
            pooled = _pooled(params, batch, sw, wts_u, b)
        loss, probs, grads, dly = model.grads_from_pooled(
            {k: v for k, v in dense.items() if k != "v_w"}, batch, pooled)
        if weighted is not None:
            with torch.no_grad():
                grads["v_w"] = _vw_grad(params, batch, dly, b)
                # d(loss)/d(row) = sum over hits of wt * v_w[row] * dly[bag]:
                # v_w at the step's input multiplies into the per-hit
                # weights, taken before the dense update moves v_w in place
                rows = sw.rows_u + offsets[sw.w2t.long()][:, None, None]
                rows = torch.where(sw.rows_u == SENTINEL_ROW, 0, rows)
                wts_u = wts_u * params["v_w"][rows.long()]

        with torch.no_grad():
            accum = opt_state.get("accum")
            dense_accum = (None if accum is None else
                           {k: v for k, v in accum.items() if k != "emb"})
            with prof.scope(prof.DENSE_UPDATE):
                apply_updates(optimizer, dense, grads, dense_accum, lr,
                              eps=eps)
            dly_t = dly.transpose(0, 1)  # [T, B, d] view, no copy
            with prof.scope(prof.TABLE_GRADS, device=on_card):
                if grad_impl == "onehot":
                    g_u = window_grads(dly_t, sw.vals_u, wts_u, sw.w2t,
                                       out_dtype=g_dtype, mm_dtype=mm_dtype)
                else:
                    g_u = gather_grads(dly_t, sw.vals_u, wts_u, sw.w2t,
                                       out_dtype=g_dtype)
            with prof.scope(prof.TABLE_UPDATE):
                stream_update(
                    optimizer, plan, emb,
                    None if accum is None else accum["emb"]["stacked"],
                    g_u, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u,
                    lr, mm_dtype=mm_dtype, eps=eps,
                    stochastic_round=stochastic_round,
                    seed=opt_state["step"],
                )
        opt_state["step"] += 1
        return params, opt_state, loss, probs

    def _pooled(params, batch, sw, wts_u, b):
        """pooled [B, T, d]: K3 + K4, or the gather (with v_w folded into
        the hits' weights, then in fp32 as the JAX step's)."""
        emb = params["emb"]["stacked"]
        if fwd_impl == "stream":
            if sw.touched_only:
                raise ValueError(
                    "fwd_impl='stream' needs the full item list (K3 must "
                    "write every slot); build the batch without "
                    "update_touched_only")
            return stream_embedding_fwd(
                plan, emb, sw.rows_u, sw.vals_u, wts_u, sw.w2t,
                sw.item_block, sw.item_row0, sw.item_u, mm_dtype=mm_dtype,
                r_dtype=g_dtype,
            ).transpose(0, 1)
        if weighted is None:
            return grouped_embedding_bag(emb, offsets, batch.idx, batch.wt,
                                         plan.hot, batch=b)
        wt = _weighted(batch.wt, params["v_w"],
                       _padded_hit_ids(plan, batch.idx, offsets, b))
        return grouped_embedding_bag(emb, offsets, batch.idx, wt, plan.hot,
                                     batch=b).float()

    def _vw_grad(params, batch, dly, b):
        """d(loss)/d(v_w): for each hit, its weight times the dot of its
        table row with its bag's dly, summed per row (zero under "fixed",
        whose v_w takes no gradient). Taken by hand: F.embedding_bag's
        per-sample-weights backward has no bf16 kernel on the card."""
        vw = params["v_w"]
        if weighted == "fixed":
            return torch.zeros_like(vw)
        idx, wt, _ = to_flat(batch.idx, batch.wt, plan.hot, b)
        rows = flat_rows(offsets, idx, plan.hot, b).long()
        bag = flat_layout(tuple(plan.hot), b, idx.device)[2]
        d = dly.shape[-1]
        per_hit = (params["emb"]["stacked"].index_select(0, rows).float()
                   * dly.reshape(-1, d).float().index_select(0, bag.long())
                   ).sum(dim=1)
        if wt is not None:
            per_hit = per_hit * wt
        return torch.zeros_like(vw).index_add_(0, rows, per_hit)

    return train_step


def make_stream_eval_step(model: DLRMModel, plan: StreamPlan,
                          device="cuda"):
    """Forward-only step over the stream-layout (padded) table: the same
    gather + pool as training (v_w folded into the hits' weights), no
    stream work needed on eval batches. eval_step(params, batch) ->
    probs [B, 1]."""
    _check_plain(model)
    offsets = _offsets(plan, resolve_device(device))

    @torch.no_grad()
    def eval_step(params, batch: Batch):
        b = batch.dense.shape[0]
        wt = batch.wt
        if "v_w" in params:
            wt = _weighted(wt, params["v_w"],
                           _padded_hit_ids(plan, batch.idx, offsets, b))
        pooled = grouped_embedding_bag(
            params["emb"]["stacked"], offsets, batch.idx, wt, plan.hot,
            batch=b,
        )
        dense = {k: v for k, v in params.items()
                 if k not in ("emb", "v_w")}
        probs, _ = model.forward_from_pooled(dense, batch.dense, pooled)
        return probs

    return eval_step
