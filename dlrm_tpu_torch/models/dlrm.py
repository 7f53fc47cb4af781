"""The DLRM model over a plain dict of tensors (the port of
dlrm_tpu/models/dlrm.py).

Parameters keep the JAX package's tree so they cross the bridge unchanged:
{"emb": {"stacked": [rows, d]}, "bot": [{"w": [n_in, n_out], "b": [n_out]},
...], "top": [...]}, plus "v_w" [rows] under weighted pooling, "dcn" (a list
of {"v", "w", "b"}) under the dcn interaction and "proj_w1"/"proj_w2" under
the projection interaction. With QR or MD tables the tables are a list,
{"emb": {"tables": [entry, ...]}}, one entry per table: {"q", "r"} for a QR
table, {"w"} plus a "proj" [dim, d] for an MD table narrower than d, {"w"}
otherwise; "v_w" is then a list of [n] vectors. The model object holds only
static config.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.device import resolve_device
from dlrm_tpu_torch.ops.embedding import (
    embedding_bag,
    flat_rows,
    pool_flat_rows,
    qr_embedding_bag,
    to_flat,
)
from dlrm_tpu_torch.ops.interaction import (
    cat_interaction,
    dot_interaction,
    low_rank_cross_net,
    projection_interaction,
)
from dlrm_tpu_torch.ops.mlp import (
    apply_mlp,
    init_mlp,
    init_mlp_numpy,
    matmul_f32,
)
from dlrm_tpu_torch.optim.optimizers import tree_leaves, tree_map
from dlrm_tpu_torch.utils import profiling as prof

Params = Dict


def _xavier_uniform(gen, shape, device) -> torch.Tensor:
    """U(-a, a), a = sqrt(6 / (shape[0] + shape[1])), as the JAX package's."""
    a = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape, device=device).uniform_(-a, a, generator=gen)


class DLRMModel:
    """Static-config holder; all state lives in the params dict."""

    def __init__(self, cfg: DLRMConfig):
        self.cfg = cfg
        # the stacked-table path needs plain tables of uniform width
        self.fused = cfg.qr is None and cfg.md is None
        if self.fused:
            sizes = np.asarray(cfg.table_sizes, dtype=np.int64)
            self.row_offsets = np.concatenate(
                [[0], np.cumsum(sizes)[:-1]]
            ).astype(np.int32)
            self.total_rows = int(sizes.sum())
        self.md_dims = cfg.md_dims
        # the MD solver's dim applies only to tables above the threshold;
        # the others keep the base dim (dlrm_s_pytorch.py:267-269)
        self.table_dims = tuple(
            self.md_dims[i] if self._table_is_md(n) else cfg.embedding_dim
            for i, n in enumerate(cfg.table_sizes)
        )
        self._offsets = {}

    def _table_is_qr(self, n: int) -> bool:
        return self.cfg.qr is not None and n > self.cfg.qr.threshold

    def _table_is_md(self, n: int) -> bool:
        return self.cfg.md is not None and n > self.cfg.md.threshold

    def offsets(self, device) -> torch.Tensor:
        """row_offsets as an int32 tensor on `device`, copied there once."""
        dev = torch.device(device)
        if dev not in self._offsets:
            self._offsets[dev] = torch.from_numpy(self.row_offsets).to(dev)
        return self._offsets[dev]

    # ------------------------------------------------------------------ init

    def init_params(self, seed: int = 0, device="cuda") -> Params:
        """Random init with the reference's distributions, drawn on `device`
        from a torch.Generator seeded with `seed`: tables
        U(-sqrt(1/n), sqrt(1/n)) (dlrm_s_pytorch.py:280-282), each drawn in
        place into its rows of the one stacked table (no second copy of
        it), MLP weights N(0, sqrt(2/(m+n))), biases N(0, sqrt(1/m))
        (:221-225), v_w ones, and the dcn/projection weights
        Xavier-uniform with zero biases (the JAX package's
        _init_interaction). torch's generator gives other numbers than
        jax.random from the same seed; tests carry the JAX package's params
        across with bridge.py. QR and MD tables are drawn per table in the
        JAX package's entry layout (an MD projection Xavier-uniform)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if self.fused:
            stacked = torch.empty((self.total_rows, cfg.embedding_dim),
                                  device=dev)
            for off, n in zip(self.row_offsets.tolist(), cfg.table_sizes):
                bound = math.sqrt(1.0 / n)
                stacked[off: off + n].uniform_(-bound, bound, generator=gen)
            params = {"emb": {"stacked": stacked}}
        else:
            params = {"emb": {"tables": [
                self._init_table(gen, i, n, dev)
                for i, n in enumerate(cfg.table_sizes)
            ]}}
        params.update(self._init_pooling_weights(dev))
        params["bot"] = init_mlp(gen, cfg.mlp_bot, dev)
        params["top"] = init_mlp(gen, cfg.ln_top, dev)
        params.update(self._init_interaction(gen, dev))
        return params

    def _init_table(self, gen, i: int, n: int, dev) -> Params:
        """One per-table entry: {"q", "r"} (QR), {"w"[, "proj"]} (MD), or
        {"w"}, every table U(-sqrt(1/n), sqrt(1/n))."""
        cfg = self.cfg
        bound = math.sqrt(1.0 / n)

        def uniform(shape):
            return torch.empty(shape, device=dev).uniform_(
                -bound, bound, generator=gen)

        if self._table_is_qr(n):
            c = cfg.qr.collisions
            m = (cfg.embedding_dim // 2 if cfg.qr.operation == "concat"
                 else cfg.embedding_dim)
            return {"q": uniform(((n + c - 1) // c, m)), "r": uniform((c, m))}
        dim = self.table_dims[i]
        entry = {"w": uniform((n, dim))}
        if dim < cfg.embedding_dim:
            entry["proj"] = _xavier_uniform(gen, (dim, cfg.embedding_dim),
                                            dev)
        return entry

    def _init_pooling_weights(self, dev) -> Params:
        if self.cfg.weighted_pooling is None:
            return {}
        if self.fused:
            return {"v_w": torch.ones((self.total_rows,), device=dev)}
        return {"v_w": [torch.ones((n,), device=dev)
                        for n in self.cfg.table_sizes]}

    def init_params_numpy(self, device="cuda") -> Params:
        """The reference's init from the GLOBAL numpy stream, which the
        caller seeds, in DLRM_Net.__init__'s order: the tables
        (dlrm_s_pytorch.py:369), then the bottom MLP (:376), then the top
        MLP (:377); the same numbers as the JAX package's
        init_params_numpy. An MD projection is drawn from a private
        RandomState seeded from the global state without consuming it, as
        in the JAX package. The dcn and projection interactions are drawn
        from a torch.Generator seeded likewise (the JAX package draws them
        with jax.random, whose numbers a torch generator cannot give; tests
        carry them across with bridge.py). QR tables raise
        NotImplementedError: the reference draws them from the torch RNG
        (tricks/qr_embedding_bag.py:189-190), so there is no numpy
        sequence to match, and the trainer falls back to init_params."""
        cfg = self.cfg
        if cfg.qr is not None:
            raise NotImplementedError(
                "numpy-parity init does not cover QR tables")
        dev = resolve_device(device)
        tables = [
            np.random.uniform(
                low=-np.sqrt(1.0 / n), high=np.sqrt(1.0 / n),
                size=(n, self.table_dims[i]),
            ).astype(np.float32)
            for i, n in enumerate(cfg.table_sizes)
        ]

        def put(a):
            return torch.from_numpy(a).to(dev)

        if self.fused:
            params = {"emb": {"stacked": put(np.concatenate(tables))}}
        else:
            private = np.random.RandomState(
                int(np.random.get_state()[1][0]) ^ 0x9E3779B9)
            entries = []
            for i, (n, w) in enumerate(zip(cfg.table_sizes, tables)):
                entry = {"w": put(w)}
                if self._table_is_md(n) and self.md_dims[i] < cfg.embedding_dim:
                    a = np.sqrt(6.0 / (self.md_dims[i] + cfg.embedding_dim))
                    entry["proj"] = put(private.uniform(
                        -a, a, size=(self.md_dims[i], cfg.embedding_dim)
                    ).astype(np.float32))
                entries.append(entry)
            params = {"emb": {"tables": entries}}
        params.update(self._init_pooling_weights(dev))
        params["bot"] = init_mlp_numpy(cfg.mlp_bot, dev)
        params["top"] = init_mlp_numpy(cfg.ln_top, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.get_state()[1][0]) & 0x7FFFFFFF)
        params.update(self._init_interaction(gen, dev))
        return params

    def _init_interaction(self, gen, dev) -> Params:
        cfg = self.cfg
        if cfg.interaction == "dcn":
            n = cfg.num_features * cfg.mlp_bot[-1]
            r = cfg.dcn.low_rank_dim
            return {"dcn": [
                {"v": _xavier_uniform(gen, (r, n), dev),
                 "w": _xavier_uniform(gen, (n, r), dev),
                 "b": torch.zeros((n,), device=dev)}
                for _ in range(cfg.dcn.num_layers)
            ]}
        if cfg.interaction == "projection":
            d = cfg.mlp_bot[-1]
            fd = cfg.num_features * d
            p = cfg.proj_interaction_dims[-1]
            return {"proj_w1": _xavier_uniform(gen, (fd, p * d), dev),
                    "proj_w2": _xavier_uniform(gen, (fd, p * d), dev)}
        return {}

    # --------------------------------------------------------------- forward

    def pooling_weights(self, params: Params) -> torch.Tensor:
        """v_w, detached under weighted_pooling="fixed": the reference keeps
        fixed pooling weights as buffers, not parameters
        (dlrm_s_pytorch.py:337-340), so they take no gradient and every
        optimizer leaves them where they are."""
        vw = params["v_w"]
        if self.cfg.weighted_pooling != "fixed":
            return vw
        return [v.detach() for v in vw] if isinstance(vw, list) else vw.detach()

    def apply_emb(self, params: Params, batch: Batch,
                  hot_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Pooled embeddings [B, T, d] (apply_emb, dlrm_s_pytorch.py:407-462)
        from the padded [T, B, H] layout (every column, as the JAX
        package's fused_embedding_bag) or, given the per-table hot_sizes,
        either layout. With v_w, each hit's weight is multiplied by its
        row's v_w. QR and MD tables pool table by table (the padded layout
        only)."""
        if not self.fused:
            return self._apply_tables(params, batch, hot_sizes)
        idx = batch.idx
        if hot_sizes is None:
            if idx.dim() != 3:
                raise ValueError("the flat per-hit layout needs hot_sizes")
            hot_sizes = (idx.shape[2],) * idx.shape[0]
        idx, wt, b = to_flat(idx, batch.wt, hot_sizes, batch.dense.shape[0])
        rows = flat_rows(self.offsets(idx.device), idx, hot_sizes, b)
        if "v_w" in params:
            vw = self.pooling_weights(params)[rows]
            wt = vw if wt is None else wt * vw
        return pool_flat_rows(params["emb"]["stacked"], rows, wt, hot_sizes, b)

    def _apply_tables(self, params: Params, batch: Batch,
                      hot_sizes: Optional[Sequence[int]]) -> torch.Tensor:
        """The per-table loop of apply_emb (dlrm_tpu/models/dlrm.py:345-377):
        each table's bag pooled on its own, QR tables combined, MD tables
        projected to d in fp32 -> [B, T, d]."""
        cfg = self.cfg
        if batch.idx.dim() != 3:
            raise ValueError("QR/MD tables need the padded [T, B, H] layout")
        vws = self.pooling_weights(params) if "v_w" in params else None
        pooled = []
        for k, entry in enumerate(params["emb"]["tables"]):
            h = batch.idx.shape[2] if hot_sizes is None else int(hot_sizes[k])
            idx_k = batch.idx[k, :, :h].long()
            wt_k = None if batch.wt is None else batch.wt[k, :, :h]
            if vws is not None:
                vw = vws[k][idx_k]
                wt_k = vw if wt_k is None else wt_k * vw
            if "q" in entry:
                v = qr_embedding_bag(entry["q"], entry["r"],
                                     cfg.qr.collisions, cfg.qr.operation,
                                     idx_k, wt_k)
            else:
                v = embedding_bag(entry["w"], idx_k, wt_k)
                if "proj" in entry:
                    v = matmul_f32(v, entry["proj"])
            pooled.append(v)
        return torch.stack(pooled, dim=1)

    def interact(self, params: Params, x: torch.Tensor,
                 ly: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.interaction == "dot":
            return dot_interaction(x, ly, cfg.interaction_itself)
        if cfg.interaction == "cat":
            return cat_interaction(x, ly)
        if cfg.interaction == "dcn":
            return low_rank_cross_net(params["dcn"], cat_interaction(x, ly))
        if cfg.interaction == "projection":
            return projection_interaction(x, ly, params["proj_w1"],
                                          params["proj_w2"])
        raise ValueError(f"interaction {cfg.interaction!r} not supported")

    def forward_from_pooled(self, params: Params, dense: torch.Tensor,
                            ly: torch.Tensor):
        """Dense tower + interaction + top MLP given pooled embeddings
        [B, T, d] -> (probability, logits). Split out so the fused and
        streamed train steps can differentiate with respect to the pooled
        activations instead of the table. The top MLP's last layer stays
        linear and gives fp32 logits (its fp32 product plus the bias, not
        rounded: a bf16 logit would tie the eval scores that AUROC ranks);
        the sigmoid is applied to them (dlrm_s_pytorch.py:1293)."""
        cfg = self.cfg
        dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                 else torch.float32)
        with prof.scope(prof.BOT_FWD):
            x = apply_mlp(params["bot"], dense.to(dtype), cfg.sigmoid_bot)
        with prof.scope(prof.INT_FWD):
            z = self.interact(params, x, ly.to(x.dtype))
        with prof.scope(prof.TOP_FWD):
            hidden = apply_mlp(params["top"][:-1], z, sigmoid_layer=-1)
            last = params["top"][-1]
            logits = matmul_f32(hidden, last["w"], last["b"])
        p = torch.sigmoid(logits)
        if 0.0 < cfg.loss_threshold < 1.0:
            p = torch.clamp(p, cfg.loss_threshold, 1.0 - cfg.loss_threshold)
        return p, logits

    def grads_from_pooled(self, params: Params, batch: Batch,
                          pooled: torch.Tensor):
        """(loss, probs, grads of the `params` tree, dly): one backward of
        the masked loss of forward_from_pooled, with respect to params (the
        tower and interaction leaves; no table) and to the pooled
        embeddings [B, T, d]. The fused and streamed steps update the
        table from dly themselves."""
        pooled = pooled.detach().requires_grad_()
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            probs, logits = self.forward_from_pooled(leaves, batch.dense,
                                                     pooled)
            loss = masked_mean(
                per_example_loss(self.cfg, probs, batch.labels, logits),
                batch.labels)
            *grads, dly = torch.autograd.grad(
                loss, tree_leaves(leaves) + [pooled])
        it = iter(grads)
        return (loss.detach(), probs.detach(),
                tree_map(lambda _: next(it), leaves), dly)

    def apply_with_logits(self, params: Params, batch: Batch,
                          hot_sizes: Optional[Sequence[int]] = None):
        """Full forward pass -> (click probability [B, 1], fp32 logits)."""
        with prof.scope(prof.EMB_FWD):
            ly = self.apply_emb(params, batch, hot_sizes)
        return self.forward_from_pooled(params, batch.dense, ly)

    def apply(self, params: Params, batch: Batch,
              hot_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        return self.apply_with_logits(params, batch, hot_sizes)[0]

    # ------------------------------------------------------------------ loss

    def loss(self, params: Params, batch: Batch,
             hot_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        return self.loss_and_prob(params, batch, hot_sizes)[0]

    def loss_and_prob(self, params: Params, batch: Batch,
                      hot_sizes: Optional[Sequence[int]] = None):
        p, logits = self.apply_with_logits(params, batch, hot_sizes)
        return compute_loss(self.cfg, p, batch.labels, logits=logits), p


def per_example_loss(
    cfg: DLRMConfig,
    probs: torch.Tensor,
    labels: torch.Tensor,
    logits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MSE / BCE / weighted-BCE per example. BCE from logits is
    softplus(z) - t*z with an exact softplus (logaddexp(z, 0));
    F.softplus turns linear above its threshold and is not used."""
    t = labels.float()
    if cfg.loss == "mse":
        return torch.square(probs - t)
    if logits is not None and not (0.0 < cfg.loss_threshold < 1.0):
        z = logits.float()
        per = torch.logaddexp(z, torch.zeros_like(z)) - t * z
    else:
        eps = 1e-7  # >= fp32 ulp at 1.0 so the clip actually bites
        p = torch.clamp(probs, eps, 1.0 - eps)
        per = -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))
    if cfg.loss == "bce":
        return per
    # wbce: per-sample weight selected by the integer target
    w1, w0 = float(cfg.loss_weights[1]), float(cfg.loss_weights[0])
    return torch.where(t >= 0.5, w1, w0) * per


def masked_mean(per: torch.Tensor, labels: torch.Tensor,
                denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over REAL rows only: a label < 0 marks a pad row, which adds
    nothing to the loss or its gradients. `denom` overrides the count of
    real rows."""
    t = labels.float().reshape(per.shape)
    valid = (t >= 0.0).float()
    if denom is None:
        denom = torch.clamp(valid.sum(), min=1.0)
    return (per * valid).sum() / denom


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """Number of real (non-pad) rows in a labels array."""
    return (labels.float() >= 0.0).float().sum()


def compute_loss(
    cfg: DLRMConfig,
    probs: torch.Tensor,
    labels: torch.Tensor,
    logits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    return masked_mean(per_example_loss(cfg, probs, labels, logits), labels)
