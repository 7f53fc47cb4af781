"""The DLRM model over a plain dict of tensors (the port of
dlrm_tpu/models/dlrm.py).

Parameters keep the JAX package's tree so they cross the bridge unchanged:
{"emb": {"stacked": [rows, d]}, "bot": [{"w": [n_in, n_out], "b": [n_out]},
...], "top": [...]}, plus "v_w" [rows] under weighted pooling, "dcn" (a list
of {"v", "w", "b"}) under the dcn interaction and "proj_w1"/"proj_w2" under
the projection interaction ("proj_branch1"/"proj_branch2", layer lists as
"bot", in torchrec's form). With QR or MD tables the tables are a list,
{"emb": {"tables": [entry, ...]}}, one entry per table: {"q", "r"} for a QR
table, {"w"} plus a "proj" [dim, d] for an MD table narrower than d, {"w"}
otherwise; "v_w" is then a list of [n] vectors. For quantized inference
(quantize_embeddings, quantize_mlps) the stacked table becomes {"emb":
{"quantized": {"packed": uint8 [rows, row_bytes]}}} (or "packed_g16", 16
rows a line), a per-table entry {"quantized": {"packed"}[, "proj"]}, and a
tower layer {"qw" int8, "w_scale", "b"} or {"qw" bf16, "b"}
(ops/quantized.py). The model object holds only static config.
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
    flat_hit_offsets,
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
from dlrm_tpu_torch.ops import quantized as Q
from dlrm_tpu_torch.optim.optimizers import tree_leaves, tree_map
from dlrm_tpu_torch.utils import profiling as prof

Params = Dict


def table_seed(seed: int, t: int) -> int:
    """The seed of table t's generator: an independent stream per (seed,
    table), from numpy's SeedSequence."""
    return int(np.random.SeedSequence([int(seed), int(t)]).generate_state(
        1, np.uint64)[0] >> 1)


def _table_generator(seed: int, t: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(table_seed(seed, t))
    return gen


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
        """Random init with the reference's distributions, drawn on `device`:
        tables U(-sqrt(1/n), sqrt(1/n)) (dlrm_s_pytorch.py:280-282), each
        from a torch.Generator of its own (table_seed(seed, t)), drawn in
        place into its rows of the one stacked table (no second copy of
        it), so that a sharded run can draw just its own tables and get the
        same numbers (parallel/stream_butterfly.py::init_params); then,
        from a generator seeded with `seed`, the dense params
        (init_dense_params): MLP weights N(0, sqrt(2/(m+n))), biases
        N(0, sqrt(1/m)) (:221-225), v_w ones, and the dcn/projection
        weights Xavier-uniform with zero biases (the JAX package's
        _init_interaction). torch's generators give other numbers than
        jax.random from the same seed; tests carry the JAX package's params
        across with bridge.py. QR and MD tables are drawn per table in the
        JAX package's entry layout (an MD projection Xavier-uniform)."""
        cfg = self.cfg
        dev = resolve_device(device)
        if self.fused:
            stacked = torch.empty((self.total_rows, cfg.embedding_dim),
                                  device=dev)
            for t, (off, n) in enumerate(zip(self.row_offsets.tolist(),
                                             cfg.table_sizes)):
                self.draw_table(stacked[off: off + n], t, seed)
            params = {"emb": {"stacked": stacked}}
        else:
            params = {"emb": {"tables": [
                self._init_table(_table_generator(seed, i, dev), i, n, dev)
                for i, n in enumerate(cfg.table_sizes)
            ]}}
        params.update(self.init_dense_params(seed, dev))
        return params

    def draw_table(self, out: torch.Tensor, t: int, seed: int = 0) -> None:
        """Table t of a plain model, U(-sqrt(1/n), sqrt(1/n)), drawn in
        place into `out` ([n_t, d], contiguous) from table t's own
        generator: the same numbers wherever out lies on one device."""
        bound = math.sqrt(1.0 / self.cfg.table_sizes[t])
        out.uniform_(-bound, bound,
                     generator=_table_generator(seed, t, out.device))

    def init_dense_params(self, seed: int = 0, device="cuda") -> Params:
        """Every param but the tables (v_w, the towers, the interaction's),
        from one generator seeded with `seed`, in init_params's order."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        params = self._init_pooling_weights(dev)
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
        if cfg.interaction == "projection" and cfg.proj_branches:
            fd = cfg.num_features * cfg.mlp_bot[-1]
            return {f"proj_branch{i}": init_mlp(gen, (fd,) + sizes, dev)
                    for i, sizes in ((1, cfg.interaction_branch1_layer_sizes),
                                     (2, cfg.interaction_branch2_layer_sizes))}
        if cfg.interaction == "projection":
            d = cfg.mlp_bot[-1]
            fd = cfg.num_features * d
            p = cfg.proj_interaction_dims[-1]
            return {"proj_w1": _xavier_uniform(gen, (fd, p * d), dev),
                    "proj_w2": _xavier_uniform(gen, (fd, p * d), dev)}
        return {}

    # ---------------------------------------------------------- quantization

    def quantize_mlps(self, params: Params, bits: int) -> Params:
        """Quantized inference towers (the reference's quantize_dynamic to
        qint8/float16 on every Linear, dlrm_s_pytorch.py:1473-1480): bits=8
        per-channel int8 weights with per-batch activation quantization and
        int32 sums; bits=16 bf16 weights. torchrec's projection branches
        are towers too and are quantized alike."""
        out = dict(params)
        for k in ("bot", "top", "proj_branch1", "proj_branch2"):
            if k in params:
                out[k] = Q.quantize_mlp(params[k], bits)
        return out

    def quantize_embeddings(self, params: Params, bits: int,
                            group16: bool = False) -> Params:
        """Post-training row-wise quantization for inference
        (quantize_embedding, dlrm_s_pytorch.py:465-481): the fp32 tables
        are replaced by int8/int4 prepacked rows, quantized on their device
        (ops/quantized.py::quantize_rows), and dropped. group16 packs 16
        rows a line (the stacked table only)."""
        out = dict(params)
        if self.fused:
            q = Q.quantize_rows(params["emb"]["stacked"].detach(), bits)
            if group16:
                q = {"packed_g16": Q.pack_group16_rows(q)}
            else:
                q = {"packed": q}
            out["emb"] = {"quantized": q}
            return out
        if group16:
            raise NotImplementedError(
                "group16 quantized packing requires the fused stacked "
                "layout (plain uniform-width tables)")
        entries = []
        for entry in params["emb"]["tables"]:
            if "w" not in entry:
                raise NotImplementedError(
                    "quantized inference supports plain/MD tables only "
                    "(reference: 4/8-bit is mutually exclusive with QR, "
                    "dlrm_s_pytorch.py:1042-1057)")
            q = {"quantized": {"packed": Q.quantize_rows(
                entry["w"].detach(), bits)}}
            if "proj" in entry:
                q["proj"] = entry["proj"]
            entries.append(q)
        out["emb"] = {"tables": entries}
        return out

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
        if "quantized" in params["emb"]:
            return self._apply_quantized(params, batch, hot_sizes)
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

    def _apply_quantized(self, params: Params, batch: Batch,
                         hot_sizes: Optional[Sequence[int]]) -> torch.Tensor:
        """apply_emb over the quantized stacked table (the JAX package's
        quantized branch, dlrm_tpu/models/dlrm.py:315-334): each hit's
        packed row gathered, dequantized, weighted by its wt (times its
        row's v_w) and summed over its bag -> fp32 [B, T, d]. The tables
        are looked up in groups of one hot size ([T_g, B, h] each; one
        group when every bag is H long), so no padding hit of a ragged
        batch, in either layout, is gathered."""
        qt = params["emb"]["quantized"]
        d = self.cfg.embedding_dim
        bits = Q.infer_bits(qt, d)
        vw = self.pooling_weights(params) if "v_w" in params else None

        def bag(idx, wt):  # idx [Tg, B, h] stacked rows
            if vw is not None:
                w = vw[idx]
                wt = w if wt is None else wt * w
            if "packed_g16" in qt:
                return Q.quantized_embedding_bag_group16(
                    qt["packed_g16"], idx, wt, d, bits)
            return Q.quantized_embedding_bag(qt, idx, wt, bits=bits)

        idx, wt = batch.idx, batch.wt
        offs = self.offsets(idx.device).long()
        num_t = self.cfg.num_tables
        if hot_sizes is None:
            if idx.dim() != 3:
                raise ValueError("the flat per-hit layout needs hot_sizes")
            hot_sizes = (idx.shape[2],) * num_t
        hot_sizes = tuple(int(h) for h in hot_sizes)
        b = batch.dense.shape[0]
        if idx.dim() == 3:
            views = [(idx[t, :, :h], None if wt is None else wt[t, :, :h])
                     for t, h in enumerate(hot_sizes)]
        else:
            starts, _ = flat_hit_offsets(hot_sizes, b)
            views = [(idx[o: o + b * h].view(b, h),
                      None if wt is None else wt[o: o + b * h].view(b, h))
                     for o, h in zip(starts, hot_sizes)]
        groups: Dict[int, list] = {}
        for t, h in enumerate(hot_sizes):
            groups.setdefault(h, []).append(t)
        out = [None] * num_t
        for h, tabs in groups.items():
            gi = torch.stack([views[t][0] for t in tabs]).long()
            gi = gi + offs[tabs][:, None, None]
            gw = None if wt is None else torch.stack(
                [views[t][1] for t in tabs])
            for t, p in zip(tabs, bag(gi, gw)):
                out[t] = p
        return torch.stack(out, dim=1)

    def _apply_tables(self, params: Params, batch: Batch,
                      hot_sizes: Optional[Sequence[int]]) -> torch.Tensor:
        """The per-table loop of apply_emb (dlrm_tpu/models/dlrm.py:345-377):
        each table's bag pooled on its own, QR tables combined, MD tables
        (plain or quantized) projected to d in fp32 -> [B, T, d]."""
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
            if "quantized" in entry:
                v = Q.quantized_embedding_bag(
                    entry["quantized"], idx_k, wt_k,
                    bits=Q.infer_bits(entry["quantized"], self.table_dims[k]))
                if "proj" in entry:
                    v = matmul_f32(v, entry["proj"])
            elif "q" in entry:
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
            keys = (("proj_branch1", "proj_branch2") if cfg.proj_branches
                    else ("proj_w1", "proj_w2"))
            branches = [params[k] for k in keys]
            leaves = tree_leaves(branches)

            def interaction(x, ly, *ws):
                got = iter(ws)
                return projection_interaction(
                    x, ly, *tree_map(lambda _: next(got), branches))

            return prof.backward_scope(prof.INT_BWD, interaction, x, ly,
                                       *leaves)
        raise ValueError(f"interaction {cfg.interaction!r} not supported")

    def forward_from_pooled(self, params: Params, dense: torch.Tensor,
                            ly: torch.Tensor):
        """Dense tower + interaction + top MLP given pooled embeddings
        [B, T, d] -> (probability, logits). Split out so the fused and
        streamed train steps can differentiate with respect to the pooled
        activations instead of the table. The top MLP's last layer stays
        linear and gives fp32 logits (its fp32 product plus the bias, not
        rounded: a bf16 logit would tie the eval scores that AUROC ranks);
        the sigmoid is applied to them (dlrm_s_pytorch.py:1293). Quantized
        towers (quantize_mlps) run through ops/quantized.py with fp32
        activations, their last layer's fp32 output the logits."""
        cfg = self.cfg
        z = self.interaction_from_pooled(params, dense, ly)
        with prof.scope(prof.TOP_FWD):
            logits = self.logits_from_interaction(params, z)
        p = torch.sigmoid(logits)
        if 0.0 < cfg.loss_threshold < 1.0:
            p = torch.clamp(p, cfg.loss_threshold, 1.0 - cfg.loss_threshold)
        return p, logits

    def interaction_from_pooled(self, params: Params, dense: torch.Tensor,
                                ly: torch.Tensor) -> torch.Tensor:
        """The dense tower and the interaction given pooled embeddings
        [B, T, d] -> the top MLP's input z."""
        dtype = (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                 else torch.float32)
        mlp = (Q.apply_mlp_quantized if Q.is_quantized_mlp(params["bot"])
               else apply_mlp)
        with prof.scope(prof.BOT_FWD):
            x = mlp(params["bot"], dense.to(dtype), self.cfg.sigmoid_bot)
        with prof.scope(prof.INT_FWD):
            return self.interact(params, x, ly.to(x.dtype))

    def logits_from_interaction(self, params: Params,
                                z: torch.Tensor) -> torch.Tensor:
        """The top MLP on an interaction output z -> fp32 logits: every
        layer but the last with its activation, the last linear (its fp32
        product plus the bias). Shared by forward_from_pooled and
        tools/visualize.py, which keeps z and so runs no second pass over
        the bottom MLP; quantized towers included."""
        top = params["top"]
        if Q.is_quantized_mlp(top):
            hidden = Q.apply_mlp_quantized(top[:-1], z, sigmoid_layer=-1)
            return Q.quantized_linear(top[-1], hidden).float()
        hidden = apply_mlp(top[:-1], z, sigmoid_layer=-1)
        return matmul_f32(hidden, top[-1]["w"], top[-1]["b"])

    def grads_from_pooled(self, params: Params, batch: Batch,
                          pooled: torch.Tensor,
                          denom: Optional[torch.Tensor] = None):
        """(loss, probs, grads of the `params` tree, dly): one backward of
        the masked loss of forward_from_pooled, with respect to params (the
        tower and interaction leaves; no table) and to the pooled
        embeddings [B, T, d]. The fused and streamed steps update the
        table from dly themselves. denom: the count of real rows the loss
        is the mean over (masked_mean's), e.g. the global batch's in a
        sharded step whose batch is one rank's slice."""
        pooled = pooled.detach().requires_grad_()
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            probs, logits = self.forward_from_pooled(leaves, batch.dense,
                                                     pooled)
            with prof.scope(prof.LOSS):
                loss = masked_mean(
                    per_example_loss(self.cfg, probs, batch.labels, logits),
                    batch.labels, denom=denom)
            with prof.scope(prof.BWD):
                *grads, dly = torch.autograd.grad(
                    loss, tree_leaves(leaves) + [pooled])
        it = iter(grads)
        return (loss.detach(), probs.detach(),
                tree_map(lambda _: next(it), leaves), dly)

    def apply_with_logits(self, params: Params, batch: Batch,
                          hot_sizes: Optional[Sequence[int]] = None):
        """Full forward pass -> (click probability [B, 1], fp32 logits)."""
        with prof.scope(prof.FWD):
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
