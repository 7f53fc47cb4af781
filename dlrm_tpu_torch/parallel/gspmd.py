"""The GSPMD strategy over the ranks (the port of the JAX package's
dlrm_tpu/parallel/gspmd.py): GspmdDLRM, row-sharded training of every model
variant, and the quantized serving of the v1 CLI.

Training (GspmdDLRM). The JAX package row-shards every table over "model",
splits the batch over ("data", "model"), jits the ordinary single-device
step and lets XLA's SPMD partitioner insert the collectives; it supports
EVERY model variant (QR, MD, weighted pooling, any optimizer) because it
reuses the single-device code, and is the fallback for configurations the
butterfly does not cover. Here every rank is one process holding what its
device holds there:

  * each row-shardable leaf (_is_row_shardable: the tables, QR's q and r,
    v_w, and their optimizer accumulators), padded at its end to a
    multiple of the model axis's size, as its rank's block of rows
    (_put_row_sharded); every other leaf (MLPs, MD projections, the
    interaction's) replicated;
  * its slice of the global batch, the (d * model + m)-th (shard_batch).

The step is the single-device step's code, with the partitioner's
collectives written out: the model (models/dlrm.py) runs as it is on this
rank's slice, its row-sharded leaves wrapped as parallel/row_sharded.py's
RowShardedTable, whose lookups all-gather the indices over "model", pool
each rank's own rows and reduce-scatter the partial sums back by slice
(backward: the pooled cotangents all-gathered, each block's own rows'
gradient). The loss is the sum over the rank's real rows over the GLOBAL
count of real rows, so summing the ranks' gradients gives one device's
gradient of the global batch's mean loss: the replicated leaves' gradients
(and the loss) are summed over every rank, the blocks' over "data" (their
replicas). The optimizer (optim/optimizers.py) then runs as it is on each
rank's blocks and replicated leaves: a row lives whole on one rank, so
rwsadagrad's row mean of g^2 is the full row's, and a padded row's
gradient is exactly 0 and so is its update. A pooled sum over hits in
several blocks is summed block by block and then over the blocks, so
tables and dense params differ from one device's by fp32 rounding
(tests/test_torch_gspmd_train.py).

Serving (shard_batch, make_eval_step below), as the JAX package's one
caller uses it: the v1 CLI's --sharded quantized --inference-only
(dlrm_tpu/cli.py:497-544). There, every device of the mesh holds the packed
tables and dense params (replicated) and the eval batch is split over all
of them. Here every rank holds the whole quantized tree on its own device
and scores its own contiguous slice of each global batch (shard_batch: rank
r of W takes rows [r * B / W, (r + 1) * B / W), the slice device r takes
under JAX's batch sharding) with the model's eval step (make_eval_step),
whose int8 towers quantize their activations with the global batch's max
|x| (a max over the ranks), as JAX's partitioned forward does; the
harness's multi-process evaluation folds each rank's scores into the AUC
histogram and sums it over the ranks. The params need no sharding: each
rank's tree is the whole one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.device import resolve_device
from dlrm_tpu_torch.models.dlrm import (
    DLRMModel,
    masked_mean,
    per_example_loss,
    valid_count,
)
from dlrm_tpu_torch.ops import quantized as Q
from dlrm_tpu_torch.ops.embedding import flat_hit_offsets
from dlrm_tpu_torch.optim.optimizers import (
    ADAGRAD_EPS,
    apply_updates,
    path_keys,
    tree_leaves,
    tree_map,
    tree_map_with_path,
)
from dlrm_tpu_torch.parallel.collectives import (
    Axis,
    flat_all_reduce,
    world_axis,
)
from dlrm_tpu_torch.parallel.mesh import RankMesh
from dlrm_tpu_torch.parallel.multihost import rank, world_size
from dlrm_tpu_torch.parallel.row_sharded import RowShardedTable
from dlrm_tpu_torch.train.step import make_eval_step as model_eval_step


def _is_row_shardable(path, leaf) -> bool:
    """A leaf indexed BY ROW (the tables, QR's q and r, v_w, and their
    accumulators) is split by rows over "model"; MD projections and the
    other dense weights are replicated (dlrm_tpu/parallel/gspmd.py:26-36)."""
    keys = path_keys(path)
    if getattr(leaf, "ndim", 0) < 1:
        return False
    if "v_w" in keys:
        return True
    return "emb" in keys and keys[-1] in ("stacked", "w", "q", "r")


def batch_slice(batch: Batch, k: int, n: int,
                hot_sizes: Optional[Sequence[int]] = None,
                device=None) -> Batch:
    """Slice k of n of a global batch (a device Batch on any device, padded
    [T, B, H] or, with hot_sizes, flat per-hit): rows [k * b, (k + 1) * b)
    of every field, b = B / n (JAX's P(("data", "model")) split, dim 1 of
    the padded idx and wt); in the flat layout each table's block of B * h
    hits gives its b * h. On `device` (None: where the batch lies)."""
    total = batch.dense.shape[0]
    if total % n:
        raise ValueError(f"the batch of {total} rows does not split over "
                         f"{n} ranks")
    b = total // n
    rows = slice(k * b, (k + 1) * b)
    if batch.idx.dim() == 3:
        def hits(x):
            return None if x is None else x[:, rows]
    elif hot_sizes is None:
        raise ValueError("the flat per-hit layout needs hot_sizes")
    else:
        starts, _ = flat_hit_offsets(hot_sizes, total)

        def hits(x):
            return None if x is None else torch.cat(
                [x[o + k * b * h: o + (k + 1) * b * h]
                 for o, h in zip(starts, hot_sizes)])

    out = Batch(batch.dense[rows], hits(batch.idx), hits(batch.wt),
                batch.labels[rows])
    return out if device is None else Batch(
        *(None if x is None else x.to(device) for x in out))


class GspmdDLRM:
    """Row-sharded training and evaluation on one rank of a ("data",
    "model") grid (parallel/mesh.py::make_mesh; every rank calls every
    method, in one order). hot_sizes: each table's real hot size, for the
    flat per-hit batch layout (None: the padded [T, B, H] layout)."""

    def __init__(self, model: DLRMModel, mesh: RankMesh, device="cuda",
                 hot_sizes: Optional[Sequence[int]] = None):
        self.model = model
        self.mesh = mesh
        self.device = resolve_device(device)
        self.hot_sizes = (None if hot_sizes is None
                          else tuple(int(h) for h in hot_sizes))
        self.world = world_axis(mesh.model_axis.stage)

    def _put_row_sharded(self, leaf) -> torch.Tensor:
        """This rank's block of rows of `leaf`, on the device: the rows
        padded with zeros to a multiple of the model axis's size, then
        split evenly (the padded rows are index-unreachable, so lookups and
        updates never touch them)."""
        leaf = torch.as_tensor(leaf)
        block = -(-leaf.shape[0] // self.mesh.msize)
        lo = self.mesh.m * block
        out = torch.zeros((block,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                          device=self.device)
        rows = leaf[lo: lo + block]
        out[: rows.shape[0]] = rows.to(self.device)
        return out

    def _shard_tree(self, tree):
        def put(path, leaf):
            if not isinstance(leaf, (torch.Tensor, np.ndarray)):
                return leaf  # static leaves, the host step count
            if _is_row_shardable(path, leaf):
                return self._put_row_sharded(leaf)
            return torch.as_tensor(leaf).to(self.device, copy=True)

        return tree_map_with_path(put, tree)

    def shard_params(self, params):
        """A single-device params tree (every rank's the same, any device)
        -> this rank's: its blocks of the row-shardable leaves, copies of
        the rest, on its device."""
        return self._shard_tree(params)

    def shard_opt_state(self, opt_state):
        """A single-device optimizer state (optim.optimizers.init_opt_state,
        a checkpoint's) -> this rank's, as shard_params lays out params."""
        return self._shard_tree(opt_state)

    def unshard_params(self, params, template):
        """Back to host tensors with the template's (unpadded) shapes on
        every rank: the blocks all-gathered over "model"."""

        def get(path, leaf, t):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if _is_row_shardable(path, leaf):
                leaf = self.mesh.model_axis.all_gather(
                    leaf.detach().contiguous()).flatten(0, 1)
            return leaf.detach().cpu()[
                tuple(slice(0, s) for s in np.shape(t))].clone()

        return tree_map_with_path(get, params, template)

    def shard_batch(self, batch: Batch) -> Batch:
        """The global batch -> this rank's slice on the device (batch_slice
        of slice d * model + m of data * model)."""
        return batch_slice(batch, self.mesh.batch_index,
                           self.mesh.dsize * self.mesh.msize,
                           self.hot_sizes, self.device)

    def _view(self, params):
        """The params tree the model reads: each row-shardable block
        wrapped as a RowShardedTable over "model"."""
        return tree_map_with_path(
            lambda path, p: (RowShardedTable(p, self.mesh.model_axis)
                             if _is_row_shardable(path, p) else p), params)

    def _grads(self, params, batch: Batch):
        """(global loss, this slice's probs, this rank's grads tree)."""
        model = self.model
        count = torch.clamp(self.world.all_reduce(
            valid_count(batch.labels).reshape(1)), min=1.0)[0]
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            probs, logits = model.apply_with_logits(
                self._view(leaves), batch, self.hot_sizes)
            loss = masked_mean(
                per_example_loss(model.cfg, probs, batch.labels, logits),
                batch.labels, denom=count)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        rows = tree_leaves(tree_map_with_path(_is_row_shardable, leaves))
        dense = [i for i, r in enumerate(rows) if not r]
        blocks = [i for i, r in enumerate(rows) if r]
        summed = flat_all_reduce(
            self.world,
            [loss.detach().reshape(1)] + [grads[i] for i in dense],
            dtype=torch.float32)
        for i, g in zip(dense, summed[1:]):
            grads[i] = g
        if blocks:
            for i, g in zip(blocks, flat_all_reduce(
                    self.mesh.data_axis, [grads[i] for i in blocks],
                    dtype=torch.float32)):
                grads[i] = g
        it = iter(grads)
        return summed[0][0], probs.detach(), tree_map(lambda _: next(it),
                                                      leaves)

    def make_train_step(self, optimizer: str, eps: float = None):
        """train_step(params, opt_state, batch, lr) -> (params, opt_state,
        loss, probs): this rank's trees (from shard_params and
        shard_opt_state) updated in place, the global batch's mean loss
        (the same on every rank) and the probs of this rank's slice."""
        eps = ADAGRAD_EPS if eps is None else float(eps)

        def train_step(params, opt_state, batch: Batch, lr: float):
            loss, probs, grads = self._grads(params, batch)
            apply_updates(optimizer, params, grads, opt_state.get("accum"),
                          lr, eps=eps)
            opt_state["step"] += 1
            return params, opt_state, loss, probs

        return train_step

    def make_eval_step(self):
        """eval_step(params, batch) -> probs [b, 1] of this rank's slice."""

        @torch.no_grad()
        def eval_step(params, batch: Batch):
            return self.model.apply(self._view(params), batch,
                                    self.hot_sizes)

        return eval_step


# ------------------------------------------------------------------ serving


def shard_batch(hb, device) -> Batch:
    """A global padded HostBatch -> this rank's slice of its rows on
    `device`."""
    if hb.idx.ndim != 3:
        raise ValueError("quantized serving takes padded [T, B, H] batches")
    b, world = hb.dense.shape[0], world_size()
    if b % world:
        raise ValueError(f"the batch of {b} rows does not split over "
                         f"{world} ranks")
    n = b // world
    rows = slice(rank() * n, (rank() + 1) * n)
    return dataclasses.replace(
        hb, dense=hb.dense[rows], idx=hb.idx[:, rows],
        wt=None if hb.wt is None else hb.wt[:, rows],
        labels=hb.labels[rows]).to_device(device)


def make_eval_step(model, world: Axis):
    """eval_step(params, batch) -> probs of this rank's slice, each
    activation quantization's max |x| taken over the `world` axis."""
    import torch.distributed as dist

    step = model_eval_step(model)

    def global_max(amax):
        return world.all_reduce(amax.reshape(1), op=dist.ReduceOp.MAX)[0]

    def eval_step(params, batch):
        with Q.activation_amax_over(global_max):
            return step(params, batch)

    return eval_step
