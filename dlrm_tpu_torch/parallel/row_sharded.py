"""A table split by rows over the ranks of one axis, and its lookup with
the lookup's gradient (the gather from a P("model") operand that XLA's SPMD
partitioner derives in the JAX package's GspmdDLRM, written out).

Member i of the axis holds rows [i * n, (i + 1) * n) of the table, n rows a
member, the last blocks padded past the table's end with rows no index
reaches. Every member looks up rows for its own batch slice; the slices
have one shape on every member. A lookup of RowShardedTable t:

    forward   every member's indices (and weights) are all-gathered; each
              member answers every request from its own block, with the
              hits on other blocks weighted 0 (mapped to its row 0), and
              the partial answers are reduce-scattered back by request: a
              member gets the sum of every block's answer to its own
    backward  the answers' cotangents are all-gathered; each member
              back-propagates every request through its own block, so its
              block takes the gradient of its own rows from every member's
              batch (a weight-0 hit adds 0 to row 0), and the weights'
              cotangents are reduce-scattered back by request

Two lookups are answered: F.embedding_bag(idx, t, ..., mode="sum") (the
table dispatches it through __torch_function__, so ops/embedding.py's
embedding_bag and pool_flat_rows and the model around them run as they
are) and indexing, t[idx] (a v_w leaf's per-hit weights). Any other torch
function on the table raises. An answer is exact where one block holds
every hit of a bag (indexing, a one-hot bag); a bag whose hits span blocks
is summed block by block and then over the blocks, so it differs from one
device's sum by fp32 rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlrm_tpu_torch.parallel.collectives import Axis


class _AllGather(torch.autograd.Function):
    """x -> [size, *x.shape], every member's; the gradient is the
    reduce-scatter of the cotangent (each member's chunk summed over the
    members)."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return axis.all_gather(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g.contiguous()), None


class _ReduceScatter(torch.autograd.Function):
    """x [size, ...] -> the members' sum of chunk [index]; the gradient is
    the all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return axis.reduce_scatter(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g.contiguous()), None


class RowShardedTable:
    """This member's block `shard` [n, ...] of a table split by rows over
    `axis` (rows [index * n, (index + 1) * n) of it). Under autograd the
    block is the leaf: a lookup's gradient reaches it and nothing else."""

    def __init__(self, shard: torch.Tensor, axis: Axis):
        self.shard = shard
        self.axis = axis
        self.lo = axis.index * shard.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.shard.dtype

    def detach(self) -> "RowShardedTable":
        return RowShardedTable(self.shard.detach(), self.axis)

    def _requests(self, idx: torch.Tensor):
        """Every member's indices, [size, *idx.shape], as rows of this
        block (0 where another block holds the row) and the mask of the
        hits this block holds."""
        rows = self.axis.all_gather(idx.contiguous()).long() - self.lo
        own = (rows >= 0) & (rows < self.shard.shape[0])
        # the indices' own dtype: embedding_bag's offsets share it
        return torch.where(own, rows, 0).to(idx.dtype), own

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        """The table's rows at `idx` (global row numbers), [*idx.shape,
        ...]."""
        rows, own = self._requests(idx)
        mask = own.reshape(own.shape + (1,) * (self.shard.dim() - 1))
        return _ReduceScatter.apply(self.shard[rows] * mask.to(self.dtype),
                                    self.axis)

    def embedding_bag(self, idx: torch.Tensor, kwargs: dict) -> torch.Tensor:
        """F.embedding_bag(idx, table, **kwargs) (mode "sum"; idx [B, H], or
        flat hits with offsets that every member shares)."""
        if kwargs.get("mode", "mean") != "sum":
            raise NotImplementedError(
                "a row-sharded table pools with mode='sum' only")
        rows, own = self._requests(idx)
        mask = own.to(self.dtype)
        wt = kwargs.get("per_sample_weights")
        if wt is not None:
            mask = _AllGather.apply(wt, self.axis) * mask
        parts = torch.stack([
            F.embedding_bag(rows[i], self.shard,
                            **dict(kwargs, per_sample_weights=mask[i]))
            for i in range(self.axis.size)])
        return _ReduceScatter.apply(parts, self.axis)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is F.embedding_bag and isinstance(args[1], cls):
            return args[1].embedding_bag(args[0], dict(kwargs or {}))
        raise NotImplementedError(
            f"{getattr(func, '__name__', func)} on a row-sharded table: it "
            "answers F.embedding_bag and indexing only")
