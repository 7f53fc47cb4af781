"""Multi-process support: process-group init and barriers (the port of
dlrm_tpu/parallel/multihost.py's init_multihost, barrier and
process_local_rank_stride).

The JAX package runs one controller per host and discovers its peers with
jax.distributed; the port runs one process per rank, as torchrun starts
them:

    python -m torch.distributed.run --nproc_per_node W \\
        -m dlrm_tpu_torch.v2_main --sharded ...

and reads torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR/MASTER_PORT), or takes an explicit
init_method (a file:// store, as the tests use). The backend is an explicit
argument: NCCL for ranks on CUDA cards, gloo on the CPU; gloo with CUDA
tensors (several ranks sharing one card, which NCCL refuses) is the
caller's choice, and then the collectives stage through host memory
(collectives.Axis).

The two input patterns of the JAX package's global_batch_from_* helpers,
with a rank holding what its device holds of a sharded array:
global_batch_from_replicated (every rank holds the whole global batch)
slices out this rank's shard of each field, with no collective;
global_batch_from_local_shard (every rank holds its own slice) all-gathers
the slices into the global batch on every rank. A field's spec is JAX's
PartitionSpec as a tuple: entry k names the mesh axis (or tuple of axes,
the first major) that dim k is split over, or None.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch


def world_size() -> int:
    """Ranks of this run: the process group's, else torchrun's WORLD_SIZE
    (1 when neither is set)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0") or 0)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size())
               or world_size())


def rank_device(device="cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for a plain "cuda", the given
    device otherwise (an explicit index, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def init_multihost(
    device="cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world: Optional[int] = None,
    rank_id: Optional[int] = None,
    timeout_s: float = 600.0,
) -> int:
    """Initialize the default process group for a multi-rank run; a no-op
    when the world has one rank or the group exists already. Returns this
    process's rank.

    backend: None picks NCCL for a CUDA device and gloo for the CPU.
    init_method: None reads torchrun's environment (env://)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    world = world_size() if world is None else int(world)
    if world <= 1:
        return 0
    rank_id = rank() if rank_id is None else int(rank_id)
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl" and dev.index is not None:
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world,
        rank=rank_id, timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )
    return rank_id


def barrier() -> None:
    """Every rank waits for the others (the JAX package's
    sync_global_devices); a no-op in a one-rank run."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def process_local_rank_stride(num_batches: int) -> range:
    """Batch indices this rank loads under round-robin assignment."""
    return range(rank(), num_batches, world_size())


def spec_axis(mesh, entry):
    """The collectives.Axis of a PartitionSpec entry over a
    parallel/mesh.py RankMesh: "data", "model", or a tuple of both (its
    members in the entry's order, the first name major: ("data", "model")
    is the batch order, member d * model + m)."""
    from dlrm_tpu_torch.parallel.collectives import Axis

    names = (entry,) if isinstance(entry, str) else tuple(entry)
    if names == ("data",):
        return mesh.data_axis
    if names == ("model",):
        return mesh.model_axis
    if sorted(names) != ["data", "model"]:
        raise ValueError(f"no mesh axis {entry!r}")
    grid = mesh.grid if names[0] == "data" else mesh.grid.T
    ranks = [int(r) for r in grid.reshape(-1)]
    if len(ranks) == 1:
        return Axis(None, ranks, 0)
    import torch.distributed as dist

    return Axis(dist.group.WORLD, ranks, ranks.index(mesh.rank),
                mesh.model_axis.stage)


def _fields(batch, specs: Sequence, fn, device):
    from dlrm_tpu_torch.data.batch import Batch

    def put(x, spec):
        if x is None:
            return None
        x = fn(x, spec)
        return x if device is None else x.to(device)

    return Batch(*(put(x, s) for x, s in zip(
        (batch.dense, batch.idx, batch.wt, batch.labels), specs)),
        stream=batch.stream)


def global_batch_from_replicated(mesh, batch, specs: Sequence, device=None):
    """Every rank holds the FULL global batch (the v1 pattern): this rank's
    shard of each field under its spec (dense, idx, wt, labels; the stream
    plan, replicated, as it is), cut out locally with no collective, on
    `device` (None: where the batch lies)."""

    def shard(x, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            ax = spec_axis(mesh, entry)
            if x.shape[dim] % ax.size:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {ax.size} ranks")
            n = x.shape[dim] // ax.size
            x = x.narrow(dim, ax.index * n, n)
        return x

    return _fields(batch, specs, shard, device)


def global_batch_from_local_shard(mesh, local, specs: Sequence, device=None):
    """Every rank holds only its slice of the global batch (the v2
    rank-strided pattern): the global batch on every rank, each field's
    slices all-gathered over its spec's axes (a collective every rank
    makes), on `device` (None: where the slices lie)."""

    def gather(x, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            ax = spec_axis(mesh, entry)
            g = ax.all_gather(x.contiguous()).movedim(0, dim)
            shape = list(x.shape)
            shape[dim] *= ax.size
            x = g.reshape(shape)
        return x

    return _fields(local, specs, gather, device)
