"""The port's counterpart of __graft_entry__.py: the flagship forward at full
width (entry) and the multi-rank sharding dry run (dryrun_multichip).

    fwd, (params, batch) = entry()          # on the card
    probs = fwd(params, batch)
    dryrun_multichip(4)                      # 4 ranks, one step of each leg

entry(device="cpu") and dryrun_multichip(n, device="cpu") run on the CPU
(the tests do; the ranks join over gloo). On the card dryrun_multichip runs
a rank a card over NCCL where there are n cards, else n ranks sharing the
card over gloo with every collective staged through host memory. Each rank
is a process of its own (parallel/launch.py::run_ranks): a script that
calls dryrun_multichip needs an `if __name__ == "__main__":` guard, since
the ranks import the main module again.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import re

import numpy as np
import torch

LEGS = (
    "fused butterfly",
    "stream butterfly",
    "mixed-plan butterfly",
    "striped stream butterfly",
    "bucketed striped stream butterfly",
    "owner-bucketed mixed butterfly",
    "hybrid-mesh mixed butterfly",
    "column-wise butterfly",
    "cli.main --sharded",
    "v2_main.main --sharded",
)
# the kernels the legs launch on the card (stream_kernels.LAUNCHES' keys)
COUNTED = ("stream_update", "coalesce_rows", "row_scatter_add")
_LOSS = re.compile(r"loss (\d+\.\d+)")


def _flagship_cfg(small: bool = False):
    """DLRM-v2-like flagship: 26 Criteo sparse features, 128-dim tables,
    multi-hot lookups, dot interaction (torchrec_dlrm/dlrm_main.py:581-635)."""
    from dlrm_tpu_torch.config import DLRMConfig

    if small:
        return DLRMConfig(
            embedding_dim=8,
            table_sizes=(40, 24, 16, 60, 12, 8, 20, 36),
            mlp_bot=(13, 16, 8),
            mlp_top=(16, 8, 1),
            interaction="dot",
            loss="bce",
            num_indices_per_lookup=4,
            compute_dtype="bfloat16",
        )
    return DLRMConfig(
        embedding_dim=128,
        table_sizes=tuple(int(n) for n in np.full(26, 200_000)),
        mlp_bot=(13, 512, 256, 128),
        mlp_top=(1024, 1024, 512, 256, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=8,
        compute_dtype="bfloat16",
    )


def entry(device="cuda"):
    """(fwd, (params, batch)): the flagship's forward at full width, its
    params from init_params(seed=0) and a batch of 1,024 with 8 hits a
    bag, on `device`."""
    from dlrm_tpu_torch.data.random_data import fixed_multihot_batch
    from dlrm_tpu_torch.device import resolve_device
    from dlrm_tpu_torch.models.dlrm import DLRMModel

    dev = resolve_device(device)
    cfg = _flagship_cfg()
    model = DLRMModel(cfg)
    params = model.init_params(seed=0, device=dev)
    hb = fixed_multihot_batch(
        np.random.default_rng(0),
        cfg.num_dense,
        cfg.table_sizes,
        batch_size=1024,
        hot_size=cfg.num_indices_per_lookup,
    )
    batch = hb.to_device(dev)

    def fwd(params, batch):
        with torch.no_grad():
            return model.apply(params, batch)

    return fwd, (params, batch)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _trainer_loss(main, argv, dev, what):
    """main(argv, device=dev) on this rank; the last loss it printed, on
    rank 0 (the only rank that prints; the others return None)."""
    import torch.distributed as dist

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, device=dev)
    _check(rc == 0, f"{what} returned {rc}")
    if dist.get_rank() != 0:
        return None
    found = _LOSS.findall(buf.getvalue())
    _check(found, f"{what} printed no loss: {buf.getvalue()[-500:]!r}")
    return float(found[-1])


def _rank_legs(rank, n, device_type, staged):
    """One step of every leg of __graft_entry__.dryrun_multichip on this
    rank: [(leg, loss, loss after the step, launches of COUNTED)]. A
    butterfly leg's loss after its step is a second step's loss on the same
    batch, so that the update shows in what the leg returns; a trainer leg
    returns its last printed loss and None."""
    from dlrm_tpu_torch import cli, v2_main
    from dlrm_tpu_torch.config import DLRMConfig
    from dlrm_tpu_torch.configs.presets import CRITEO_1TB_COUNTS
    from dlrm_tpu_torch.data.random_data import (
        fixed_multihot_batch,
        ragged_multihot_batch,
    )
    from dlrm_tpu_torch.models.dlrm import DLRMModel
    from dlrm_tpu_torch.ops.stream_kernels import LAUNCHES
    from dlrm_tpu_torch.optim.optimizers import init_opt_state, tree_map
    from dlrm_tpu_torch.parallel.butterfly import ButterflyDLRM
    from dlrm_tpu_torch.parallel.mesh import make_mesh
    from dlrm_tpu_torch.parallel.rw_bucket import default_bucket_caps
    from dlrm_tpu_torch.parallel.stream_butterfly import StreamButterfly

    if device_type == "cuda":
        dev = torch.device("cuda", 0 if staged else rank)
        torch.cuda.set_device(dev)
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    else:
        # one thread a CPU rank: ranks whose threads outnumber the cores
        # spin against each other in their collectives
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    legs = []

    def leg(name, losses):
        loss, after = (losses if isinstance(losses, tuple)
                       else (losses, None))
        loss, after = (None if x is None else float(x)
                       for x in (loss, after))
        for x in (loss, after):
            _check(x is None or math.isfinite(x),
                   f"non-finite {name} loss {x}")
        legs.append((name, loss, after,
                     {k: LAUNCHES.get(k, 0) for k in COUNTED}))
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        return loss, after

    def two_steps(step, params, opt_state, batch):
        params, opt_state, loss, _ = step(params, opt_state, batch, 0.01)
        loss = float(loss)  # before the second step can reuse its buffer
        return loss, step(params, opt_state, batch, 0.01)[2]

    def init(model, seed):
        # drawn on the CPU, whose generator gives other numbers than the
        # card's, so that a run on the card and one on the CPU start from
        # the same params
        return tree_map(lambda t: t.to(dev),
                        model.init_params(seed=seed, device="cpu"))

    def fused_step(bf, model, seed, hb):
        full = init(model, seed)
        params = bf.shard_params(full)
        opt_state = bf.shard_opt_state(init_opt_state("rwsadagrad", full))
        step = bf.make_train_step("rwsadagrad", batch_size, params,
                                  opt_state)
        return two_steps(step, params, opt_state, bf.shard_batch(hb))

    def stream_step(sb, model, seed, hb):
        params = sb.shard_params(init(model, seed))
        opt_state = sb.init_opt_state("rwsadagrad", params)
        step = sb.make_train_step("rwsadagrad", batch_size, params,
                                  opt_state)
        return two_steps(step, params, opt_state, sb.shard_batch(hb))

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    # 1. the fused butterfly on the small flagship, table-wise
    cfg = _flagship_cfg(small=True)
    model = DLRMModel(cfg)
    data_ax = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(data=data_ax, model=n // data_ax, stage=staged)
    msize = mesh.msize
    batch_size = 8 * n
    hb = fixed_multihot_batch(
        np.random.default_rng(1), cfg.num_dense, cfg.table_sizes,
        batch_size=batch_size, hot_size=cfg.num_indices_per_lookup,
    )
    leg(LEGS[0], fused_step(ButterflyDLRM(model, mesh, device=dev), model,
                            0, hb))

    # 2. the streamed butterfly (K2) with SKEWED table sizes and RAGGED
    # per-table hot sizes
    cfg2 = DLRMConfig(
        embedding_dim=128,
        table_sizes=(2300, 120, 1280, 48, 990, 2050, 640, 72),
        mlp_bot=(13, 16, 128),
        mlp_top=(16, 8, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=4,
        compute_dtype="bfloat16",
    )
    hots2 = (4, 1, 3, 2, 4, 1, 2, 1)
    model2 = DLRMModel(cfg2)
    sb = StreamButterfly(model2, mesh, block_rows=1024,
                         batch_size=batch_size, hot_sizes=hots2, device=dev)
    hb2 = ragged_multihot_batch(
        np.random.default_rng(3), cfg2.num_dense, cfg2.table_sizes, hots2,
        batch_size,
    )
    leg(LEGS[1], stream_step(sb, model2, 2, hb2))

    # 3. the mixed plan on the SKEWED flagship shape: the CRITEO_1TB
    # row-count distribution scaled down 4096x, the outliers over the
    # capacity budget striped row-wise (torchrec_dlrm/README.MD:45-53)
    skewed = tuple(max(16, int(c) // 4096) for c in CRITEO_1TB_COUNTS)
    cfg3 = DLRMConfig(
        embedding_dim=32,
        table_sizes=skewed,
        mlp_bot=(13, 16, 32),
        mlp_top=(16, 8, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=4,
        compute_dtype="bfloat16",
    )
    model3 = DLRMModel(cfg3)
    cap = int(sum(skewed) / msize * 1.1)
    bf3 = ButterflyDLRM(model3, mesh, strategy="mixed", capacity_rows=cap,
                        device=dev)
    _check(bf3.num_rw > 0, "the skewed config must stripe row-wise")
    hb3 = fixed_multihot_batch(
        np.random.default_rng(5), cfg3.num_dense, cfg3.table_sizes,
        batch_size=batch_size, hot_size=cfg3.num_indices_per_lookup,
    )
    loss3 = leg(LEGS[2], fused_step(bf3, model3, 4, hb3))

    # 4. STRIPED stream slots on the same skew: the over-capacity tables
    # stream only their row slice on each shard
    hots4 = tuple(1 + (i * 7) % 8 for i in range(len(skewed)))
    cfg4 = DLRMConfig(
        embedding_dim=32,
        table_sizes=skewed,
        mlp_bot=(13, 16, 32),
        mlp_top=(16, 8, 1),
        interaction="dot",
        loss="bce",
        num_indices_per_lookup=max(hots4),
        compute_dtype="bfloat16",
    )
    model4 = DLRMModel(cfg4)
    sb4 = StreamButterfly(model4, mesh, block_rows=1024,
                          batch_size=batch_size, hot_sizes=hots4,
                          capacity_rows=cap, device=dev)
    _check(sb4.num_rw > 0, "the skewed config must stripe stream slots")
    hb4 = ragged_multihot_batch(
        np.random.default_rng(7), cfg4.num_dense, cfg4.table_sizes, hots4,
        batch_size,
    )
    loss4 = leg(LEGS[3], stream_step(sb4, model4, 6, hb4))

    # 5. OWNER-BUCKETED striped stream slots: each shard gathers only the
    # striped hits it owns; the same loss as the masked slots
    rw_hots4 = [int(sb4.hots_all[int(t)]) for t in sb4.rw_ids]
    sb7 = StreamButterfly(
        model4, mesh, block_rows=1024, batch_size=batch_size,
        hot_sizes=hots4, capacity_rows=cap,
        rw_bucket_caps=default_bucket_caps(rw_hots4, msize),
        rw_spill=max(4, max(rw_hots4) // msize + 2), device=dev,
    )
    _check(sb7.rw_bucket and sb7.num_rw > 0, "no bucketed stream slots")
    loss7 = leg(LEGS[4], stream_step(sb7, model4, 6, hb4))
    _check(max(abs(a - b) for a, b in zip(loss7, loss4)) < 1e-4,
           f"bucketed {loss7} != masked {loss4} striped-stream losses")

    # 6. OWNER-BUCKETED row-wise hits on the mixed plan of leg 3
    bf6 = ButterflyDLRM(
        model3, mesh, strategy="mixed", capacity_rows=cap,
        rw_bucket_caps=default_bucket_caps(
            [cfg3.num_indices_per_lookup] * bf3.num_rw, msize),
        device=dev,
    )
    _check(bf6.rw_bucket and bf6.num_rw > 0, "no bucketed row-wise tables")
    loss6 = leg(LEGS[5], fused_step(bf6, model3, 4, hb3))
    _check(max(abs(a - b) for a, b in zip(loss6, loss3)) < 1e-4,
           f"bucketed {loss6} != masked {loss3} mixed-plan losses")

    # 7. the HYBRID grid: two emulated nodes, the model axis (the per-step
    # all-to-all and reduce-scatter) inside a node, only the data axis
    # across them
    if n % 4 == 0:
        half = n // 2
        hmesh = make_mesh(data=n // 2, model=2,
                          node_ids=[0] * half + [1] * half, stage=staged)
        cap8 = int(sum(skewed) / hmesh.msize * 1.1)
        bf8 = ButterflyDLRM(model3, hmesh, strategy="mixed",
                            capacity_rows=cap8, device=dev)
        leg(LEGS[6], fused_step(bf8, model3, 4, hb3))

    # 8. COLUMN-WISE: the two largest tables split on the feature dim
    two_biggest = [int(t) for t in np.argsort(skewed)[-2:]]
    bf5 = ButterflyDLRM(model3, mesh, strategy="table_wise",
                        cw_tables=two_biggest, device=dev)
    _check(bf5.num_cw == 2, f"{bf5.num_cw} column-wise tables")
    leg(LEGS[7], fused_step(bf5, model3, 8, hb3))

    # 9-10. the REAL trainers' sharded wiring, as a user runs them
    leg(LEGS[8], _trainer_loss(cli.main, [
        "--mini-batch-size=8", "--data-size=16", "--sharded",
        "--optimizer=rwsadagrad", "--arch-sparse-feature-size=8",
        "--arch-embedding-size=40-24-16-60", "--arch-mlp-bot=13-16-8",
        "--arch-mlp-top=16-8-1", "--print-freq=1"], dev, LEGS[8]))
    leg(LEGS[9], _trainer_loss(v2_main.main, [
        "--limit_train_batches", "2", "--limit_val_batches", "1",
        "--limit_test_batches", "1", "--batch_size", str(batch_size),
        "--embedding_dim", "8", "--num_embeddings", "64",
        "--dense_arch_layer_sizes", "16,8",
        "--over_arch_layer_sizes", "16,8,1", "--adagrad",
        "--learning_rate", "0.05",
        "--sharded", "--mesh_data", str(data_ax)], dev, LEGS[9]))
    return legs


def dryrun_multichip(n_devices: int, device="cuda"):
    """One step of every leg of __graft_entry__.dryrun_multichip over
    n_devices ranks, at its shapes and with its checks; prints each leg's
    OK line with its loss (and a butterfly leg's loss after its step).
    Returns {"grid": (data, model), "backend": ..., "legs": [(leg, loss,
    loss after the step or None)], "launches": {leg: {kernel: launches
    summed over the ranks}}}."""
    from dlrm_tpu_torch.device import resolve_device
    from dlrm_tpu_torch.parallel.launch import run_ranks

    n = int(n_devices)
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend, staged = (("nccl", False)
                           if torch.cuda.device_count() >= n
                           else ("gloo", True))
    else:
        backend, staged = "gloo", False
    ranks = run_ranks(_rank_legs, n, args=(n, dev.type, staged),
                      backend=backend, timeout_s=600)
    data_ax = 2 if n % 2 == 0 and n >= 4 else 1
    names = [leg[0] for leg in ranks[0]]
    _check(names == [x for x in LEGS if n % 4 == 0 or "hybrid" not in x],
           f"legs {names}")
    legs, launches = [], {}
    for j, (name, loss, after, _) in enumerate(ranks[0]):
        if not name.endswith("--sharded"):  # the global loss on every rank
            others = [r[j][1:3] for r in ranks]
            _check(all(x == (loss, after) for x in others),
                   f"{name}: the ranks' losses differ: {others}")
        launches[name] = {k: sum(r[j][3][k] for r in ranks) for k in COUNTED}
        legs.append((name, loss, after))
        note = " (== masked)" if "bucketed" in name else ""
        then = "" if after is None else f" (after the step {after:.6f})"
        print(f"dryrun_multichip({n}): grid ({data_ax}x{n // data_ax}) "
              f"{name} loss={loss:.6f} OK{note}{then}", flush=True)
    return {"grid": (data_ax, n // data_ax), "backend": backend,
            "staged": staged, "legs": legs, "launches": launches}
