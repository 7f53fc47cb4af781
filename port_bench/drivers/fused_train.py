"""The loop of a training cell on the fused step: train/fused_step.py as the
DLRM-v2 trainer builds it on one card under --embedding_impl fused
(dlrm_tpu_torch/v2_main.py::_single_device: make_fused_train_step, fp32
tables in the plain stacked layout, the sort and coalesce_rows, then
row_scatter_add and the row accumulators; the flat per-hit batch), fed by
the program's DevicePrefetcher through HostBatch.to_device.

The model is the configuration's "model" entry: "interaction" "projection"
(torchrec's DLRM_Projection, the two branches' layer sizes) or "dcn"
(DLRM-v2's cross layers), held to reference/dlrm_proj_ref.py or
reference/dlrm_ref.py and counted by roofline/work_proj.py or
roofline/work.py. A program whose config lacks the entry's fields raises
before anything is drawn.

Set-up: the model; the dense parameters and the tables drawn on the card
from the seed (the tables as drivers/train.py draws them, in the fused
step's unpadded layout); a pool of host batches from the traffic's
generator; then the first steps and a short warm-up through the window's
own feed and call. Window, traced run and the comparison with the
reference are drivers/train.py's, whose helpers this driver shares: the
rate is the examples of every step started in the window over the time to
the synchronize that closes it; a traced run also reads the device time of
the kernels under the program's interaction and table spans (scope_s).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from port_bench import core, program, tracing, weights
from port_bench.reference import compare, dlrm_proj_ref, dlrm_ref
from port_bench.roofline import work, work_proj

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
_TRAIN = core.load_module(ROOT, "drivers", "train")
FIRST_STEPS = _TRAIN.FIRST_STEPS
# the program's spans whose kernels a traced run times (utils/profiling.py)
SCOPES = ("DLRM interaction forward", "DLRM interaction backward",
          "DLRM table grads", "DLRM table update")


def model_of(mc: dict):
    """The program's model of a configuration's "model" entry."""
    from dlrm_tpu_torch.config import DCNConfig, DLRMConfig
    from dlrm_tpu_torch.models.dlrm import DLRMModel

    if mc["interaction"] == "dcn":
        kw = {"dcn": DCNConfig(num_layers=mc["dcn_num_layers"],
                               low_rank_dim=mc["dcn_low_rank_dim"])}
    else:
        kw = {k: tuple(mc[k]) for k in ("interaction_branch1_layer_sizes",
                                        "interaction_branch2_layer_sizes")}
    return DLRMModel(DLRMConfig(
        embedding_dim=mc["embedding_dim"],
        table_sizes=tuple(mc["table_sizes"]),
        mlp_bot=tuple(mc["mlp_bot"]), mlp_top=tuple(mc["mlp_top"]),
        interaction=mc["interaction"], loss=mc["loss"],
        num_indices_per_lookup=max(mc["hot_sizes"]),
        compute_dtype=mc["compute_dtype"], **kw))


def draw_dense(mc: dict, seed: int, dev) -> Dict[str, list]:
    """The dense parameters: weights.draw_dense's for dcn; for projection
    every tower and branch layer as torchrec's nn.Linear draws it, W and b
    ~ U(-1/sqrt(n_in), 1/sqrt(n_in)), fp32, from the same generator."""
    if mc["interaction"] == "dcn":
        return weights.draw_dense(mc, seed, dev)
    gen = weights.generator(dev, seed, weights.DENSE)
    d = mc["embedding_dim"]
    fd = d * (len(mc["table_sizes"]) + 1)
    b1 = list(mc["interaction_branch1_layer_sizes"])
    b2 = list(mc["interaction_branch2_layer_sizes"])

    def uniform(shape, n_in):
        u = torch.rand(shape, generator=gen, device=dev)
        return (2.0 * u - 1.0) / math.sqrt(n_in)

    def tower(sizes):
        return [{"w": uniform((i, o), i), "b": uniform((o,), i)}
                for i, o in zip(sizes[:-1], sizes[1:])]

    return {"bot": tower(list(mc["mlp_bot"])),
            "proj_branch1": tower([fd] + b1),
            "proj_branch2": tower([fd] + b2),
            "top": tower([d + (b1[-1] // d) * (b2[-1] // d)]
                         + list(mc["mlp_top"]))}


def tree_to(tree: dict, dev) -> dict:
    """The dense parameters (every entry but "emb") as fp32 copies."""
    return {k: [{n: t.detach().to(dev, copy=True).float()
                 for n, t in layer.items()} for layer in v]
            for k, v in tree.items() if k != "emb"}


def run(cell: core.Cell, seed: int, seconds: float, trace: bool,
        dev: torch.device, stages: core.Stages,
        fault: Optional[Callable] = None, control: bool = False) -> dict:
    """fault: wraps the program's step (tests break the timed path with
    it). control: also hold the reference in fp8 (the control) to the fp32
    one, as the program is held, under "control"."""
    from dlrm_tpu_torch.optim.optimizers import init_opt_state
    from dlrm_tpu_torch.train.fused_step import make_fused_train_step

    mc, pc, tr = cell.config["model"], cell.config["path"], cell.traffic
    sizes, hot, d = mc["table_sizes"], mc["hot_sizes"], mc["embedding_dim"]
    b = int(tr["batch"])
    if pc["table_dtype"] != "float32":
        raise ValueError("the fused step keeps fp32 tables")
    ref_mod = dlrm_proj_ref if mc["interaction"] == "projection" else dlrm_ref
    net = model_of(mc)
    offs = net.row_offsets.tolist()
    stages.mark("model")

    params = draw_dense(mc, seed, dev)
    params["emb"] = {"stacked": weights.draw_tables(
        sizes, offs, net.total_rows, d, torch.float32, seed, dev)}
    opt = init_opt_state(pc["optimizer"], params)
    step = make_fused_train_step(net, pc["optimizer"], eps=pc["eps"],
                                 hot_sizes=hot)
    if fault is not None:
        step = fault(step)
    _TRAIN.sync(dev)
    stages.mark("weights on the device")

    raw = cell.generator().pool(tr, sizes, hot, mc["mlp_bot"][0], seed)
    host = [program.host_batch(r) for r in raw]
    stages.mark("host batches")

    # what the reference starts from: the rows the first steps touch, and
    # the dense parameters, as drawn
    first = raw[:FIRST_STEPS]
    touched = _TRAIN.touched_rows(first, hot)
    ids = torch.cat([torch.from_numpy(t).long() + o
                     for t, o in zip(touched, offs)]).to(dev)
    table = params["emb"]["stacked"]
    rows0 = table.index_select(0, ids).cpu()
    dense0 = tree_to(params, "cpu")
    stages.mark("the first steps' rows and the dense parameters copied out")

    tracing_on = [False]
    to_device_calls: List[tuple] = []

    def to_device(hb):
        t = time.perf_counter()
        with tracing.span("bench.to_device", tracing_on[0]):
            out = hb.to_device(dev, flat_hots=hot)
        to_device_calls.append((t, time.perf_counter() - t))
        return out

    loader = (host[i % len(host)] for i in itertools.count())
    feed = iter(program.DevicePrefetcher(
        loader, to_device, depth=pc["prefetch_depth"], device=dev))
    lr = float(pc["learning_rate"])
    prog: Dict[str, object] = {"loss": [], "grad": {}, "change": {}}
    for k in range(FIRST_STEPS):
        params, opt, loss, probs = step(params, opt, next(feed), lr)
        prog["loss"].append(float(loss))
        if k == 0:
            prog["probs"] = probs.detach().float().cpu()
            acc = opt["accum"]
            for name, a in ref_mod.leaves(acc).items():
                prog["grad"][name] = float(torch.sqrt(a.double().sum()))
            flat = acc["emb"]["stacked"].view(-1)
            for t, (o, n) in enumerate(zip(offs, sizes)):
                prog["grad"][f"emb.{t}"] = float(
                    torch.sqrt(d * flat[o: o + n].double().sum()))
    for name, v in ref_mod.leaves(params).items():
        prog["change"][name] = float(torch.linalg.vector_norm(
            v.detach().cpu().double()
            - ref_mod.leaves(dense0)[name].double()))
    split = np.cumsum([len(t) for t in touched])[:-1].tolist()
    parts0 = torch.tensor_split(rows0, split)
    for t, (part, ids_t) in enumerate(zip(parts0, torch.tensor_split(
            ids, split))):
        prog["change"][f"emb.{t}"] = _TRAIN.change_norm(table, ids_t, part)
    del ids
    stages.mark("first steps")
    for _ in range(int(pc["warmup_steps"])):
        params, opt, _, _ = step(params, opt, next(feed), lr)
    _TRAIN.sync(dev)
    stages.mark("warm-up steps")

    done = FIRST_STEPS + int(pc["warmup_steps"])
    trace_dir = tempfile.mkdtemp(prefix="port_bench_trace_") if trace else None
    profiler = (program.profiling.profile(True, trace_dir) if trace
                else contextlib.nullcontext())
    tracing_on[0] = trace
    count = 0
    batch = None
    gc.collect()
    gc.freeze()
    with profiler:
        with tracing.span(tracing.WINDOW, trace):
            t_start = time.perf_counter()
            ends = [_TRAIN.stamp(dev)]
            while time.perf_counter() - t_start < seconds and not (
                    trace and count >= int(pc["trace_steps"])):
                with tracing.span("bench.next_batch", trace):
                    batch = next(feed)
                with tracing.span("bench.step", trace):
                    params, opt, _, _ = step(params, opt, batch, lr)
                ends.append(_TRAIN.stamp(dev))
                count += 1
            with tracing.span("bench.sync", trace):
                _TRAIN.sync(dev)
            t_end = time.perf_counter()
    tracing_on[0] = False
    gc.unfreeze()
    setup_s = t_start - stages.t0
    calls = [s for t, s in to_device_calls if t_start <= t < t_end]
    print(f"window {t_end - t_start:.3f} s, {count} steps, {len(calls)} "
          f"to_device calls begun in it, {sum(calls):.3f} s in them",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps_ms = [_TRAIN.elapsed_ms(a, c) for a, c in zip(ends[:-1], ends[1:])]
    e2e = {"train_examples_per_s": count * b / (t_end - t_start),
           "train_step_p95_ms": float(np.percentile(steps_ms, 95)),
           "setup_s": setup_s}
    feed.close()
    del feed, params, opt, step, table, batch, host
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = None
    if trace:
        summary = tracing.summarize(
            os.path.join(trace_dir, program.profiling.TRACE_FILE), count,
            SCOPES)
        shutil.rmtree(trace_dir, ignore_errors=True)
        summary.kind = "train"
        summary.host_ms["to_device"] = [s * 1e3 for s in calls]
        used = [raw[(done + j) % len(raw)] for j in range(count)]
        summary.work.update(step_work(mc, used))

    def reference(quant, dense=dense0):
        return _reference(ref_mod, first, parts0, touched, dense, lr,
                          float(pc["eps"]), hot, dev, quant)

    ref = reference("fp32")
    numbers = compare.train_numbers(prog, ref)
    checks = core.Checks(cell.limits)
    for k, v in numbers.items():
        checks.add(k, v)
    out = {"attempted": count, "failed": 0, "e2e": e2e, "summary": summary,
           "checks": checks, "memory_peak_bytes": peak,
           "worst": dict(compare.worst_leaves(prog, ref),
                         loss_gaps=compare.loss_gaps(prog, ref))}
    if control:
        ref8 = reference("fp8")
        out["control"] = compare.train_numbers(ref8, ref)
        # the look at the later steps' loss: the reference again from the
        # dense parameters rounded once to bf16, against itself
        nudged = {k: [{n: t.to(torch.bfloat16).float() for n, t in
                       layer.items()} for layer in v]
                  for k, v in dense0.items()}
        out["look"] = {"control_loss_gaps": compare.loss_gaps(ref8, ref),
                       "nudged_loss_gaps": compare.loss_gaps(
                           reference("fp32", nudged), ref)}
    return out


def _reference(ref_mod, first: List[dict], rows0: List[torch.Tensor],
               touched: List[np.ndarray], dense0: dict, lr: float,
               eps: float, hot, dev, quant: str) -> dict:
    """The reference over the first steps' batches, from the rows they
    touch (as drawn) and the dense parameters (as drawn)."""
    ref_mod.exact_matmuls()
    local = [[] for _ in first]
    for t, (c, h) in enumerate(zip(core.hot_columns(hot), hot)):
        blocks = [torch.from_numpy(r["idx"][:, c: c + h].astype(np.int64))
                  .to(dev) for r in first]
        rows_t, pos = ref_mod.touched(blocks)
        if not np.array_equal(rows_t.cpu().numpy(), touched[t]):
            raise RuntimeError(f"table {t}: the touched rows disagree")
        for k, p in enumerate(pos):
            local[k].append(p)
    return ref_mod.train(
        [r.to(dev).float() for r in rows0], local, tree_to(dense0, dev),
        [torch.from_numpy(r["dense"]).to(dev) for r in first],
        [torch.from_numpy(r["labels"]).to(dev) for r in first], lr, eps,
        quant)


def step_work(mc: dict, used: List[dict]) -> Dict[str, float]:
    """The yardstick's operations and bytes over the traced steps: the
    model's FLOPs, the step's compulsory bytes (fp32 rows), and for the
    projection its interaction's FLOPs."""
    proj = mc["interaction"] == "projection"
    counts = work_proj if proj else work
    hot, d = mc["hot_sizes"], mc["embedding_dim"]
    b = used[0]["idx"].shape[0]
    distinct: Dict[int, int] = {}
    flops = nbytes = 0.0
    for r in used:
        if id(r) not in distinct:
            distinct[id(r)] = sum(len(t) for t in _TRAIN.touched_rows([r],
                                                                      hot))
        flops += counts.model_flops(mc, b, train=True)
        nbytes += counts.step_bytes(mc, b, distinct[id(r)], True, 4 * d)
    out = {"flops": flops, "bytes": nbytes}
    if proj:
        out["proj_flops"] = work_proj.interaction_flops(
            mc, b, train=True) * len(used)
    return out
