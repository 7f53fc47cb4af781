"""The loop of a training cell: the streamed train step as the DLRM-v2
trainer builds it on one card (dlrm_tpu_torch/v2_main.py::_single_device:
make_stream_train_step with the gather grads, bf16 operands, stochastic
rounding into bf16 tables, the touched-only K2 item list), fed by the
program's DevicePrefetcher through HostBatch.to_device.

Set-up: the model and its plan; the dense parameters and the padded tables
drawn on the card from the seed; a pool of host batches from the traffic's
generator, each with its U-layout work built as a deployment's loader
workers build it ahead of the card; then the first steps and a short
warm-up through the window's own feed and call. The object those steps
leave is the one the window drives.

Window: batches cycle through the pool; each goes through the prefetcher's
H2D and into the step, and a CUDA event closes each step. The rate is the
examples of every step started in the window over the time to the
synchronize that closes it; the tail is over the intervals between
consecutive step-end events. A traced run (--trace 1) instead profiles a
bounded stretch of steps with the program's profiler on.

Correctness (reference/compare.py): the plain reference follows the first
three steps from the rows those batches touch and the dense parameters, as
drawn, and is held to the program's losses, first probabilities, first
gradient (from its accumulators after one step) and change after three
steps. It runs once the window has closed, the peak memory has been read
and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from port_bench import core, program, tracing, weights
from port_bench.reference import compare, dlrm_ref
from port_bench.roofline import work

FIRST_STEPS = 3
CHUNK = 256  # U-slots a K2 work item covers (ops/stream_plan.py CHUNK)


def stamp(dev):
    if dev.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def elapsed_ms(a, b) -> float:
    if isinstance(a, torch.cuda.Event):
        return a.elapsed_time(b)
    return (b - a) * 1e3


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def touched_rows(raw: List[dict], hot) -> List[np.ndarray]:
    """Per table, the sorted distinct rows that the batches hit."""
    return [np.unique(np.concatenate([r["idx"][:, c: c + h].ravel()
                                      for r in raw]))
            for c, h in zip(core.hot_columns(hot), hot)]


def change_norm(table: torch.Tensor, ids: torch.Tensor,
                rows0: torch.Tensor, chunk: int = 1 << 20) -> float:
    """||table[ids] - rows0|| in fp64, on the table's device, a chunk of
    rows at a time."""
    total = 0.0
    for i in range(0, ids.numel(), chunk):
        now = table.index_select(0, ids[i: i + chunk]).double()
        was = rows0[i: i + chunk].to(table.device).double()
        total += float(((now - was) ** 2).sum())
    return total ** 0.5


def tree_to(tree: dict, dev) -> dict:
    return {k: [{n: t.detach().to(dev, copy=True).float()
                 for n, t in layer.items()} for layer in tree[k]]
            for k in ("bot", "dcn", "top")}


def run(cell: core.Cell, seed: int, seconds: float, trace: bool,
        dev: torch.device, stages: core.Stages,
        fault: Optional[Callable] = None, control: bool = False) -> dict:
    """fault: wraps the program's step (tests break the timed path with
    it). control: also hold the reference in fp8 (the control) to the fp32
    one, as the program is held, under "control"."""
    mc, pc, tr = cell.config["model"], cell.config["path"], cell.traffic
    sizes, hot, d = mc["table_sizes"], mc["hot_sizes"], mc["embedding_dim"]
    b = int(tr["batch"])
    net = program.model(mc)
    plan = program.plan_for_model(net, b, block_rows=pc["block_rows"],
                                  hot_sizes=hot)
    offs, rows = weights.padded_layout(sizes, pc["block_rows"])
    if tuple(offs) != tuple(plan.padded_offsets) or rows != plan.padded_rows:
        raise RuntimeError("the program's padded table layout is not the "
                           "one the benchmark draws")
    stages.mark("model and plan")

    params = weights.draw_dense(mc, seed, dev)
    params["emb"] = {"stacked": weights.draw_tables(
        sizes, offs, rows, d, getattr(torch, pc["table_dtype"]), seed, dev)}
    opt = program.init_stream_opt_state(pc["optimizer"], params, plan)
    step = program.make_stream_train_step(
        net, pc["optimizer"], plan, grad_impl=pc["grad_impl"],
        mm_dtype=getattr(torch, pc["mm_dtype"]),
        stochastic_round=pc["stochastic_round"], eps=pc["eps"], device=dev)
    if fault is not None:
        step = fault(step)
    sync(dev)
    stages.mark("weights on the device")

    raw = cell.generator().pool(tr, sizes, hot, mc["mlp_bot"][0], seed)
    host = [program.host_batch(r).with_stream_work(
        plan, unit_weights=pc["unit_weights"],
        update_touched_only=pc["update_touched_only"]) for r in raw]
    stages.mark("host batches and their U-layout work")

    # what the reference starts from: the rows the first steps touch, and
    # the dense parameters, as drawn
    first = raw[:FIRST_STEPS]
    idx = [torch.from_numpy(r["idx"]).to(dev) for r in first]
    touched_dev = [torch.unique(torch.cat(
        [x[:, c: c + h].reshape(-1) for x in idx])).long()
        for c, h in zip(core.hot_columns(hot), hot)]
    touched = [t.cpu().numpy() for t in touched_dev]
    ids = torch.cat([t + o for t, o in zip(touched_dev, offs)])
    del idx, touched_dev
    table = params["emb"]["stacked"]
    stages.mark("the rows the first steps touch")
    rows0 = table.index_select(0, ids).cpu()
    dense0 = tree_to(params, "cpu")
    stages.mark("their rows and the dense parameters copied out")

    tracing_on = [False]
    to_device_calls: List[tuple] = []

    def to_device(hb):
        t = time.perf_counter()
        with tracing.span("bench.to_device", tracing_on[0]):
            out = hb.to_device(dev, flat_hots=plan.hot)
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
            for name, a in dlrm_ref.leaves(acc).items():
                prog["grad"][name] = float(torch.sqrt(a.double().sum()))
            flat = acc["emb"]["stacked"].view(-1)
            for t, (o, n) in enumerate(zip(offs, sizes)):
                prog["grad"][f"emb.{t}"] = float(
                    torch.sqrt(d * flat[o: o + n].double().sum()))
    for name, v in dlrm_ref.leaves(params).items():
        prog["change"][name] = float(torch.linalg.vector_norm(
            v.detach().cpu().double()
            - dlrm_ref.leaves(dense0)[name].double()))
    split = np.cumsum([len(t) for t in touched])[:-1].tolist()
    parts0 = torch.tensor_split(rows0, split)
    for t, (part, ids_t) in enumerate(zip(parts0, torch.tensor_split(
            ids, split))):
        prog["change"][f"emb.{t}"] = change_norm(table, ids_t, part)
    del ids
    stages.mark("first steps")
    for _ in range(int(pc["warmup_steps"])):
        params, opt, _, _ = step(params, opt, next(feed), lr)
    sync(dev)
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
            ends = [stamp(dev)]
            while time.perf_counter() - t_start < seconds and not (
                    trace and count >= int(pc["trace_steps"])):
                with tracing.span("bench.next_batch", trace):
                    batch = next(feed)
                with tracing.span("bench.step", trace):
                    params, opt, _, _ = step(params, opt, batch, lr)
                ends.append(stamp(dev))
                count += 1
            with tracing.span("bench.sync", trace):
                sync(dev)
            t_end = time.perf_counter()
    tracing_on[0] = False
    gc.unfreeze()
    setup_s = t_start - stages.t0
    calls = [d for t, d in to_device_calls if t_start <= t < t_end]
    print(f"window {t_end - t_start:.3f} s, {count} steps, {len(calls)} "
          f"to_device calls begun in it, {sum(calls):.3f} s in them",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps_ms = [elapsed_ms(a, c) for a, c in zip(ends[:-1], ends[1:])]
    med = float(np.median(steps_ms))
    slow = [i for i, ms in enumerate(steps_ms) if ms > 1.2 * med]
    print(f"steps over 1.2x the median ({med:.3f} ms): "
          f"{len(slow)}, the first at {slow[:1]}, the last at {slow[-1:]}",
          file=sys.stderr)
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
            os.path.join(trace_dir, program.profiling.TRACE_FILE), count)
        shutil.rmtree(trace_dir, ignore_errors=True)
        summary.kind = "train"
        summary.host_ms["to_device"] = [d * 1e3 for d in calls]
        used = [raw[(done + j) % len(raw)] for j in range(count)]
        summary.work.update(step_work(mc, plan, used, pc))

    ref = reference(first, parts0, touched, dense0, lr, float(pc["eps"]),
                    hot, dev, "fp32")
    numbers = compare.train_numbers(prog, ref)
    checks = core.Checks(cell.limits)
    for k, v in numbers.items():
        checks.add(k, v)
    out = {"attempted": count, "failed": 0, "e2e": e2e, "summary": summary,
           "checks": checks, "memory_peak_bytes": peak,
           "worst": dict(compare.worst_leaves(prog, ref),
                         loss_gaps=compare.loss_gaps(prog, ref))}
    if control:
        ref8 = reference(first, parts0, touched, dense0, lr,
                         float(pc["eps"]), hot, dev, "fp8")
        out["control"] = compare.train_numbers(ref8, ref)
        # the look at the later steps' loss: the reference again from the
        # dense parameters rounded once to bf16, against itself
        nudged = {k: [{n: t.to(torch.bfloat16).float() for n, t in
                       layer.items()} for layer in v]
                  for k, v in dense0.items()}
        again = reference(first, parts0, touched, nudged, lr,
                          float(pc["eps"]), hot, dev, "fp32")
        out["look"] = {"control_loss_gaps": compare.loss_gaps(ref8, ref),
                       "nudged_loss_gaps": compare.loss_gaps(again, ref)}
    return out


def reference(first: List[dict], rows0: List[torch.Tensor],
              touched: List[np.ndarray], dense0: dict, lr: float, eps: float,
              hot, dev, quant: str) -> dict:
    """The reference over the first steps' batches, from the rows they
    touch (as drawn) and the dense parameters (as drawn)."""
    dlrm_ref.exact_matmuls()
    tables0, local = [], [[] for _ in first]
    for t, (c, h) in enumerate(zip(core.hot_columns(hot), hot)):
        blocks = [torch.from_numpy(r["idx"][:, c: c + h].astype(np.int64))
                  .to(dev) for r in first]
        rows_t, pos = dlrm_ref.touched(blocks)
        if not np.array_equal(rows_t.cpu().numpy(), touched[t]):
            raise RuntimeError(f"table {t}: the touched rows disagree")
        tables0.append(rows0[t].to(dev).float())
        for k, p in enumerate(pos):
            local[k].append(p)
    return dlrm_ref.train(
        tables0, local, tree_to(dense0, dev),
        [torch.from_numpy(r["dense"]).to(dev) for r in first],
        [torch.from_numpy(r["labels"]).to(dev) for r in first], lr, eps,
        quant)


def step_work(mc: dict, plan, used: List[dict], pc: dict) -> Dict[str, float]:
    """The yardstick's operations and bytes over the traced steps: the
    model's FLOPs, the step's compulsory bytes and K2's."""
    hot, b, d = mc["hot_sizes"], used[0]["idx"].shape[0], mc["embedding_dim"]
    hits = b * int(sum(hot))
    row_b = 2 if pc["table_dtype"] == "bfloat16" else 4
    cache: Dict[int, tuple] = {}
    flops = nbytes = k2 = 0.0
    for r in used:
        key = id(r)
        if key not in cache:
            distinct = sum(len(t) for t in touched_rows([r], hot))
            items = stream_items(plan, r, pc)
            cache[key] = (distinct, items)
        distinct, items = cache[key]
        flops += work.model_flops(mc, b, train=True)
        nbytes += work.step_bytes(mc, b, distinct, True, row_b * d)
        k2 += work.k2_bytes(hits, items * CHUNK, items, distinct, d, 4, row_b)
    return {"flops": flops, "bytes": nbytes, "k2_bytes": k2}


def stream_items(plan, raw: dict, pc: dict) -> int:
    """K2's real work items for a batch: one per 256-slot chunk of each
    touched block's run of hits, each run padded to 128 slots (the
    U-layout of ops/stream_plan.py, worked out from the hits)."""
    br = pc["block_rows"]
    items = 0
    for c, h in zip(core.hot_columns(plan.hot), plan.hot):
        blocks = raw["idx"][:, c: c + h].ravel() // br
        runs = np.bincount(blocks)
        runs = runs[runs > 0]
        items += int(np.sum(-(-(-(-runs // 128) * 128) // CHUNK)))
    return items
