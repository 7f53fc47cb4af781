"""What every cell shares: finding a cell's files by name, the card's
description, the set-up clock, the numbers compared against their limits,
the check that no JAX module was loaded, and the result line.

A cell is one entry of BENCHMARK.json's "workloads". Its files are found by
the names that entry gives:

  port_bench/configs/<config>.json   the model, the path's arguments, the
                                      driver that runs it ("driver")
  port_bench/traffic/<traffic>.json  the generator's name and parameters
  port_bench/drivers/<driver>.py     the loop of a kind of cell: run(cell)
  port_bench/generators/<gen>.py     a traffic generator: pool(traffic, ...)
  port_bench/metrics/<metric>.py     one per-layer metric: read(summary)
  port_bench/limits/<workload>.json  each compared number's limit

so that a cell, a mix, a configuration or a metric is added with new files
and new entries, and no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "dlrm_tpu")
BENCH = "port_bench"


def _path(root: str, kind: str, name: str, ext: str) -> str:
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}", name):
        raise ValueError(f"bad {kind} name {name!r}")
    return os.path.join(root, BENCH, kind, name + ext)


def load_json(root: str, kind: str, name: str) -> dict:
    with open(_path(root, kind, name, ".json")) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """port_bench/<kind>/<name>.py as a module (names may hold dots)."""
    path = _path(root, kind, name, ".py")
    mod_name = f"{BENCH}_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    """One workload with everything its files say."""

    root: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, dict]
    run_seconds: int

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver(self):
        return load_module(self.root, "drivers", self.config["driver"])

    def generator(self):
        return load_module(self.root, "generators", self.traffic["generator"])


def load_cell(workload: str, root: str) -> Cell:
    """The cell `workload` of the BENCHMARK.json at the checkout's root."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entries = [w for w in spec["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    return Cell(
        root=root,
        workload=w,
        config=load_json(root, "configs", w["config"]),
        traffic=load_json(root, "traffic", w["traffic"]),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if applies(m, workload)],
        limits=load_json(root, "limits", workload),
        run_seconds=int(spec["run_seconds"]),
    )


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


class Stages:
    """Seconds of each set-up stage, from the process's start, printed on
    standard error as they end."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.last = t0
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        print(f"[setup] {name}: {self.seconds[name]:.3f} s "
              f"(at {now - self.t0:.3f} s)", file=sys.stderr, flush=True)


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


@dataclass
class Checks:
    """The numbers compared with the plain reference, each beside its
    limit; a run is correct when every number is at most its limit."""

    limits: Dict[str, dict]
    values: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r}")
        self.values[name] = float(value)

    def ok(self) -> bool:
        return bool(self.values) and all(
            v <= self.limits[k]["limit"] for k, v in self.values.items())

    def table(self) -> Dict[str, dict]:
        return {k: {"value": v, "limit": self.limits[k]["limit"]}
                for k, v in self.values.items()}

    def log(self) -> None:
        for k, v in self.values.items():
            lim = self.limits[k]["limit"]
            print(f"check {k} {v!r} limit {lim!r} "
                  f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)


def hot_columns(hot) -> np.ndarray:
    """Table t's first column in a flat [B, sum(hot)] batch."""
    return np.concatenate([[0], np.cumsum(hot)[:-1]]).astype(np.int64)


def metric(value: float, unit: str, **extra) -> dict:
    return {"value": float(value), "unit": unit, **extra}


def report(cell: Cell, res: dict, trace: bool, device: dict) -> dict:
    """The result line of a driver's run (before its "checks"): the cell's
    end-to-end metrics, or with trace its per-layer metrics, each read by
    port_bench/metrics/<name>.py from the traced window; a reader that
    finds nothing leaves its metric out."""
    from port_bench import tracing

    metrics = {}
    device = dict(device, memory_peak_bytes=res["memory_peak_bytes"])
    out = {"correct": res["checks"].ok() and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if trace:
        summary = res["summary"]
        summary.power = device.get("power_limit") or ""
        for m in cell.per_layer:
            got = load_module(cell.root, "metrics", m["name"]).read(summary)
            if got is not None:
                metrics[m["name"]] = metric(got.pop("value"), m["unit"], **got)
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = tracing.breakdown(summary)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = metric(res["e2e"][m["name"]], m["unit"])
    return out
