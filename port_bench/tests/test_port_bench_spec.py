"""BENCHMARK.json keeps to the benchmark's contract, every name it gives
has its file, and a cell, a traffic mix, a configuration and a per-layer
metric are added with new files and new entries alone."""

import json
import os
import re
import time

import torch

from port_bench import core

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "port_bench/run.py"]
    assert s["paths"] == ["port_bench"]
    assert 1 <= s["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(s)) <= 64 * 1024


def test_entries_keep_to_the_contract():
    s = spec()
    cfgs = {c["name"]: c for c in s["configs"]}
    cells = {w["name"]: w for w in s["workloads"]}
    assert 1 <= len(cfgs) <= 24 and 1 <= len(cells) <= 24
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and LINE.fullmatch(c["why"])
        assert c["file"].startswith("port_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.fullmatch(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in s["workloads"])
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and LINE.fullmatch(w["why"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", cells):
            assert core.applies(e2e[m["moves"]], w)
    for m in metrics:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(w in cells for w in m.get("workloads", []))
    for name in cells:
        cell = core.load_cell(name, ROOT)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        assert cell.limits and all("limit" in v for v in cell.limits.values())


def test_made_up_entries_need_only_new_files(tiny_root):
    """One made-up configuration, traffic mix, per-layer metric and cell,
    written as new files and new entries beside the others, run traced."""
    pb = os.path.join(tiny_root, "port_bench")
    with open(os.path.join(pb, "configs", "tiny_train.json")) as f:
        cfg = json.load(f)
    cfg["model"]["mlp_top"] = [24, 1]
    with open(os.path.join(pb, "configs", "made_up.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "made_up_mix.json"), "w") as f:
        json.dump({"generator": "multihot", "pool": 3, "batch": 48,
                   "hot_dist": "pareto", "pareto_a": 0.5,
                   "click_rate": 0.5}, f)
    with open(os.path.join(pb, "metrics", "made_up_steps.train.py"),
              "w") as f:
        f.write("def read(s):\n    return {'value': s.steps}\n")
    with open(os.path.join(pb, "limits", "train.made_up.cell.json"),
              "w") as f:
        json.dump({"probs_gap": {"limit": 1.0},
                   "grad_gap": {"limit": 1.0}, "change_gap": {"limit": 1.0}},
                  f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    s["workloads"].append({"name": "train.made_up.cell", "config": "made_up",
                           "traffic": "made_up_mix", "chips": 1,
                           "why": "made up"})
    s["per_layer"].append({"name": "made_up_steps.train", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "device",
                           "moves": "train_examples_per_s",
                           "workloads": ["train.made_up.cell"]})
    for m in s["end_to_end"]:
        if "train.tiny.uniform" in m.get("workloads", []):
            m["workloads"].append("train.made_up.cell")
    with open(path, "w") as f:
        json.dump(s, f)
    cell = core.load_cell("train.made_up.cell", tiny_root)
    assert cell.traffic["batch"] == 48
    res = cell.driver().run(cell, 9, 0.1, True, torch.device("cpu"),
                            core.Stages(time.perf_counter()))
    out = core.report(cell, res, True, {"platform": "cpu"})
    assert out["metrics"]["made_up_steps.train"]["value"] == res["attempted"]
    assert out["metrics"]["made_up_steps.train"]["unit"] == "steps"
    # the other cells do not report it
    other = core.load_cell("train.tiny.uniform", tiny_root)
    assert "made_up_steps.train" not in {m["name"] for m in other.per_layer}
