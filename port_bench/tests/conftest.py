"""A made-up tiny benchmark in a temporary checkout root: the real
drivers, generator and metric readers copied beside tiny configurations, so
that a whole cell runs on the CPU (the program's plain versions) in
seconds."""

import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL = {"embedding_dim": 8, "table_sizes": [300, 7, 5000, 40],
         "hot_sizes": [3, 1, 10, 2], "mlp_bot": [13, 16, 8],
         "mlp_top": [32, 16, 1], "dcn_num_layers": 2, "dcn_low_rank_dim": 8,
         "loss": "bce", "compute_dtype": "bfloat16"}
TRAIN_PATH = {"optimizer": "rwsadagrad", "grad_impl": "gather",
              "table_dtype": "bfloat16", "mm_dtype": "bfloat16",
              "stochastic_round": True, "unit_weights": True,
              "update_touched_only": True, "block_rows": 128,
              "learning_rate": 0.004, "eps": 1e-8, "prefetch_depth": 2,
              "warmup_steps": 1, "trace_steps": 3}
SERVE_PATH = {"table_format": "int8_rowwise", "amplitude": 0.05,
              "in_flight": 2, "warmup_batches": 2, "trace_batches": 3}
# limits for the tiny cells, set like the real ones: above what sound runs
# of the program read on the CPU, below what the fp8 control reads
TRAIN_LIMITS = {"probs_gap": {"limit": 2e-2},
                "grad_gap": {"limit": 5e-2}, "change_gap": {"limit": 5e-2}}
SERVE_LIMITS = {"probs_gap": {"limit": 1.5e-3}}
CELLS = {
    "train.tiny.uniform": ("tiny_train", "tiny_uniform", TRAIN_LIMITS),
    "train.tiny.pareto": ("tiny_train", "tiny_pareto", TRAIN_LIMITS),
    "serve.tiny.offline": ("tiny_serve", "tiny_offline", SERVE_LIMITS),
}


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def make_root(root) -> str:
    root = str(root)
    for kind in ("drivers", "generators", "metrics"):
        shutil.copytree(os.path.join(BENCH, kind),
                        os.path.join(root, "port_bench", kind),
                        ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(root, "port_bench")
    write(os.path.join(pb, "configs", "tiny_train.json"),
          {"driver": "train", "model": MODEL, "path": TRAIN_PATH})
    write(os.path.join(pb, "configs", "tiny_serve.json"),
          {"driver": "serve", "model": MODEL, "path": SERVE_PATH})
    base = {"generator": "multihot", "pool": 4, "click_rate": 0.25}
    write(os.path.join(pb, "traffic", "tiny_uniform.json"),
          dict(base, batch=64, hot_dist="uniform"))
    write(os.path.join(pb, "traffic", "tiny_pareto.json"),
          dict(base, batch=64, hot_dist="pareto", pareto_a=0.25))
    write(os.path.join(pb, "traffic", "tiny_offline.json"),
          dict(base, batch=32, hot_dist="uniform"))
    with open(os.path.join(BENCH, os.pardir, "BENCHMARK.json")) as f:
        spec = json.load(f)
    train = [c for c in CELLS if c.startswith("train")]
    serve = [c for c in CELLS if c.startswith("serve")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = train if "train" in m["workloads"][0] else serve
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "a tiny cell of the CPU tests"}
                         for n, (c, t, _) in CELLS.items()]
    write(os.path.join(root, "BENCHMARK.json"), spec)
    for n, (_, _, lim) in CELLS.items():
        write(os.path.join(pb, "limits", n + ".json"), lim)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
