"""The fused step's cells on the CPU at a tiny size: drivers/fused_train.py
holds the port to the plain reference (torchrec's DLRM_Projection, and
DLRM-v2 DCN through the same file), the fp8 control fails, a traced run
reads what the program records; the projection's operations against a
count by hand; the reference's fp8 mode apart from its fp32 mode on every
compared number; the Kaggle traffic file draws one hit a table."""

import json
import os
import time

import numpy as np
import pytest
import torch

from port_bench import core
from port_bench.generators import multihot
from port_bench.reference import compare, dlrm_proj_ref
from port_bench.roofline import work_proj
from port_bench.tests.conftest import make_root, write

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEEDS = [5, 2**31 + 29]

PROJ = {"embedding_dim": 8, "table_sizes": [300, 7, 5000, 40, 3],
        "hot_sizes": [1, 1, 1, 1, 1], "mlp_bot": [13, 16, 8],
        "mlp_top": [16, 1], "interaction": "projection",
        "interaction_branch1_layer_sizes": [64, 32],
        "interaction_branch2_layer_sizes": [64, 48],
        "loss": "bce", "compute_dtype": "bfloat16"}
DCN = {"embedding_dim": 8, "table_sizes": [300, 7, 5000, 40, 3],
       "hot_sizes": [1, 1, 1, 1, 1], "mlp_bot": [13, 16, 8],
       "mlp_top": [16, 1], "interaction": "dcn", "dcn_num_layers": 2,
       "dcn_low_rank_dim": 8, "loss": "bce", "compute_dtype": "bfloat16"}
PATH = {"optimizer": "rwsadagrad", "table_dtype": "float32",
        "learning_rate": 0.004, "eps": 1e-8, "prefetch_depth": 2,
        "warmup_steps": 1, "trace_steps": 3}
# set like the real limits, from 17 seeds of both cells at batch 256 on the
# CPU: above what the program reads (bf16 towers against the fp32
# reference: at most 2.9e-3, 2.9e-2, 6.6e-2), and the control (fp8) above
# the change's limit in every run (at least 0.167)
LIMITS = {"probs_gap": {"limit": 2e-2}, "grad_gap": {"limit": 5e-2},
          "change_gap": {"limit": 1.2e-1}}
CELLS = {"train.tiny.fused_proj": "tiny_fused_proj",
         "train.tiny.fused_dcn": "tiny_fused_dcn"}


def make_fused_root(tmp) -> str:
    """The tiny benchmark with two fused cells added as new files and
    entries, as a cell is added to the real one."""
    root = make_root(tmp)
    pb = os.path.join(root, "port_bench")
    for cfg, model in (("tiny_fused_proj", PROJ), ("tiny_fused_dcn", DCN)):
        write(os.path.join(pb, "configs", cfg + ".json"),
              {"driver": "fused_train", "model": model, "path": PATH})
    write(os.path.join(pb, "traffic", "tiny_onehot.json"),
          {"generator": "multihot", "pool": 4, "batch": 256,
           "hot_dist": "uniform", "click_rate": 0.256})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    for name, cfg in CELLS.items():
        write(os.path.join(pb, "limits", name + ".json"), LIMITS)
        s["workloads"].append({"name": name, "config": cfg,
                               "traffic": "tiny_onehot", "chips": 1,
                               "why": "a tiny fused cell"})
        for m in s["end_to_end"] + s["per_layer"]:
            if "train.tiny.uniform" in m.get("workloads", []):
                m["workloads"].append(name)
    write(path, s)
    return root


@pytest.fixture
def fused_root(tmp_path):
    return make_fused_root(tmp_path)


def run(root, name, seed, trace=False, **kw):
    cell = core.load_cell(name, root)
    return cell, cell.driver().run(cell, seed, 0.2, trace, CPU,
                                   core.Stages(time.perf_counter()), **kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(CELLS))
def test_the_fused_step_agrees_with_the_reference(fused_root, name, seed):
    _, res = run(fused_root, name, seed, control=True)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"].ok(), res["checks"].table()
    ctl = core.Checks(LIMITS)
    for k, v in res["control"].items():
        ctl.add(k, v)
    assert not ctl.ok(), ctl.table()


def test_a_traced_run_reports_without_a_card(fused_root):
    """On the CPU the trace holds no kernel: the scope readers find
    nothing and leave their metrics out; the rest report."""
    cell, res = run(fused_root, "train.tiny.fused_proj", SEEDS[0], True)
    out = core.report(cell, res, True, {"platform": "cpu"})
    assert "train_step_mfu_pct" in out["metrics"]
    for m in ("proj_interaction_ms.train", "proj_roofline.train",
              "fused_update_ms.train"):
        assert m not in out["metrics"]
    assert res["summary"].work["proj_flops"] == 3 * res["attempted"] * 256 * (
        2 * (48 * 64 + 64 * 32 + 48 * 64 + 64 * 48) + 2 * 4 * 6 * 8)


def test_interaction_counts_by_hand():
    # F D = 6 x 8 = 48 features; F1 = 32 / 8 = 4, F2 = 48 / 8 = 6; the top
    # tower's input 8 + 4 x 6 = 32
    assert work_proj.branch_layers(PROJ) == [(48, 64), (64, 32), (48, 64),
                                             (64, 48)]
    assert work_proj.layers(PROJ) == [(13, 16), (16, 8), (48, 64), (64, 32),
                                      (48, 64), (64, 48), (32, 16), (16, 1)]
    branches = 2 * (3072 + 2048 + 3072 + 3072)
    bmm = 2 * 4 * 6 * 8
    assert work_proj.interaction_flops(PROJ, 5, train=False) == 5 * (
        branches + bmm)
    assert work_proj.interaction_flops(PROJ, 5, train=True) == 15 * (
        branches + bmm)
    fwd = 2 * (208 + 128 + 512 + 16) + branches + bmm
    assert work_proj.model_flops(PROJ, 1, train=False) == fwd
    assert work_proj.model_flops(PROJ, 5, train=True) == 5 * (
        3 * fwd - 2 * 208)
    params = (208 + 16 + 128 + 8 + 3072 + 64 + 2048 + 32 + 3072 + 64
              + 3072 + 48 + 512 + 16 + 16 + 1)
    assert work_proj.dense_params(PROJ) == params
    inputs = 4 * 5 * 4 + 4 * (13 * 4 + 4)
    assert work_proj.step_bytes(PROJ, 4, 30, True, 32) == (
        30 * (2 * 32 + 8) + inputs + params * 16)


def _inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    d, sizes, b = 8, [300, 7, 5000, 40, 3], 64

    def tower(ns):
        return [{"w": torch.randn((i, o), generator=gen) * (2 / (i + o)) ** .5,
                 "b": torch.randn((o,), generator=gen) * o ** -.5}
                for i, o in zip(ns[:-1], ns[1:])]

    dense = {"bot": tower([13, 16, 8]), "proj_branch1": tower([48, 64, 32]),
             "proj_branch2": tower([48, 64, 48]), "top": tower([32, 16, 1])}
    idx = [[torch.randint(0, n, (b, 1), generator=gen) for n in sizes]
           for _ in range(3)]
    rows, local = [], [[] for _ in idx]
    for t, n in enumerate(sizes):
        r, pos = dlrm_proj_ref.touched([i[t] for i in idx])
        rows.append(torch.rand((len(r), d), generator=gen) - 0.5)
        for k, p in enumerate(pos):
            local[k].append(p)
    feats = [torch.randn((b, 13), generator=gen) for _ in idx]
    labels = [(torch.rand((b, 1), generator=gen) < 0.256).float()
              for _ in idx]
    return rows, local, dense, feats, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_the_fp8_control_differs_on_every_number(seed):
    args = _inputs(seed)
    ref = dlrm_proj_ref.train(*args, 0.004, 1e-8, "fp32")
    again = dlrm_proj_ref.train(*args, 0.004, 1e-8, "fp32")
    assert compare.train_numbers(again, ref) == {
        "probs_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    ctl = compare.train_numbers(dlrm_proj_ref.train(*args, 0.004, 1e-8,
                                                    "fp8"), ref)
    # e4m3 keeps 3 bits of mantissa: every number moves by far more than
    # fp32's rounding
    assert all(v > 1e-3 for v in ctl.values()), ctl


def test_the_kaggle_traffic_draws_one_hit_a_table():
    with open(os.path.join(BENCH, "traffic", "train_kaggle_onehot.json")) as f:
        mix = json.load(f)
    assert mix["batch"] == 65536 and mix["hot_dist"] == "uniform"
    with open(os.path.join(BENCH, "configs",
                           "dlrm_projection_kaggle_fp32_train.json")) as f:
        model = json.load(f)["model"]
    sizes, hot = model["table_sizes"], model["hot_sizes"]
    assert hot == [1] * 26
    batch = multihot.pool(dict(mix, batch=4096, pool=1), sizes, hot, 13, 7)[0]
    assert batch["idx"].shape == (4096, 26)
    for t, n in enumerate(sizes):
        col = batch["idx"][:, t]
        assert col.min() >= 0 and col.max() < n
    assert np.all(batch["idx"][:, 8] < 3)  # the 3-row table
    assert abs(batch["labels"].mean() - 0.256) < 0.03


def test_the_projection_draws_torchrecs_linear_init():
    """Every tower and branch layer as nn.Linear draws it: W and b
    uniform on [-1/sqrt(n_in), 1/sqrt(n_in)], so their variance is
    1 / (3 n_in); the layers' shapes as the reference reads them."""
    drv = core.load_module(os.path.dirname(BENCH), "drivers", "fused_train")
    model = dict(PROJ, mlp_bot=[13, 512, 8], mlp_top=[512, 1])
    tree = drv.draw_dense(model, 2**31 + 7, CPU)
    again = drv.draw_dense(model, 2**31 + 7, CPU)
    shapes = {k: [tuple(l["w"].shape) for l in v] for k, v in tree.items()}
    assert shapes == {"bot": [(13, 512), (512, 8)],
                      "proj_branch1": [(48, 64), (64, 32)],
                      "proj_branch2": [(48, 64), (64, 48)],
                      "top": [(32, 512), (512, 1)]}
    for name, t in dlrm_proj_ref.leaves(tree).items():
        assert torch.equal(t, dlrm_proj_ref.leaves(again)[name])
        n_in = shapes[name.split(".")[0]][int(name.split(".")[1])][0]
        bound = 1.0 / n_in ** 0.5
        assert t.dtype == torch.float32
        assert float(t.abs().max()) <= bound, name
        if t.numel() >= 4096:
            # the variance of U(-a, a) is a^2 / 3; at 4,096 or more draws
            # its estimate is within 5 % (its relative sd is 1.4 % there)
            assert abs(float(t.var()) * 3 * n_in - 1.0) < 0.05, name
