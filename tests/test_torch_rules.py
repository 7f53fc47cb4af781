"""Ground rules of the PyTorch port.

* dlrm_tpu_torch/** and chip_smoke.py import neither jax nor dlrm_tpu (a
  static scan of the sources: this interpreter may have imported jax at
  start-up, so sys.modules says nothing).
* Entry points run on the card unless the caller passes device="cpu"; where
  there is no card they raise instead of falling back to the CPU.
* The preprocess's day parsers, a process a day, import the Criteo data
  modules without torch, whose start-up would cost each seconds.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "dlrm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
PORT_SHELL_SCRIPTS = sorted((ROOT / "dlrm_tpu_torch").rglob("*.sh"))
# a module of the JAX package named in a shell script (dlrm_tpu.x, not
# dlrm_tpu_torch.x)
JAX_MODULE = re.compile(r"\bdlrm_tpu\.[A-Za-z_]")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "dlrm_tpu")


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_SOURCES}
    assert "dlrm_tpu_torch/train/stream_step.py" in names
    assert "dlrm_tpu_torch/ops/stream_kernels.py" in names
    for module in ("cli", "train/harness", "train/checkpoint", "data/criteo",
                   "data/criteo_stream", "data/synthetic", "utils/logging",
                   "utils/tfevents", "utils/profiling",
                   "native/criteo_native", "ops/quantized", "tools/export",
                   "parallel/gspmd", "probes/infer_bench",
                   "probes/serve_flagship", "utils/compliance",
                   "tools/visualize", "scripts/mlperf_proxy_run",
                   "scripts/launch", "scripts/golden_compare",
                   "graft_entry"):
        assert f"dlrm_tpu_torch/{module}.py" in names
    assert "chip_smoke.py" in names
    shells = {p.name for p in PORT_SHELL_SCRIPTS}
    assert shells == {"dlrm_tpu_test.sh", "dlrm_criteo_kaggle.sh",
                      "dlrm_criteo_terabyte.sh", "dlrm_tpu_benchmark.sh",
                      "run_and_time.sh", "process_criteo_1tb.sh"}


@pytest.mark.parametrize(
    "path", PORT_SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_port_imports_neither_jax_nor_dlrm_tpu(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "path", PORT_SHELL_SCRIPTS, ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_port_shell_scripts_name_no_jax_module(path):
    bad = JAX_MODULE.findall(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_shell_scan_detects_a_jax_module():
    assert JAX_MODULE.findall("python -m dlrm_tpu.cli\n"
                              "python -m dlrm_tpu_torch.cli\n") == [
        "dlrm_tpu.c"]


def test_scan_detects_a_forbidden_import(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import os\nfrom jax import numpy\nimport dlrm_tpu.config\n"
                 "import dlrm_tpu_torch.config\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == [
        "jax", "dlrm_tpu.config"
    ]


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from dlrm_tpu_torch.bridge import params_from_jax
    from dlrm_tpu_torch.cli import main as v1_main
    from dlrm_tpu_torch.config import DLRMConfig, TrainConfig
    from dlrm_tpu_torch.data.random_data import fixed_multihot_batch
    from dlrm_tpu_torch.device import resolve_device
    from dlrm_tpu_torch.models.dlrm import DLRMModel
    from dlrm_tpu_torch.probes import (
        infer_bench,
        k2_bisect,
        kernel_feasibility,
        pallas_probe,
        revolve_probe,
        scan_probe,
        serve_flagship,
        stream_variants,
        t2_sweep,
    )
    from dlrm_tpu_torch.graft_entry import dryrun_multichip, entry
    from dlrm_tpu_torch.scripts import mlperf_proxy_run
    from dlrm_tpu_torch.tools import visualize
    from dlrm_tpu_torch.train.harness import Trainer
    from dlrm_tpu_torch.train.pipeline import DevicePrefetcher
    from dlrm_tpu_torch.train.stream_step import (
        make_stream_eval_step,
        make_stream_train_step,
        plan_for_model,
    )
    from dlrm_tpu_torch.v2_main import main as v2_main

    cfg = DLRMConfig(embedding_dim=8, table_sizes=(20, 30), mlp_bot=(4, 8),
                     mlp_top=(8, 1), loss="bce", num_indices_per_lookup=2)
    model = DLRMModel(cfg)
    plan = plan_for_model(model, 4, block_rows=128)
    hb = fixed_multihot_batch(np.random.default_rng(0), 4, cfg.table_sizes,
                              4, 2)
    calls = [
        lambda: resolve_device(),
        lambda: model.init_params(seed=0),
        lambda: model.init_params_numpy(),
        lambda: params_from_jax({"w": np.zeros((2, 2), np.float32)}),
        lambda: hb.to_device(),
        lambda: make_stream_train_step(model, "sgd", plan),
        lambda: make_stream_eval_step(model, plan),
        lambda: DevicePrefetcher([hb], lambda x: x, device="cuda"),
        # the trainer, before it draws a batch
        lambda: v2_main(["--batch_size", "4", "--embedding_dim", "8",
                         "--num_embeddings", "16",
                         "--dense_arch_layer_sizes", "8",
                         "--over_arch_layer_sizes", "4,1"]),
        # the v1 trainer, before it draws a batch, and its Trainer
        lambda: v1_main(["--mini-batch-size=2", "--data-size=2"]),
        lambda: Trainer(model, TrainConfig(), []),
        # the probes time the card
        scan_probe.main, pallas_probe.main, stream_variants.main,
        revolve_probe.main, k2_bisect.main, kernel_feasibility.main,
        infer_bench.main, serve_flagship.main, t2_sweep.main,
        # quantized serving, before it draws a batch
        lambda: v1_main(["--mini-batch-size=2", "--data-size=2",
                         "--inference-only", "--quantize-emb-with-bit=4"]),
        # the tools and entry points
        entry,
        lambda: dryrun_multichip(2),
        lambda: visualize.representations(model, {}, [hb]),
        lambda: mlperf_proxy_run.run_v1("unused", 0.5),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the same calls with device="cpu" work
    assert model.init_params(seed=0, device="cpu")["emb"]["stacked"].shape == (
        50, 8)
    assert hb.to_device("cpu").dense.device.type == "cpu"


def test_day_parser_modules_import_without_torch():
    code = ("import sys\n"
            "import dlrm_tpu_torch.data.criteo\n"
            "import dlrm_tpu_torch.data.criteo_stream\n"
            "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "False"
