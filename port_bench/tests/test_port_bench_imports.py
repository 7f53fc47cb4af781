"""No module that the harness loads has the top-level name of JAX or of the
JAX package (the part before the first dot compared whole: the port's name
begins with the JAX package's), and the plain reference imports nothing of
the program."""

import ast
import glob
import os
import subprocess
import sys

from port_bench import core

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_names_are_compared_whole():
    loaded = ["dlrm_tpu_torch", "dlrm_tpu_torch.ops.quantized", "dlrm_tpu",
              "dlrm_tpu.models", "jax", "jaxlib.xla_client", "jaxtyping",
              "jax_fake", "flax.linen", "port_bench.core"]
    assert core.forbidden_modules(loaded) == [
        "dlrm_tpu", "dlrm_tpu.models", "flax.linen", "jax",
        "jaxlib.xla_client"]


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        for name in imported(path):
            assert name.split(".")[0] not in core.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    for path in files:
        for name in imported(path):
            top = name.split(".")[0]
            assert top not in ("dlrm_tpu_torch", "port_bench"), (path, name)


def test_a_whole_run_loads_no_jax_module(tiny_root):
    """Both kinds of cell, traced, in a fresh process with every metric
    reader loaded: sys.modules then holds nothing of JAX."""
    code = f"""
import sys, time, torch
sys.path.insert(0, {ROOT!r})
from port_bench import core
for name in ("train.tiny.uniform", "serve.tiny.offline"):
    cell = core.load_cell(name, {tiny_root!r})
    res = cell.driver().run(cell, 5, 0.1, True, torch.device("cpu"),
                            core.Stages(time.perf_counter()))
    core.report(cell, res, True, {{"platform": "cpu"}})
print("FOUND", core.forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND []" in r.stdout, r.stdout[-2000:]
