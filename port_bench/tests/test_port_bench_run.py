"""The command refuses to report where there is no card, and in a
directory that holds only BENCHMARK.json and the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
ARGS = ["--workload", "train.v2dcn.uniform", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


def run(root, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(root, "port_bench", "run.py"), *ARGS],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def no_result(stdout):
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "correct" in obj), line


def test_no_card_no_result():
    r = run(ROOT)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    no_result(r.stdout)


def test_only_the_benchmarks_files_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(str(tmp_path))
    assert r.returncode != 0
    no_result(r.stdout)
