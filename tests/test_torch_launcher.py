"""The port's rank launcher (dlrm_tpu_torch/scripts/launch.py), as
tests/test_launcher.py runs the JAX one: `--nproc 4 --device cpu` starts
four processes of the real cli.main over gloo, wired by torchrun's
environment, on a 2 x 2 grid; their losses equal the same argv's run on
four ranks spawned in-process (parallel/launch.py::run_ranks) bit for bit.
--print-cmds prints each rank's environment and command, the
multiple-of-hosts rule holds, a failing rank's code is returned, and
--device cuda refuses more ranks than cards before it starts any (on a
host with no card too), and a process run with DLRM_TORCH_LAUNCHES_TO
reports its kernel launches at exit. Needs no JAX; the last case needs two
cards (marker `cuda`)."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.parallel.launch import run_ranks
from dlrm_tpu_torch.scripts import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLI_ARGS = [
    "--arch-embedding-size", "60-80-100",
    "--arch-sparse-feature-size", "16",
    "--arch-mlp-bot", "4-8-16",
    "--arch-mlp-top", "24-8-1",
    "--data-generation", "random",
    "--mini-batch-size", "16",
    "--num-batches", "4",
    "--sharded", "--mesh-data", "2", "--mesh-model", "2",
    "--print-freq", "2",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("DLRM_NUM_PROCESSES", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _launch(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "dlrm_tpu_torch.scripts.launch"] + args,
        env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=timeout)


def _losses(out: str):
    return [float(m) for m in re.findall(r"loss (\d+\.\d+)", out)]


def _cli_rank(rank, argv):
    """cli.main(argv) on this rank, on the CPU; its output (rank 0's; the
    others print nothing)."""
    from dlrm_tpu_torch import cli

    torch.set_num_threads(1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device="cpu")
    return rc, buf.getvalue()


def test_launcher_four_cpu_ranks_match_run_ranks():
    r = _launch(["--nproc", "4", "--device", "cpu", "-m",
                 "dlrm_tpu_torch.cli", "--"] + CLI_ARGS)
    assert r.returncode == 0, r.stdout + r.stderr
    got = _losses(r.stdout)
    assert len(got) == 2, r.stdout  # only rank 0 prints
    assert "sharding plan" in r.stdout

    ranks = run_ranks(_cli_rank, 4, args=(CLI_ARGS,))
    assert [rc for rc, _ in ranks] == [0] * 4
    assert [out for _, out in ranks[1:]] == [""] * 3
    want = _losses(ranks[0][1])
    assert len(want) == 2
    np.testing.assert_array_equal(got, want)


def test_launcher_print_cmds_and_host_constraint():
    r = _launch(["--nproc", "4", "--nproc-per-host", "2", "--coordinator",
                 "host0:1234", "--print-cmds", "-m",
                 "dlrm_tpu_torch.v2_main", "--", "--sharded"], timeout=60)
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("host ")]
    assert len(lines) == 4
    assert lines[0].startswith("host 0 rank 0: MASTER_ADDR=host0 "
                               "MASTER_PORT=1234 WORLD_SIZE=4 RANK=0 "
                               "LOCAL_RANK=0 LOCAL_WORLD_SIZE=2 ")
    assert "RANK=3 LOCAL_RANK=1" in lines[3]
    assert lines[3].startswith("host 1")  # ranks 2, 3 on host 1
    assert lines[3].endswith("-m dlrm_tpu_torch.v2_main --sharded")
    cpu = _launch(["--nproc", "1", "--device", "cpu", "--print-cmds",
                   "-m", "dlrm_tpu_torch.cli"], timeout=60)
    assert "device='cpu'" in cpu.stdout and "dlrm_tpu_torch.cli" in cpu.stdout

    # aws_component.py:25-29: multi-host totals must be a multiple of the
    # per-host process count
    r2 = _launch(["--nproc", "3", "--nproc-per-host", "2", "--print-cmds"],
                 timeout=60)
    assert r2.returncode != 0
    assert "multiple of" in r2.stderr


def test_launcher_returns_the_failing_ranks_code():
    """A rank that exits non-zero (an unknown flag: argparse's code 2)
    tears the group down and its code is the launcher's."""
    r = _launch(["--nproc", "2", "--device", "cpu", "-m",
                 "dlrm_tpu_torch.cli", "--", "--no-such-flag"], timeout=120)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "exited with code 2" in r.stderr


def test_launcher_cuda_refuses_more_ranks_than_cards(monkeypatch):
    """--device cuda with more ranks a host than cards raises before any
    process starts (on a host without a card: any rank at all)."""
    started = []
    monkeypatch.setattr(launch.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="device_count"):
        launch.main(["--nproc", str(cards + 1), "-m", "dlrm_tpu_torch.cli",
                     "--", "--sharded"])
    # one rank a host, two hosts: refused here (the hosts' commands come
    # from --print-cmds), or for want of a card
    with pytest.raises(RuntimeError, match="one host's ranks" if cards
                       else "device_count"):
        launch.main(["--nproc", "2", "--nproc-per-host", "1", "-m",
                     "dlrm_tpu_torch.cli"])
    assert started == []


def test_processes_report_their_launches_at_exit(tmp_path):
    """DLRM_TORCH_LAUNCHES_TO=<dir>: each process that imported the kernel
    table writes its launch counts to <dir>/launches_<pid>.json at exit
    (how chip_smoke.py phase 12 counts the kernels of the processes a
    launcher starts); without it, nothing is written."""
    code = ("import dlrm_tpu_torch.ops.stream_kernels as k; "
            "k.LAUNCHES['stream_update'] += 3")
    env = _env()
    env["DLRM_TORCH_LAUNCHES_TO"] = str(tmp_path)
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
    files = sorted(tmp_path.glob("launches_*.json"))
    assert len(files) == 2
    for f in files:
        counts = json.loads(f.read_text())
        assert counts["stream_update"] == 3 and counts["window_pool"] == 0
    subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                   timeout=120, check=True)
    assert sorted(tmp_path.glob("launches_*.json")) == files


@pytest.mark.cuda
def test_launcher_two_cards():
    """--nproc 2 on two cards (NCCL, cuda:LOCAL_RANK): exit code 0, and
    the losses of the same argv's two ranks on the CPU within rtol 1e-5.
    Needs two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    argv = CLI_ARGS[:CLI_ARGS.index("--mesh-data")] + ["--mesh-data", "1",
                                                       "--mesh-model", "2"]
    r = _launch(["--nproc", "2", "-m", "dlrm_tpu_torch.cli", "--"] + argv,
                timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    ranks = run_ranks(_cli_rank, 2, args=(argv,))
    np.testing.assert_allclose(_losses(r.stdout), _losses(ranks[0][1]),
                               rtol=1e-5)
    assert len(_losses(r.stdout)) == 2
