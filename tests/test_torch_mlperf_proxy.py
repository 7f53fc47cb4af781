"""The port's MLPerf proxy run (dlrm_tpu_torch/scripts/mlperf_proxy_run.py)
on the CPU, as tests/test_mlperf_proxy.py runs the JAX script: 24 generated
Criteo-format raw days of 800 rows -> the port's out-of-core multi-process
preprocess -> packed bins -> cli.main with MLPerf logging, the bin loader
and the LR policy to a real auc-threshold stop, its log checked by the
port's compliance checker (inside run_v1); then the v2 phase (DCN, the
streamed bf16 tables through K2's plain version, --auroc_target) over the
same bins. The v2 case runs on the v1 case's workdir (the JAX test's
--phase both, without training v1 twice). The raw days are the JAX
script's byte for byte, and a workdir made for another config is refused."""

import filecmp
import os
import sys

import pytest
import torch

from dlrm_tpu_torch.scripts import mlperf_proxy_run as proxy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ARGS = ["--days", "24", "--rows-per-day", "800", "--auc-threshold", "0.70",
        "--auroc-target", "0.70"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The proxy's tiny steps on one torch thread: the suite's other
    workers hold the cores, and threads that outnumber them spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def v1_workdir(tmp_path_factory):
    """(return code, workdir) of the v1 phase."""
    work = str(tmp_path_factory.mktemp("proxy") / "proxy")
    rc = proxy.main(["--workdir", work, "--phase", "v1"] + ARGS,
                    device="cpu")
    return rc, work


def test_mlperf_proxy_v1_auc_threshold_stop(v1_workdir):
    rc, work = v1_workdir
    assert rc == 0  # run_v1 checks the threshold stop + compliance
    for split in ("train", "test"):
        assert os.path.getsize(os.path.join(work, "proc",
                                            f"{split}_data.bin")) > 0


def test_mlperf_proxy_v2_auroc_target_stop(v1_workdir):
    _, work = v1_workdir
    rc = proxy.main(["--workdir", work, "--phase", "v2"] + ARGS,
                    device="cpu")
    assert rc == 0  # run_v2 checks the AUROC-target stop
    assert os.path.exists(os.path.join(work, "proc", "val_data.bin"))


def test_raw_days_equal_the_jax_scripts(tmp_path):
    from scripts import mlperf_proxy_run as jax_proxy

    ours = proxy.generate_raw_days(str(tmp_path / "t"), 3, 60, seed=4)
    theirs = jax_proxy.generate_raw_days(str(tmp_path / "j"), 3, 60, seed=4)
    assert [os.path.basename(p) for p in ours] == ["day_0", "day_1",
                                                   "day_2"]
    for a, b in zip(ours, theirs):
        assert filecmp.cmp(a, b, shallow=False), a
    assert os.path.getsize(ours[0]) > 60 * 40


def test_workdir_fingerprint_refuses_another_config(tmp_path):
    work = str(tmp_path / "w")
    os.makedirs(os.path.join(work, "raw"))
    with pytest.raises(SystemExit):  # raw days of unknown provenance
        proxy.main(["--workdir", work, "--phase", "v1"] + ARGS,
                   device="cpu")
    os.rmdir(os.path.join(work, "raw"))
    with open(os.path.join(work, "config.json"), "w") as f:
        f.write('{"days": 24, "rows_per_day": 100}')
    with pytest.raises(SystemExit):  # generated with 100 rows a day
        proxy.main(["--workdir", work, "--phase", "v1"] + ARGS,
                   device="cpu")
    assert proxy.DEFAULT_WORKDIR != "/tmp/dlrm_mlperf_proxy"


def test_v1_trace_steps_on_the_cpu(v1_workdir):
    """probes/proxy_v1_trace.py's CPU run of the v1 argv: a loss a step up
    to the auc-threshold stop, and compare() finds the first step that
    differs."""
    from dlrm_tpu_torch.probes import proxy_v1_trace as pt

    rc, work = v1_workdir
    assert rc == 0
    run = pt.trace(work, "cpu")
    assert run["aucs"] and run["aucs"][-1] > 0.70
    assert all(a <= 0.70 for a in run["aucs"][:-1])
    # each epoch of 144 steps evaluates at its 80th; the third stops
    assert len(run["losses"]) == 144 * (len(run["aucs"]) - 1) + pt.WINDOW
    same = pt.compare(run["losses"], run["losses"])
    assert same["first_step"] is None and same["first_above_1e-5"] is None
    assert not any(same["max_by_window"])
    moved = list(run["losses"])
    moved[100] += 0.5
    got = pt.compare(run["losses"], moved)
    assert got["first_step"] == got["first_above_1e-5"] == 101
    assert got["max_by_window"][1] == pytest.approx(0.5)
