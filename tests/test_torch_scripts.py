"""The port's twins of the repository's shell scripts
(dlrm_tpu_torch/scripts/*.sh): each runs the same `python -m` commands as
the JAX script it twins, with `dlrm_tpu.` changed to `dlrm_tpu_torch.`
(the same flags, the same configs, the same variables), names no module of
the JAX package, is executable and parses (`bash -n`). The golden test's
comparator (scripts/golden_compare.py) passes a golden log against
cli.main(..., device="cpu") on its config and fails a log that moves a
number past 5e-6 or changes the text."""

import contextlib
import io
import os
import re
import shlex
import stat
import subprocess
import sys

import pytest

from dlrm_tpu_torch import cli
from dlrm_tpu_torch.scripts import golden_compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = {  # twin -> the JAX package's script
    "dlrm_tpu_test.sh": "test_scripts/dlrm_tpu_test.sh",
    "dlrm_criteo_kaggle.sh": "bench_scripts/dlrm_criteo_kaggle.sh",
    "dlrm_criteo_terabyte.sh": "bench_scripts/dlrm_criteo_terabyte.sh",
    "dlrm_tpu_benchmark.sh": "bench_scripts/dlrm_tpu_benchmark.sh",
    "run_and_time.sh": "bench_scripts/run_and_time.sh",
    "process_criteo_1tb.sh": "scripts/process_criteo_1tb.sh",
}
# the comparator the golden twin calls in place of `diff`
COMPARATOR = "dlrm_tpu_torch.scripts.golden_compare"


def _logical_lines(text):
    """The script's lines with backslash continuations joined and comments
    dropped."""
    text = re.sub(r"\\\n\s*", " ", text)
    return [ln.strip() for ln in text.splitlines()
            if ln.strip() and not ln.strip().startswith("#")]


def _commands(path):
    """Its `python -m` commands (module and argv up to a pipe or a
    redirection), each once in order, its run_config calls and its
    variables' values."""
    with open(os.path.join(ROOT, path)) as f:
        lines = _logical_lines(f.read())
    cmds, calls, assigns = [], [], []
    for ln in lines:
        if "python -m " in ln:
            words = shlex.split(ln[ln.index("python -m "):], posix=False)
            argv = []
            for w in words:
                if w in ("|", ">", ">>") or w.startswith(("2>", ">")):
                    break
                argv.append(w)
            if argv not in cmds:
                cmds.append(argv)
        elif ln.startswith("run_config "):
            calls.append(ln)
        elif re.match(r"^common=", ln):
            assigns.append(re.sub(r"\s+", " ", ln))
    return cmds, calls, assigns


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_runs_the_jax_scripts_commands_on_the_port(twin):
    path = f"dlrm_tpu_torch/scripts/{twin}"
    full = os.path.join(ROOT, path)
    assert os.stat(full).st_mode & stat.S_IXUSR
    r = subprocess.run(["bash", "-n", full], capture_output=True, text=True,
                       timeout=30)
    assert r.returncode == 0, r.stderr
    with open(full) as f:
        text = f.read()
    # no module of the JAX package, anywhere in the script
    assert not re.search(r"\bdlrm_tpu\.", text.replace("dlrm_tpu_torch.",
                                                       "")), twin
    cmds, calls, assigns = _commands(path)
    jcmds, jcalls, jassigns = _commands(TWINS[twin])
    want = [[w.replace("dlrm_tpu.", "dlrm_tpu_torch.") for w in c]
            for c in jcmds]
    assert [c for c in cmds if COMPARATOR not in c] == want
    assert all(c[2].startswith("dlrm_tpu_torch.") for c in cmds)
    assert calls == jcalls
    assert assigns == jassigns
    assert len(cmds) >= 1


def test_golden_comparator_against_the_cpu_trainer(tmp_path):
    """tiny4 (the golden twin's last config) through cli.main on the CPU:
    the comparator passes it against its golden log, and fails it once a
    loss moves by 1e-5 or a word changes."""
    golden = os.path.join(ROOT, "test_scripts", "golden", "tiny4.log")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--mini-batch-size=2", "--data-size=6",
                       "--loss-function=bce", "--round-targets=True"],
                      device="cpu")
    assert rc == 0
    log = tmp_path / "tiny4.log"
    log.write_text(buf.getvalue())
    with contextlib.redirect_stdout(io.StringIO()):
        assert golden_compare.main([golden, str(log)]) == 0
    with open(golden) as f:
        want = f.read()
    assert golden_compare.differences(buf.getvalue(), want) == []
    loss = re.search(r"loss (\d+\.\d+)", want).group(1)
    moved = want.replace(loss, f"{float(loss) + 1e-5:.6f}", 1)
    assert len(golden_compare.differences(moved, want)) == 1
    assert golden_compare.differences(want.replace("loss", "lost", 1), want)
    assert golden_compare.differences(want + "extra\n", want)
    # the module as the shell twin calls it
    bad = tmp_path / "moved.log"
    bad.write_text(moved)
    for path, code in ((log, 0), (bad, 1)):
        r = subprocess.run([sys.executable, "-m", COMPARATOR, golden,
                            str(path)], cwd=ROOT, capture_output=True,
                           text=True, timeout=60)
        assert r.returncode == code, r.stdout + r.stderr
