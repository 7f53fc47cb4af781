"""The port's copy of the MLPerf compliance checker
(dlrm_tpu_torch/utils/compliance.py) against the JAX package's
(dlrm_tpu/utils/compliance.py): the 15 cases of tests/test_compliance.py,
each log checked by both with the same list of violations and the same
verdict the JAX test asserts; the port's own MLPerf logs from
cli.main(..., --mlperf-logging) with both checkers' verdicts equal; and the
copy's CLI (`python -m dlrm_tpu_torch.utils.compliance`) with exit codes 0
and 1."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from dlrm_tpu.utils import compliance as J
from dlrm_tpu_torch.utils import compliance as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Log:
    """The JAX test's record builder (its _rec / _compliant_log), with the
    clock as state of its own."""

    def __init__(self):
        self.t = 0

    def rec(self, key, event_type="POINT_IN_TIME", value=None, metadata=None,
            t=None):
        self.t = max(self.t + 1, t or 0)
        return ":::MLLOG " + json.dumps({
            "namespace": "",
            "time_ms": self.t,
            "event_type": event_type,
            "key": key,
            "value": value,
            "metadata": metadata or {},
        })

    def compliant(self):
        self.t = 0
        r = self.rec
        return [
            r("cache_clear", value=True),
            r("init_start", "INTERVAL_START"),
            r("submission_benchmark", value="dlrm"),
            r("submission_division", value="closed"),
            r("submission_org", value="reference"),
            r("submission_platform", value="tpu"),
            r("submission_status", value="onprem"),
            r("seed", value=123),
            r("global_batch_size", value=128),
            r("opt_base_learning_rate", value=0.4),
            r("opt_learning_rate_warmup_steps", value=40),
            r("init_stop", "INTERVAL_END"),
            r("run_start", "INTERVAL_START"),
            r("block_start", "INTERVAL_START",
              metadata={"first_epoch_num": 1, "epoch_count": 1}),
            r("epoch_start", "INTERVAL_START", metadata={"epoch_num": 1}),
            r("eval_start", "INTERVAL_START", metadata={"epoch_num": 1.5}),
            r("eval_stop", "INTERVAL_END", metadata={"epoch_num": 1.5}),
            r("eval_accuracy", value=0.81, metadata={"epoch_num": 1.5}),
            r("run_stop", "INTERVAL_END", metadata={"status": "success"}),
            r("epoch_stop", "INTERVAL_END", metadata={"epoch_num": 1}),
            r("block_stop", "INTERVAL_END",
              metadata={"first_epoch_num": 1}),
        ]


def _drop(lines, key):
    return [ln for ln in lines if f'"key": "{key}"' not in ln]


def _replace(lines, old, new):
    return [ln.replace(old, new) for ln in lines]


def _duplicate_seed(log):
    lines = log.compliant()
    lines.insert(8, log.rec("seed", value=7, t=99))
    return lines


def _swap_init_stop_run_start(log):
    lines = log.compliant()
    i = next(k for k, ln in enumerate(lines) if '"init_stop"' in ln)
    lines[i], lines[i + 1] = lines[i + 1], lines[i]
    return lines


def _after_run_stop(log):
    lines = log.compliant()
    lines.append(log.rec("eval_accuracy", value=0.82,
                         metadata={"epoch_num": 2.0}))
    return lines


def _backwards(log):
    lines = log.compliant()
    lines[-1] = lines[-1].replace(f'"time_ms": {len(lines)}',
                                  '"time_ms": 1')
    return lines


def _no_epoch_num(log):
    return [log.rec("eval_accuracy", value=0.81, t=98)
            if '"eval_accuracy"' in ln else ln for ln in log.compliant()]


def _time_ms(bad):
    def build(log):
        lines = log.compliant()
        d = json.loads(lines[0][len(C.LINE_PREFIX):])
        d["time_ms"] = bad
        lines[0] = C.LINE_PREFIX + json.dumps(d)
        return lines
    return build


def _has(*parts):
    return lambda errs: any(all(p in e for p in parts) for e in errs)


# case: (log builder, what the JAX test asserts of the violations)
CASES = {
    "compliant_log_passes": (lambda log: log.compliant(),
                             lambda errs: errs == []),
    "non_mllog_lines_ignored": (
        lambda log: ["Finished training it 1/3", ""] + log.compliant()
        + ["done"], lambda errs: errs == []),
    "empty_log_fails": (lambda log: ["no events here"],
                        lambda errs: errs == ["no :::MLLOG records found"]),
    "missing_required_key": (lambda log: _drop(log.compliant(), "seed"),
                             _has("'seed'", "exactly once")),
    "duplicate_exactly_once_key": (_duplicate_seed,
                                   _has("'seed'", "seen 2x")),
    "bad_value_caught": (
        lambda log: _replace(log.compliant(), '"value": 0.4',
                             '"value": -0.4'),
        _has("opt_base_learning_rate")),
    "bad_run_stop_status": (
        lambda log: _replace(log.compliant(), '"status": "success"',
                             '"status": "crashed"'),
        _has("success/aborted")),
    "unclosed_interval": (
        lambda log: _drop(log.compliant(), "eval_stop"),
        lambda errs: (_has("eval_start never closed")(errs)
                      and _has("'eval_stop'")(errs))),
    "orphan_interval_end": (lambda log: _drop(log.compliant(), "eval_start"),
                            _has("without a matching eval_start")),
    "run_start_before_init_stop": (_swap_init_stop_run_start,
                                   _has("run_start precedes init_stop")),
    "events_after_run_stop_rejected": (_after_run_stop,
                                       _has("after run_stop")),
    "time_monotonicity": (_backwards, _has("time_ms went backwards")),
    "eval_accuracy_needs_epoch_num": (_no_epoch_num,
                                      _has("metadata.epoch_num required")),
}
BAD_TIMES = (None, "soon", True)


@pytest.mark.parametrize("case", list(CASES))
def test_same_violations_as_the_jax_checker(case):
    build, verdict = CASES[case]
    lines = build(_Log())
    errs = C.check_lines(lines)
    assert errs == J.check_lines(lines)
    assert verdict(errs), errs


def test_non_numeric_time_ms_is_violation_not_crash():
    """A malformed time_ms (null / string / bool) is a violation, not a
    crash, in both checkers."""
    for bad in BAD_TIMES:
        lines = _time_ms(bad)(_Log())
        errs = C.check_lines(lines)
        assert errs == J.check_lines(lines)
        assert _has("time_ms", "must be a number")(errs), (bad, errs)


def test_cli_exit_codes(tmp_path):
    log = _Log()
    good = tmp_path / "good.log"
    good.write_text("\n".join(log.compliant()) + "\n")
    bad = tmp_path / "bad.log"
    bad.write_text("\n".join(_drop(log.compliant(), "run_stop")) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert C.main([str(good)]) == 0
        assert C.main([str(bad)]) == 1
        assert C.main([]) == 2
    # the module as a user runs it
    for path, rc, said in ((good, 0, "compliant"),
                           (bad, 1, "NON-COMPLIANT: key 'run_stop'")):
        r = subprocess.run(
            [sys.executable, "-m", "dlrm_tpu_torch.utils.compliance",
             str(path)], cwd=ROOT, capture_output=True, text=True,
            timeout=60)
        assert r.returncode == rc and said in r.stdout, r.stdout + r.stderr


@pytest.mark.parametrize("threshold,status", [("0.01", "success"),
                                              ("0.999", "aborted")])
def test_port_mlperf_log_same_verdict(threshold, status):
    """The port's own event log (cli.main --mlperf-logging on the CPU, its
    submission block the port's logger writes): both checkers give the
    same violations, none, for a run stopped on its AUC threshold and for
    one that ends aborted below it."""
    from dlrm_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--mini-batch-size=2", "--data-size=8",
                       "--mlperf-logging", "--test-freq=2",
                       "--learning-rate=0.05",
                       f"--mlperf-auc-threshold={threshold}"], device="cpu")
    assert rc == 0
    lines = buf.getvalue().splitlines()
    stops = [json.loads(ln[len(C.LINE_PREFIX):]) for ln in lines
             if '"key": "run_stop"' in ln]
    assert [s["metadata"]["status"] for s in stops] == [status]
    assert C.check_lines(lines) == J.check_lines(lines) == []
