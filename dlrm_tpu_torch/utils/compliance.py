"""MLPerf training-log compliance checker (DLRM rule set): the port's copy
of dlrm_tpu/utils/compliance.py (standard library only), so that the port
checks its event logs without importing the JAX package.

The reference validates its event log with the official `mlperf_logging`
compliance checker (`mlperf_logger.py:16-22` imports the package;
`bench/run_and_time.sh:17` wraps the run the checker consumes). That
package is not a dependency, so this module carries the checker's
ARCHITECTURE — a declarative rule set evaluated by a small engine — with the
DLRM closed-division rules expressed the same way the official
`training_*.0/closed_dlrm*.yaml` files express them:

  * line format: every record is `:::MLLOG <json>` with namespace /
    time_ms / event_type / key / value / metadata fields;
  * occurrence: per-key requirements (EXACTLY_ONE / AT_LEAST_ONE);
  * value checks: predicates over the record's value and metadata;
  * interval pairing: INTERVAL_START/INTERVAL_END must match per key
    (eval_start N <-> eval_stop N, one run_start <-> one run_stop, ...);
  * ordering: the INIT block precedes RUN_START; all training intervals
    live inside [run_start, run_stop]; time_ms is non-decreasing;
  * termination: run_stop carries metadata.status in {success, aborted}.

The engine returns a LIST OF VIOLATIONS (empty = compliant) so callers can
fail loudly with every problem at once; `python -m
dlrm_tpu_torch.utils.compliance <log>` exits 1 on any violation and 0 on a
compliant log (the official checker's CLI contract).
dlrm_tpu_torch/scripts/mlperf_proxy_run.py checks its v1 log with it. The
port's log (utils/logging.py's MLPerfLogger) keeps the JAX package's
submission block, so the same rules hold for both.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

LINE_PREFIX = ":::MLLOG "

EXACTLY_ONE = "EXACTLY_ONE"
AT_LEAST_ONE = "AT_LEAST_ONE"
OPTIONAL = "OPTIONAL"


@dataclass
class KeyRule:
    """One key's requirements (the YAML `- KEY:` entry of the official
    checker)."""

    name: str
    req: str = OPTIONAL
    # predicate(value, metadata) -> error string or None
    check: Optional[Callable[[object, dict], Optional[str]]] = None


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _in(*allowed):
    def f(v, md):
        if v not in allowed:
            return f"value {v!r} not in {sorted(map(str, allowed))}"
    return f


def _pos_num(v, md):
    if not _is_num(v) or v <= 0:
        return f"value {v!r} must be a positive number"


def _num(v, md):
    if not _is_num(v):
        return f"value {v!r} must be a number"


def _int(v, md):
    if not isinstance(v, int) or isinstance(v, bool):
        return f"value {v!r} must be an integer"


def _eval_accuracy(v, md):
    if not _is_num(v):
        return f"value {v!r} must be a number"
    if not 0.0 <= v <= 1.0:
        return f"AUC {v} outside [0, 1]"
    if "epoch_num" not in md:
        return "metadata.epoch_num required"


def _run_stop(v, md):
    if md.get("status") not in ("success", "aborted"):
        return f"metadata.status {md.get('status')!r} not in success/aborted"


def _epoch_md(v, md):
    if "epoch_num" not in md:
        return "metadata.epoch_num required"


# DLRM closed-division rule set (official closed_dlrm.yaml semantics; key
# vocabulary = what dlrm_s_pytorch.py:1036-1781 emits through
# mlperf_logger.py)
DLRM_RULES: List[KeyRule] = [
    KeyRule("cache_clear", AT_LEAST_ONE),
    KeyRule("init_start", EXACTLY_ONE),
    KeyRule("init_stop", EXACTLY_ONE),
    KeyRule("run_start", EXACTLY_ONE),
    KeyRule("run_stop", EXACTLY_ONE, _run_stop),
    KeyRule("submission_benchmark", EXACTLY_ONE,
            _in("dlrm", "dlrm_v2", "dlrm_dcnv2")),
    KeyRule("submission_division", EXACTLY_ONE, _in("closed", "open")),
    KeyRule("submission_org", EXACTLY_ONE),
    KeyRule("submission_platform", EXACTLY_ONE),
    KeyRule("submission_status", EXACTLY_ONE,
            _in("onprem", "cloud", "research", "preview")),
    KeyRule("seed", EXACTLY_ONE, _int),
    KeyRule("global_batch_size", EXACTLY_ONE, _pos_num),
    KeyRule("opt_base_learning_rate", EXACTLY_ONE, _pos_num),
    KeyRule("opt_learning_rate_warmup_steps", EXACTLY_ONE, _int),
    KeyRule("lr_decay_start_steps", OPTIONAL, _int),
    KeyRule("sgd_opt_learning_rate_decay_steps", OPTIONAL, _int),
    KeyRule("epoch_start", AT_LEAST_ONE, _epoch_md),
    KeyRule("epoch_stop", AT_LEAST_ONE, _epoch_md),
    KeyRule("block_start", AT_LEAST_ONE),
    KeyRule("block_stop", AT_LEAST_ONE),
    KeyRule("eval_start", AT_LEAST_ONE),
    KeyRule("eval_stop", AT_LEAST_ONE),
    KeyRule("eval_accuracy", AT_LEAST_ONE, _eval_accuracy),
    KeyRule("train_samples", OPTIONAL, _pos_num),
    KeyRule("eval_samples", OPTIONAL, _pos_num),
]

# interval keys whose START/STOP pair up (the official START/END block)
INTERVALS = ("init", "run", "epoch", "block", "eval")


@dataclass
class Record:
    line_no: int
    time_ms: int
    event_type: str
    key: str
    value: object
    metadata: dict = field(default_factory=dict)


def parse_lines(lines: Sequence[str]) -> tuple[List[Record], List[str]]:
    """Extract and structurally validate the :::MLLOG records."""
    recs: List[Record] = []
    errors: List[str] = []
    for i, line in enumerate(lines, 1):
        line = line.rstrip("\n")
        if not line.startswith(LINE_PREFIX):
            continue
        try:
            d = json.loads(line[len(LINE_PREFIX):])
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: malformed JSON after {LINE_PREFIX!r}: {e}")
            continue
        missing = [
            f for f in
            ("namespace", "time_ms", "event_type", "key", "value", "metadata")
            if f not in d
        ]
        if missing:
            errors.append(f"line {i}: missing fields {missing}")
            continue
        if d["event_type"] not in (
            "INTERVAL_START", "INTERVAL_END", "POINT_IN_TIME"
        ):
            errors.append(f"line {i}: bad event_type {d['event_type']!r}")
            continue
        if not isinstance(d["metadata"], dict):
            errors.append(f"line {i}: metadata must be an object")
            continue
        # a malformed time_ms is a VIOLATION, not a checker crash — the
        # CLI must exit 1 with NON-COMPLIANT lines, never a traceback
        if not _is_num(d["time_ms"]):
            errors.append(
                f"line {i}: time_ms {d['time_ms']!r} must be a number"
            )
            continue
        recs.append(Record(i, int(d["time_ms"]), d["event_type"], d["key"],
                           d["value"], d["metadata"]))
    return recs, errors


def check_records(recs: List[Record],
                  rules: Sequence[KeyRule] = DLRM_RULES) -> List[str]:
    errors: List[str] = []
    by_key: Dict[str, List[Record]] = {}
    for r in recs:
        by_key.setdefault(r.key, []).append(r)

    # occurrence + per-record value checks
    for rule in rules:
        got = by_key.get(rule.name, [])
        if rule.req == EXACTLY_ONE and len(got) != 1:
            errors.append(
                f"key {rule.name!r}: required exactly once, seen {len(got)}x"
            )
        elif rule.req == AT_LEAST_ONE and not got:
            errors.append(f"key {rule.name!r}: required at least once, absent")
        if rule.check:
            for r in got:
                msg = rule.check(r.value, r.metadata)
                if msg:
                    errors.append(f"line {r.line_no} ({r.key}): {msg}")

    # time monotonicity
    for a, b in zip(recs, recs[1:]):
        if b.time_ms < a.time_ms:
            errors.append(
                f"line {b.line_no}: time_ms went backwards "
                f"({a.time_ms} -> {b.time_ms})"
            )
            break

    # interval pairing: starts and stops of each interval key must
    # alternate start/stop (no nested same-key intervals, no orphans)
    for name in INTERVALS:
        seq = [r for r in recs if r.key in (f"{name}_start", f"{name}_stop")]
        open_rec = None
        for r in seq:
            if r.key.endswith("_start"):
                if r.event_type != "INTERVAL_START":
                    errors.append(
                        f"line {r.line_no}: {r.key} must be INTERVAL_START"
                    )
                if open_rec is not None:
                    errors.append(
                        f"line {r.line_no}: {name} interval re-opened "
                        f"(previous start line {open_rec.line_no} unclosed)"
                    )
                open_rec = r
            else:
                if r.event_type != "INTERVAL_END":
                    errors.append(
                        f"line {r.line_no}: {r.key} must be INTERVAL_END"
                    )
                if open_rec is None:
                    errors.append(
                        f"line {r.line_no}: {r.key} without a matching "
                        f"{name}_start"
                    )
                open_rec = None
        if open_rec is not None:
            errors.append(
                f"line {open_rec.line_no}: {name}_start never closed"
            )

    # ordering: INIT block before RUN_START; training intervals inside the
    # run; run_stop after every eval_accuracy it gates on
    def first(key):
        return by_key.get(key, [None])[0]

    def pos(r):
        return recs.index(r)

    init_start, init_stop = first("init_start"), first("init_stop")
    run_start, run_stop = first("run_start"), first("run_stop")
    if init_start and init_stop and pos(init_stop) < pos(init_start):
        errors.append("init_stop precedes init_start")
    if init_stop and run_start and pos(run_start) < pos(init_stop):
        errors.append("run_start precedes init_stop")
    if run_start and run_stop and pos(run_stop) < pos(run_start):
        errors.append("run_stop precedes run_start")
    if run_start and run_stop:
        lo, hi = pos(run_start), pos(run_stop)
        for key in ("epoch_start", "eval_start", "eval_stop",
                    "eval_accuracy", "block_start"):
            for r in by_key.get(key, []):
                if pos(r) < lo:
                    errors.append(
                        f"line {r.line_no}: {key} before run_start"
                    )
        # the reference closes the enclosing epoch/block AFTER run_stop at
        # a threshold stop (dlrm_s_pytorch.py:1755-1770): only *_stop may
        # trail it
        for r in recs[hi + 1:]:
            if r.key not in ("epoch_stop", "block_stop"):
                errors.append(
                    f"line {r.line_no}: {r.key} after run_stop "
                    "(only epoch_stop/block_stop may trail)"
                )
    return errors


def check_lines(lines: Sequence[str],
                rules: Sequence[KeyRule] = DLRM_RULES) -> List[str]:
    recs, errors = parse_lines(lines)
    if not recs and not errors:
        return ["no :::MLLOG records found"]
    return errors + check_records(recs, rules)


def check_file(path: str, rules: Sequence[KeyRule] = DLRM_RULES) -> List[str]:
    with open(path) as f:
        return check_lines(f.readlines(), rules)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m dlrm_tpu_torch.utils.compliance <log-file>",
              file=sys.stderr)
        return 2
    errors = check_file(argv[0])
    if errors:
        for e in errors:
            print(f"NON-COMPLIANT: {e}")
        return 1
    print("compliant")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
