"""End-to-end MLPerf proxy run on the port (the twin of
scripts/mlperf_proxy_run.py, driving dlrm_tpu_torch's trainers).

Real-Criteo convergence (AUC 0.8025, dlrm_s_pytorch.py:1012-1013) needs the
dataset, which is not in the repository. This script is the strongest
available proxy: it exercises the WHOLE loop as one system on a generated
multi-day Criteo-FORMAT dataset with a planted learnable signal:

  raw tsv day files  ->  out-of-core streaming preprocess (worker
  processes, cross-day shuffle)  ->  packed train/test bins  ->
  cli.py --mlperf-logging --mlperf-bin-loader --mlperf-bin-shuffle
  --mlperf-auc-threshold ...  ->  LR policy + periodic exact-AUC eval
  ->  auc-threshold EARLY STOP with a compliant MLPerf event log
  (RUN_STOP status=success) —
the run_and_time.sh flow (bench/run_and_time.sh:17) minus the 1TB download.
The log is checked by the port's copy of the compliance checker
(utils/compliance.py).

A second phase drives the SAME bins through the v2 trainer
(--in_memory_binary_criteo_path) with DCN interaction + streamed bf16
tables (K2 on the card) + --validation_freq_within_epoch/--auroc_target,
reaching the AUROC target and stopping early (torchrec_dlrm/dlrm_main.py:552
analog).

Usage:  python -m dlrm_tpu_torch.scripts.mlperf_proxy_run [--workdir DIR]
            [--days N] [--rows-per-day N] [--auc-threshold X]
            [--auroc-target X] [--phase v1|v2|both]
It trains on the card; main(argv, device="cpu") on the CPU (the tests do).
Exits 0 only if the run(s) stop ON THRESHOLD with the right event log. The
same seed gives the same raw days, byte for byte, as the JAX script's.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(),
                               "dlrm_torch_mlperf_proxy")


def _check(cond, msg):
    """Hard verification (NOT assert: `python -O` must not turn the
    proxy's pass/fail contract into an unconditional pass)."""
    if not cond:
        raise RuntimeError(f"proxy verification failed: {msg}")


class _Tee(io.TextIOBase):
    """Write-through capture: the event log still streams to the console
    while being parsed for verification."""

    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, s):
        for k in self.sinks:
            k.write(s)
        return len(s)

    def flush(self):
        for k in self.sinks:
            k.flush()


def _run(main, argv, device):
    """main(argv, device=device) with its output shown and captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main(argv, device=device)
    return rc, buf.getvalue()


def generate_raw_days(out_dir: str, days: int, rows: int, seed: int = 0):
    """Criteo-format raw tsv days (label \\t 13 int \\t 26 hex) with a
    PLANTED signal: the label is Bernoulli(sigmoid(s)) where s mixes a
    linear function of log1p(dense) (what the model sees after the
    reference's log-transform, dlrm_data_pytorch.py:324-337) with strong
    per-value effects on the first two categorical columns — learnable by
    the embeddings + MLPs, so AUC climbs well above 0.5."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.0, 13)
    vocab = 40
    eff0 = rng.normal(0, 1.2, vocab)
    eff1 = rng.normal(0, 1.2, vocab)
    paths = []
    for d in range(days):
        path = os.path.join(out_dir, f"day_{d}")
        paths.append(path)
        if os.path.exists(path):
            continue
        # per-day RNG (not the shared stream): resuming a partially
        # generated workdir must not give later days the draws an earlier
        # (skipped) day consumed — that would make the held-out test day a
        # byte-duplicate of a training day and pass the proxy by
        # memorization
        rng = np.random.default_rng(seed + 1000 + d)
        dense = rng.integers(0, 200, size=(rows, 13))
        z = (np.log1p(dense) - 3.7) @ w / np.sqrt(13)
        c0 = rng.integers(0, vocab, rows)
        c1 = rng.integers(0, vocab, rows)
        other = rng.integers(0, 1 << 20, size=(rows, 24))
        s = 1.5 * z + eff0[c0] + eff1[c1]
        label = (rng.random(rows) < 1.0 / (1.0 + np.exp(-s))).astype(int)
        with open(path, "wb") as f:
            for i in range(rows):
                cats = [format(c0[i], "x"), format(c1[i], "x")] + [
                    format(v, "x") for v in other[i]
                ]
                f.write(
                    (
                        f"{label[i]}\t"
                        + "\t".join(str(x) for x in dense[i])
                        + "\t"
                        + "\t".join(cats)
                        + "\n"
                    ).encode()
                )
    return paths


def v1_argv(workdir: str, auc_threshold: float) -> list:
    """The v1 phase's cli.py argv over the workdir's bins."""
    return [
        "--data-generation=dataset",
        "--data-set=terabyte",
        f"--raw-data-file={os.path.join(workdir, 'raw', 'day')}",
        f"--processed-data-file={os.path.join(workdir, 'proc', 'x')}",
        "--dataset-multiprocessing",  # out-of-core streaming preprocess
        "--arch-sparse-feature-size=16",
        "--arch-mlp-bot=13-32-16",
        "--arch-mlp-top=32-16-1",
        "--loss-function=bce",
        "--round-targets=True",
        "--mini-batch-size=128",
        "--nepochs=4",
        "--optimizer=sgd",
        "--learning-rate=0.4",
        "--lr-num-warmup-steps=40",
        "--lr-decay-start-step=400",
        "--lr-num-decay-steps=800",
        "--test-freq=80",
        "--print-freq=80",
        "--mlperf-logging",
        "--mlperf-bin-loader",
        "--mlperf-bin-shuffle",
        f"--mlperf-auc-threshold={auc_threshold}",
    ]


def run_v1(workdir: str, auc_threshold: float, device="cuda") -> None:
    """cli.py over the proxy bins to an auc-threshold early stop with a
    compliant event log."""
    from dlrm_tpu_torch import cli

    argv = v1_argv(workdir, auc_threshold)
    print("[proxy] v1 run:", " ".join(argv), flush=True)
    rc, out = _run(cli.main, argv, device)
    _check(rc == 0, f"cli.main returned {rc}")
    _check(
        f"MLPerf testing auc threshold {auc_threshold} reached" in out,
        "run did NOT stop on the auc threshold",
    )
    # FULL compliance check over the event log: rule-set-driven checker
    # (utils/compliance.py — occurrence / value / interval-pairing /
    # ordering rules, the official mlperf_logging checker's architecture
    # with the DLRM closed rules). Any violation is a hard proxy failure.
    from dlrm_tpu_torch.utils.compliance import check_lines

    violations = check_lines(out.splitlines())
    _check(not violations, "compliance checker violations:\n  "
           + "\n  ".join(violations))
    events = [
        json.loads(line.split(":::MLLOG ", 1)[1])
        for line in out.splitlines()
        if line.startswith(":::MLLOG")
    ]
    keys = [e["key"] for e in events]
    # the reference event sequence starts with the cache-clear + INIT block
    # (dlrm_s_pytorch.py:1036-1040); the checker validates ordering, this
    # pins the exact prefix
    prefix = ["cache_clear", "init_start", "init_stop", "run_start"]
    _check(keys[: len(prefix)] == prefix, f"bad event prefix {keys[:8]}")
    # a threshold stop must be a SUCCESS run specifically (the checker only
    # requires success|aborted)
    stop = [e for e in events if e["key"] == "run_stop"]
    _check(
        stop[0]["metadata"]["status"] == "success", f"bad run_stop {stop}"
    )
    aucs = [
        e["value"] for e in events if e["key"] == "eval_accuracy"
    ]
    _check(aucs[-1] > auc_threshold, f"final AUC {aucs[-1]} <= {auc_threshold}")
    print(
        f"[proxy] v1 OK: {len(aucs)} evals, AUC "
        f"{aucs[0]:.4f} -> {aucs[-1]:.4f} >= {auc_threshold}, "
        "RUN_STOP success", flush=True,
    )


def run_v2(workdir: str, auroc_target: float, device="cuda") -> None:
    """The v2 trainer (DCN + streamed bf16 tables) over the same bins to an
    --auroc_target early stop."""
    import numpy as np

    from dlrm_tpu_torch import v2_main
    from dlrm_tpu_torch.data import criteo_stream

    proc = os.path.join(workdir, "proc")
    counts = np.load(os.path.join(proc, "day_fea_count.npz"))
    counts = counts[list(counts.keys())[0]]
    # the v1 phase builds train/test bins; v2 also wants the val split
    # (second half of the last day, disjoint from test's first half)
    val_bin = os.path.join(proc, "val_data.bin")
    if not os.path.exists(val_bin):
        days = sorted(
            p[: -len(".y.npy")]
            for p in (os.path.join(proc, f) for f in os.listdir(proc))
            if p.endswith(".y.npy")
        )
        last = max(
            days,
            key=lambda p: int(
                os.path.basename(p).split("day_")[1].split("_")[0]
            ),
        )
        criteo_stream.days_to_binary_streaming([last], val_bin, "val")
    argv = [
        "--in_memory_binary_criteo_path", os.path.join(workdir, "proc"),
        "--num_embeddings_per_feature", ",".join(str(int(c)) for c in counts),
        "--embedding_dim", "16",
        "--dense_arch_layer_sizes", "32,16",
        "--over_arch_layer_sizes", "32,16,1",
        "--interaction_type", "dcn",
        "--dcn_num_layers", "2",
        "--dcn_low_rank_dim", "16",
        "--embedding_impl", "stream",
        "--embedding_dtype", "bfloat16",
        "--batch_size", "512",
        "--epochs", "6",
        "--adagrad",
        "--learning_rate", "0.05",
        "--validation_freq_within_epoch", "30",
        "--auroc_target", str(auroc_target),
    ]
    print("[proxy] v2 run:", " ".join(argv), flush=True)
    rc, out = _run(v2_main.main, argv, device)
    _check(rc == 0, f"v2_main returned {rc}")
    _check(
        f"AUROC target {auroc_target} reached" in out,
        "v2 run did NOT stop on the AUROC target",
    )
    print(f"[proxy] v2 OK: stopped early at AUROC >= {auroc_target}",
          flush=True)


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=DEFAULT_WORKDIR)
    p.add_argument("--days", type=int, default=24)
    p.add_argument("--rows-per-day", type=int, default=1500)
    p.add_argument("--auc-threshold", type=float, default=0.75)
    p.add_argument("--auroc-target", type=float, default=0.72)
    p.add_argument("--phase", choices=["v1", "v2", "both"], default="both")
    args = p.parse_args(argv)

    if args.phase in ("v1", "both") and args.days != 24:
        # the terabyte raw layout is day_0..day_23 (data_utils.py hardcodes
        # 24 days; make_criteo_datasets mirrors it)
        p.error("the v1 phase needs --days 24 (terabyte day layout)")
    # generation and preprocessing skip files that already exist, so a
    # workdir carries its config fingerprint: reusing one with a DIFFERENT
    # config would silently train on the old data and report success for a
    # run that never happened
    cfg = {"days": args.days, "rows_per_day": args.rows_per_day}
    cfg_path = os.path.join(args.workdir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            prev = json.load(f)
        if prev != cfg:
            p.error(
                f"workdir {args.workdir} was generated with {prev}, "
                f"requested {cfg} — point --workdir at a fresh directory"
            )
    elif os.path.exists(os.path.join(args.workdir, "raw")):
        p.error(
            f"workdir {args.workdir} has raw days but no config.json "
            "(unknown provenance) — point --workdir at a fresh directory"
        )
    if args.phase == "v2" and not os.path.exists(
        os.path.join(args.workdir, "proc", "day_fea_count.npz")
    ):
        p.error(
            "--phase v2 needs the v1 phase's preprocessed bins in the "
            "workdir — run --phase both (or v1 first)"
        )
    os.makedirs(os.path.join(args.workdir, "proc"), exist_ok=True)
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    generate_raw_days(
        os.path.join(args.workdir, "raw"), args.days, args.rows_per_day
    )
    print(f"[proxy] {args.days} raw days x {args.rows_per_day} rows ready",
          flush=True)
    if args.phase in ("v1", "both"):
        run_v1(args.workdir, args.auc_threshold, device)
    if args.phase in ("v2", "both"):
        run_v2(args.workdir, args.auroc_target, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
