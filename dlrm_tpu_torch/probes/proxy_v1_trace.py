"""The MLPerf proxy's v1 run (scripts/mlperf_proxy_run.py) step by step, on
the card and on the CPU, so that where the two runs part shows: every
step's loss (--print-freq=1) and the evaluations' AUCs of six runs over
one workdir's bins,

    card          the proxy's argv on the card
    card_no_eval  the same without its evaluations (--test-freq past the run)
    cpu           the proxy's argv on the CPU
    cpu_no_eval   the same without its evaluations
    cpu_ulp_tables  the proxy's argv on the CPU from tables scaled by
                    (1 + 2**-23), a change of one or two fp32 ulps
    cpu_ulp_towers  the same change to every other param (the towers)

(the last two: how far a change of the size of the devices' fp32 sums'
order carries)

and, for pairs of them, the first step whose printed loss differs, the
first that differs by more than 1e-5 (ten times what the six printed
decimals resolve), and the largest difference in each 80-step window.

    python -m dlrm_tpu_torch.probes.proxy_v1_trace <workdir> [out.json]

<workdir> holds the proxy's bins (`mlperf_proxy_run --phase v1` made
them). The losses go to out.json when given; the summary is printed.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys

import torch

from dlrm_tpu_torch import cli
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import tree_map
from dlrm_tpu_torch.scripts.mlperf_proxy_run import v1_argv

WINDOW = 80  # the proxy's --test-freq and --print-freq
PAIRS = [("card", "cpu"), ("card_no_eval", "cpu_no_eval"),
         ("card", "card_no_eval"), ("cpu", "cpu_no_eval"),
         ("cpu", "cpu_ulp_tables"), ("cpu", "cpu_ulp_towers"),
         ("card", "cpu_ulp_towers")]


@contextlib.contextmanager
def _ulp(tables: bool):
    """DLRMModel.init_params_numpy with every table (tables=True) or every
    other param scaled by 1 + 2**-23."""
    orig = DLRMModel.init_params_numpy

    def scaled(self, device="cuda"):
        params = orig(self, device)
        for key, tree in params.items():
            if (key == "emb") == tables:
                tree_map(lambda t: t.mul_(1 + 2**-23), tree)
        return params

    DLRMModel.init_params_numpy = scaled
    try:
        yield
    finally:
        DLRMModel.init_params_numpy = orig


def trace(workdir: str, device: str, evaluate: bool = True):
    """{"losses": each step's printed loss, "aucs": each evaluation's}."""
    argv = v1_argv(workdir, 0.70) + ["--print-freq=1"]
    if not evaluate:
        argv.append("--test-freq=1000000")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=device)
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}: {out[-2000:]}")
    return {
        "losses": [float(x) for x in re.findall(
            r"^Finished training it .* loss (\S+)$", out, re.M)],
        "aucs": [float(x) for x in re.findall(
            r'"key": "eval_accuracy", "value": ([^,]+),', out)],
    }


def compare(a, b):
    """The first step (1-based) whose printed losses differ, the first
    whose differ by more than 1e-5, and the largest difference in each
    WINDOW-step window of the common steps."""
    n = min(len(a), len(b))
    diff = [abs(x - y) for x, y in zip(a[:n], b[:n])]

    def first(above):
        return next((i + 1 for i, d in enumerate(diff) if d > above), None)

    windows = [max(diff[i:i + WINDOW]) for i in range(0, n, WINDOW)]
    return {"first_step": first(0.0), "first_above_1e-5": first(1e-5),
            "max_by_window": windows}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    workdir, out_path = args[0], (args[1] if len(args) > 1 else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {
        "card": trace(workdir, "cuda"),
        "card_no_eval": trace(workdir, "cuda", evaluate=False),
        "cpu": trace(workdir, "cpu"),
        "cpu_no_eval": trace(workdir, "cpu", evaluate=False),
    }
    for name, tables in (("cpu_ulp_tables", True),
                         ("cpu_ulp_towers", False)):
        with _ulp(tables):
            runs[name] = trace(workdir, "cpu")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(runs, f)
    for name, r in runs.items():
        print(f"{name}: {len(r['losses'])} steps, AUCs {r['aucs']}")
    for a, b in PAIRS:
        print(f"{a} against {b}: "
              + json.dumps(compare(runs[a]["losses"], runs[b]["losses"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
