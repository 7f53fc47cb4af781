"""Readings that the limits of a cell's compared numbers are set from
(port_bench/limits/<workload>.json), taken on the card at the cell's own
size, many seeds in one process:

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 4,5,6] [--seconds 0.5]

For each seed one short run of the cell (set-up, the first steps, a window
of --seconds) prints the program's numbers; a seed in --control-seeds also
prints the control's (training: the reference in fp8 held to the fp32 one;
serving: the program with its int8 towers, quantize_mlps); a seed in
--fault-seeds also runs the program with half of each batch left out and
the mean taken over the rest (training: the labels of the second half
marked as padding, which the step's masked loss leaves out). One JSON line
a reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def half_batch(step):
    """The step with the second half of each batch left out."""

    def broken(params, opt, batch, lr):
        labels = batch.labels.clone()
        labels[labels.shape[0] // 2:] = -1.0
        return step(params, opt, batch._replace(labels=labels), lr)

    return broken


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.5)
    args = p.parse_args(argv)

    import torch

    from port_bench import core

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    cell = core.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    driver = cell.driver()
    control = seeds(args.control_seeds)
    train = cell.config["driver"] == "train"
    # training reads the control beside the program in the same run;
    # serving runs the program with its int8 towers on its own
    runs = [(s, "program", {"control": train and s in control})
            for s in seeds(args.seeds)]
    if not train:
        runs += [(s, "control", {"control": True}) for s in control]
    runs += [(s, "half_batch", {"fault": half_batch})
             for s in seeds(args.fault_seeds)]
    for seed, kind, kw in runs:
        t = time.perf_counter()
        res = driver.run(cell, seed, args.seconds, False, dev,
                         core.Stages(t), **kw)
        if "checks" in res:
            print(json.dumps({"seed": seed, "kind": kind,
                              "numbers": res["checks"].values,
                              "worst": res.get("worst"),
                              "seconds": time.perf_counter() - t}),
                  flush=True)
        if "control" in res:
            print(json.dumps({"seed": seed, "kind": "control",
                              "numbers": res["control"],
                              "look": res.get("look")}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    found = core.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
