"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

One process, one cell: set-up (each stage's seconds on standard error), the
measured window, the comparison with the plain reference, then the numbers
compared beside their limits as the last lines of standard error and the
result as the last line of standard output: the cell's end-to-end metrics
with --trace 0, its per-layer metrics (and the device's busy and window
seconds, and a breakdown) with --trace 1. Exits non-zero, printing no
result, where there is no card or fewer cards than the cell asks for, and
where a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc and g++ builds go to dlrm_tpu_torch/build/)
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench import core

    cell = core.load_cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    stages = core.Stages(T0)
    stages.mark("python, torch and the cell's files")
    res = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace),
                            dev, stages)

    out = core.report(cell, res, bool(args.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": chips, "power_limit": core.power_limit()})
    for k, v in res.get("worst", {}).items():
        print(f"worst leaf of {k}: {v}", file=sys.stderr)
    found = core.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    res["checks"].log()
    out["checks"] = res["checks"].table()
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
