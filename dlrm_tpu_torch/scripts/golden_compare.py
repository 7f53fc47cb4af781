"""Compare a trainer's log with a golden log: the same text, every number
within 5e-6 (TOL). The port's numbers are not byte-equal to the JAX
package's, whose runs wrote test_scripts/golden/, so the port's golden test
(dlrm_tpu_test.sh beside this file) and tests/test_torch_cli.py hold it to
this rule.

    python -m dlrm_tpu_torch.scripts.golden_compare <golden> <log>

exits 0 when they agree and 1 (printing the first differences) when not.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import List, Optional

NUM = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+")
TOL = 5e-6


def differences(got: str, want: str) -> List[str]:
    """What keeps `got` from matching `want`: its lines whose text (numbers
    masked) differs, or whose numbers differ by more than TOL; [] when
    they agree."""
    a, b = got.splitlines(), want.splitlines()
    out = []
    if len(a) != len(b):
        out.append(f"{len(a)} lines, the golden has {len(b)}")
    for i, (x, y) in enumerate(zip(a, b), 1):
        if NUM.sub("#", x) != NUM.sub("#", y):
            out.append(f"line {i}: text {x!r} != golden {y!r}")
            continue
        for u, v in zip(NUM.findall(x), NUM.findall(y)):
            if abs(float(u) - float(v)) > TOL:
                out.append(f"line {i}: {u} != golden {v} (beyond {TOL:g})")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("golden")
    p.add_argument("log")
    args = p.parse_args(argv)
    with open(args.golden) as f:
        want = f.read()
    with open(args.log) as f:
        got = f.read()
    diff = differences(got, want)
    for line in diff[:20]:
        print(line)
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())
