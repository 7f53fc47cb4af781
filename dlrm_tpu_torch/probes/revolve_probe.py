"""P4: the block revolve on the card, out[blk] = t[blk] + 1 over a walk of
2048-row blocks (the port of bench_scripts/revolve_probe.py, which isolated
the TPU pipeline's cost of a data-dependent block walk: K2's skeleton).

The reference's variants, as they map to the card (block_stream: one short
CTA per span of a block, 8 KB at depth 1 and 16 KB at depths 2 and 4,
twice that on a walk read from ib):
  S  static map, separate output
  D  the walk read from ib, separate output
  M  the walk read from ib, in place (the reference's manual write)
  N  static map, in place
  P  static map, separate output, 2 loads in flight per thread (the
     reference's depth-2 read-ahead)
  Q  the same with 4 (depth-4 read-ahead)
  E  the plain version t + 1 (XLA's elementwise op there)
  X  the plain version of the walk, a loop of slice updates (XLA's
     fori_loop there)
  C  Tensor.copy_ between two buffers: the pure-copy ceiling
ib is the identity walk, as in the reference. Each variant's table starts
at 1.0 and is checked after its runs: every element must equal 1 + the
number of calls, exactly.

    python -m dlrm_tpu_torch.probes.revolve_probe [S,D,M,N,P,Q,E,X,C]
"""

from __future__ import annotations

import sys

import torch

from dlrm_tpu_torch.ops.probe_kernels import block_stream, block_stream_plain
from dlrm_tpu_torch.probes.common import probe_device, time_ms

BR = 2048
NBLK = 1024
D_ = 128
ITERS = 20  # the variants and E differ by about 1 %
VARIANTS = "S,D,M,N,P,Q,E,X,C"


def variant_fn(variant, ib):
    """variant -> fn(t) giving the next t."""
    kw = dict(scale=1.0, shift=1.0, block_rows=BR)
    spare = {}

    def out_of_place(walk, depth=1):
        def fn(t):
            out = spare.pop("t", None)
            if out is None:
                out = torch.empty_like(t)
            block_stream(t, walk, out=out, depth=depth, **kw)
            spare["t"] = t
            return out
        return fn

    def copy(t):
        out = spare.pop("t", None)
        if out is None:
            out = torch.empty_like(t)
        out.copy_(t)
        spare["t"] = t
        return out

    return {
        "S": out_of_place(None),
        "D": out_of_place(ib),
        "M": lambda t: block_stream(t, ib, **kw),
        "N": lambda t: block_stream(t, None, **kw),
        "P": out_of_place(None, depth=2),
        "Q": out_of_place(None, depth=4),
        "E": lambda t: t + 1.0,
        "X": lambda t: block_stream_plain(t, ib, **kw),
        "C": copy,
    }[variant]


def main(device="cuda", variants: str = VARIANTS) -> dict:
    """Run P4's variants; returns {variant: {"ms", "gbps", "us_per_blk",
    "nbytes"}}."""
    dev = probe_device(device)
    ib = torch.arange(NBLK, dtype=torch.int32, device=dev)
    nbytes = 2 * NBLK * BR * D_ * 4
    res = {}
    for variant in variants.split(","):
        fn = variant_fn(variant, ib)
        state = {"t": torch.ones((NBLK * BR, D_), device=dev),
                 "calls": 0}

        def step():
            state["t"] = fn(state["t"])
            state["calls"] += 1

        ms = time_ms(step, dev, ITERS)
        want = 1.0 + (state["calls"] if variant != "C" else 0)
        if not bool((state["t"] == want).all()):
            raise AssertionError(f"revolve {variant}: values differ from "
                                 f"1 + {state['calls']} calls")
        rec = {"ms": ms, "us_per_blk": ms * 1e3 / NBLK, "nbytes": nbytes,
               "gbps": nbytes / (ms * 1e6)}
        print(f"{variant}: {ms:9.2f} ms/iter  ({rec['us_per_blk']:7.1f} "
              f"us/blk, {rec['gbps']:6.1f} GB/s), values OK"
              + ("" if dev.type == "cuda" else "  [cpu host clock]"),
              flush=True)
        res[variant] = rec
        del state, fn
    return res


if __name__ == "__main__":
    main(variants=sys.argv[1] if len(sys.argv) > 1 else VARIANTS)
