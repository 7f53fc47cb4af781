"""P2: the streamed block copy on the card, and the take variants (the port
of bench_scripts/stream_variants.py).

t1_variants: the two takes of a [256, 128] block, both through row_gather
(T1v1 with a [8, 128] index block, T1v2 along the lanes of the transposed
block, as a gather of the transposed view's rows). time_stream: t * 1.000001
+ 0.5 over a 2.66 GB table by 2048-row blocks, as the reference's three
variants map to the card:
  stream no-alias no-donate  a fresh output each call
  stream no-alias donate     two buffers in turn (the input's memory is the
                             next output)
  stream alias donate        in place
and Tensor.copy_ between two buffers as the pure-copy ceiling.

    python -m dlrm_tpu_torch.probes.stream_variants
"""

from __future__ import annotations

import numpy as np
import torch

from dlrm_tpu_torch.ops.probe_kernels import block_stream, row_gather
from dlrm_tpu_torch.probes.common import probe_device, record, time_ms

R = 26 * 200_000 // 2048 * 2048
D = 128
BR = 2048
SCALE, SHIFT = 1.000001, 0.5
ITERS = 5


def t1_variants(dev) -> dict:
    """The two takes against their definitions; {name: "OK" | "WRONG" |
    "FAIL — ..."}, each printed."""
    b, d = 256, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dly = torch.randn((b, d), generator=gen, device=dev)
    idx2 = torch.from_numpy(np.random.default_rng(0).integers(
        0, b, (8, 128)).astype(np.int32)).to(dev)
    dly_t = dly.T.contiguous()  # [128, 256]
    cases = {
        "T1v1 take 2D idx": (lambda: row_gather(dly, idx2),
                             lambda: dly[idx2.long()]),
        # dlyT[:, idx]: a gather of the rows of dlyT's transposed view
        "T1v2 take lanes": (lambda: row_gather(dly_t.T, idx2[0]).T,
                            lambda: dly_t[:, idx2[0].long()]),
    }
    out = {}
    for name, (got, want) in cases.items():
        try:
            out[name] = "OK" if torch.equal(got(), want()) else "WRONG"
        except Exception as e:  # the reference reports a failing take
            out[name] = f"FAIL — {str(e).splitlines()[0][:160]}"
        print(f"{name}: {out[name]}", flush=True)
    return out


def time_stream(name, fn, dev) -> dict:
    """fn(t) -> the next t; mean over ITERS carried calls."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = {"t": torch.randn((R, D), generator=gen, device=dev)}

    def step():
        state["t"] = fn(state["t"])

    ms = time_ms(step, dev, ITERS)
    return record(name, ms, dev, nbytes=R * D * 4 * 2, width=38)


def main(device="cuda") -> dict:
    """Run P2; returns {"t1": {...}, "stream": {line: {"ms", "gbps", ...}}}."""
    dev = probe_device(device)
    t1 = t1_variants(dev)
    kw = dict(scale=SCALE, shift=SHIFT, block_rows=BR)
    spare = torch.empty((R, D), device=dev)

    def donate(t):  # write into the spare buffer; t becomes the next spare
        nonlocal spare
        out, spare = block_stream(t, out=spare, **kw), t
        return out

    def copy(t):
        nonlocal spare
        spare.copy_(t)
        return t

    variants = {
        "stream no-alias no-donate":
            lambda t: block_stream(t, out=torch.empty_like(t), **kw),
        "stream no-alias donate": donate,
        "stream alias donate": lambda t: block_stream(t, **kw),
        "torch copy_ (device to device)": copy,
    }
    stream = {name: time_stream(name, fn, dev)
              for name, fn in variants.items()}
    return {"t1": t1, "stream": stream}


if __name__ == "__main__":
    main()
