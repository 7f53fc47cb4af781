"""K2's share of its roofline (csrc/stream_update.cu, the streamed
embedding update): the bytes it must move on the touched-only item list
(roofline/work.py::k2_bytes, from the traced steps' own batches) over
3.35 TB/s, over the device time of its kernels (`k2_kernel` in their names)
in the trace; the card's power limit rides beside it. Nothing where no K2
kernel ran. Moves train_examples_per_s."""

from port_bench.roofline import work


def read(s):
    k2_s = sum(v for n, v in s.op_s.items() if "k2_kernel" in n)
    if s.kind != "train" or k2_s <= 0 or "k2_bytes" not in s.work:
        return None
    return {"value": 100.0 * s.work["k2_bytes"] / work.PEAK_BYTES / k2_s,
            "bound_by": "bytes", "power_limit": s.power}
