"""The whole forward's share of the card's peak in a serving cell: the
larger of the model's forward FLOPs over 989 TFLOP/s (bf16) and the
batch's compulsory bytes (each distinct int8 row read once, the batch, the
dense parameters; roofline/work.py) over 3.35 TB/s, over the traced
window's time a batch; which bounds it and the card's power limit ride
beside it. Moves serve_examples_per_s."""

from port_bench.roofline import work


def read(s):
    if s.kind != "serve" or s.steps == 0 or "flops" not in s.work:
        return None
    got = work.share(s.work["flops"], s.work["bytes"], s.window_s)
    return {"value": got["pct"], "bound_by": got["bound_by"],
            "power_limit": s.power}
