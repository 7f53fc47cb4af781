"""The whole train step's share of the card's peak: the larger of the
model's FLOPs over 989 TFLOP/s (bf16) and the step's compulsory bytes over
3.35 TB/s (roofline/work.py), over the traced window's time a step; which
of the two bounds it, and the card's power limit, ride beside it. Moves
train_examples_per_s, and bounds what any kernel's roofline can claim."""

from port_bench.roofline import work


def read(s):
    if s.kind != "train" or s.steps == 0 or "flops" not in s.work:
        return None
    got = work.share(s.work["flops"], s.work["bytes"], s.window_s)
    return {"value": got["pct"], "bound_by": got["bound_by"],
            "power_limit": s.power}
