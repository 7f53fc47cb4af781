"""The projection interaction's share of its roofline: its FLOPs forward
and backward (the two branches' products and the bmm, roofline/
work_proj.py::interaction_flops, over the traced steps) over 989 TFLOP/s
(bf16), over the device time of the kernels under its two scopes (as
proj_interaction_ms.train reads them); the card's power limit rides beside
it. Nothing where either scope launched no kernel. Moves
train_examples_per_s."""

from port_bench.roofline import work_proj

SCOPES = ("DLRM interaction forward", "DLRM interaction backward")


def read(s):
    t = [s.scope_s.get(n, 0.0) for n in SCOPES]
    if s.kind != "train" or min(t) <= 0 or not s.work.get("proj_flops"):
        return None
    return {"value": 100.0 * s.work["proj_flops"] / work_proj.PEAK_FLOPS_BF16
            / sum(t), "bound_by": "flops", "power_limit": s.power}
