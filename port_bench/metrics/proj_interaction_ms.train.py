"""Device milliseconds a train step spends in the projection interaction
(ops/interaction.py, torchrec's DLRM_Projection): the kernels launched under
the program's "DLRM interaction forward" scope (models/dlrm.py) and under
its "DLRM interaction backward" scope (opened where the autograd engine
runs the branches' and the bmm's backward, utils/profiling.py::
backward_scope), found by their launches' correlation ids, over the steps
in the traced window; each half rides beside it. Nothing where either
scope launched no kernel. Moves train_examples_per_s."""

SCOPES = ("DLRM interaction forward", "DLRM interaction backward")


def read(s):
    fwd, bwd = (s.scope_s.get(n, 0.0) for n in SCOPES)
    if s.kind != "train" or s.steps == 0 or fwd <= 0 or bwd <= 0:
        return None
    return {"value": (fwd + bwd) / s.steps * 1e3,
            "forward_ms": fwd / s.steps * 1e3,
            "backward_ms": bwd / s.steps * 1e3}
