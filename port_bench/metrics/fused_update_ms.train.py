"""Device milliseconds a step of the fused step (train/fused_step.py)
spends on its tables: the kernels launched under the program's "DLRM table
grads" scope (the hits' sort and coalesce_rows) and "DLRM table update"
scope (row_scatter_add and the row accumulators), found by their launches'
correlation ids, over the steps in the traced window; each half and the
hits a step (the counter "DLRM fused hits") ride beside it. Nothing where
the program counted no fused hit (the streamed step uses the same scopes).
Moves train_examples_per_s."""

from port_bench import program

SCOPES = ("DLRM table grads", "DLRM table update")
HITS = "DLRM fused hits"


def read(s):
    counters = getattr(program.profiling, "counters", None)
    if s.kind != "train" or s.steps == 0 or counters is None:
        return None
    hits = counters().get(HITS)
    grads, update = (s.scope_s.get(n, 0.0) for n in SCOPES)
    if not hits or grads <= 0 or update <= 0:
        return None
    return {"value": (grads + update) / s.steps * 1e3,
            "grads_ms": grads / s.steps * 1e3,
            "update_ms": update / s.steps * 1e3,
            "hits_per_step": hits / s.steps}
