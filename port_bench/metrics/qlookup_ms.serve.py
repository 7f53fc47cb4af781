"""Device milliseconds a batch of the quantized lookup (ops/quantized.py)
takes: the kernels launched under the program's "DLRM embedding forward"
scope (utils/profiling.py, live while its profile() traces), found by
their launches' correlation ids, over the batches in the traced window.
Moves serve_examples_per_s."""

SCOPE = "DLRM embedding forward"


def read(s):
    t = s.scope_s.get(SCOPE, 0.0)
    if s.kind != "serve" or s.steps == 0 or t <= 0:
        return None
    return {"value": t / s.steps * 1e3}
