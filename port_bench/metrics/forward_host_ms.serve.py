"""Host milliseconds a served batch spends in the model's forward call
(DLRMModel.apply_with_logits, the program's "DLRM forward" span): the
Python dispatch of its ATen calls and the waits of its synchronizing
copies, summed over the traced stretch, over the batches in the window.
Moves serve_examples_per_s: the dispatching thread enqueues the next
batch only after it."""

from port_bench import program

SPAN = "DLRM forward"


def read(s):
    spans = getattr(program.profiling, "spans", None)
    if s.kind != "serve" or s.steps == 0 or spans is None:
        return None
    ms = [x.host_ms for x in spans() if x.name == SPAN]
    if not ms:
        return None
    return {"value": sum(ms) / s.steps, "spans": len(ms)}
