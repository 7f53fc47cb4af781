"""Host milliseconds a train step waits for its batch: the program's
"DLRM prefetch wait" spans (around the consumer's queue get in
train/pipeline.py::DevicePrefetcher) in the traced stretch, over the steps
in the window. Beside it, the longest wait. Moves train_examples_per_s
where the producer paces the steps."""

from port_bench import program

SPAN = "DLRM prefetch wait"


def read(s):
    spans = getattr(program.profiling, "spans", None)
    if s.kind != "train" or s.steps == 0 or spans is None:
        return None
    ms = [x.host_ms for x in spans() if x.name == SPAN]
    if not ms:
        return None
    return {"value": sum(ms) / s.steps, "waits": len(ms), "max_ms": max(ms)}
