"""Device milliseconds a train step spends on the table's per-hit grads
G_u (gather_grads, or K1 window_grads): the CUDA events of the program's
"DLRM table grads" span (train/stream_step.py; utils/profiling.py keeps
its spans while profile() traces), summed over the traced stretch, over
the steps in the window. Beside it, the spans read. The events' interval
also holds any time the card sits idle inside the span, waiting on the
host's dispatch, so on a busy host it reads above the kernels launched
under the span (0.2-6.2 % above them on an H100). Moves
train_examples_per_s where the device paces the steps."""

from port_bench import program

SPAN = "DLRM table grads"


def read(s):
    spans = getattr(program.profiling, "spans", None)
    if s.kind != "train" or s.steps == 0 or spans is None:
        return None
    ms = [x.device_ms for x in spans() if x.name == SPAN]
    ms = [m for m in ms if m is not None]
    if not ms:
        return None
    return {"value": sum(ms) / s.steps, "spans": len(ms)}
