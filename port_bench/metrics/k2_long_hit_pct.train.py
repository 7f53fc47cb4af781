"""The share of a train step's hits that K2 (csrc/stream_update.cu) sums
in chunks: the hits of rows with more than C = 512 hits in the batch, over
all the batch's hits, in %, from the program's counters in the "DLRM table
update" span (train/stream_step.py; build_stream_work's counts, carried with
the batch), summed over the traced steps. Beside it, such rows a step.
Nothing where the program keeps no such counter. Moves train_examples_per_s:
a hot row's hits no longer wait on one warp."""

from port_bench import program

HITS = "DLRM K2 hits"
LONG_RUNS = "DLRM K2 long runs"
LONG_HITS = "DLRM K2 long-run hits"


def read(s):
    counters = getattr(program.profiling, "counters", None)
    if s.kind != "train" or s.steps == 0 or counters is None:
        return None
    c = counters()
    if not c.get(HITS):
        return None
    return {"value": 100.0 * c.get(LONG_HITS, 0) / c[HITS],
            "long_runs": c.get(LONG_RUNS, 0) / s.steps}
