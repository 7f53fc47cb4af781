"""Synchronizing CUDA calls a served batch makes inside the program's
spans: the sync debug mode's reports that utils/profiling.py counts, while
profile() traces, against the innermost span open on the calling thread
(calls outside every span, such as the benchmark's own, are not counted),
summed over the spans kept in the traced stretch, over the batches in the
window. Beside it, the three spans with the most a batch. Moves
serve_examples_per_s: a sync keeps the dispatch from running ahead."""

from port_bench import program

SYNCS = "DLRM syncs"


def read(s):
    spans = getattr(program.profiling, "spans", None)
    if (s.kind != "serve" or s.steps == 0 or spans is None
            or SYNCS not in program.profiling.counters()):
        return None
    by_span = {}
    for x in spans():
        if x.counts.get(SYNCS):
            by_span[x.name] = by_span.get(x.name, 0) + x.counts[SYNCS]
    top = sorted(by_span.items(), key=lambda kv: -kv[1])[:3]
    return {"value": sum(by_span.values()) / s.steps,
            "top_spans": [[n, v / s.steps] for n, v in top]}
