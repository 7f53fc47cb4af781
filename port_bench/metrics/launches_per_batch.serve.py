"""Kernels the device ran a batch in a serving cell: the kernel launches in
the traced window over its batches (a count from the trace). The host pays
for each launch, so it moves serve_examples_per_s where the dispatch paces
the card."""


def read(s):
    if s.kind != "serve" or s.steps == 0 or s.kernels == 0:
        return None
    return {"value": s.kernels / s.steps}
