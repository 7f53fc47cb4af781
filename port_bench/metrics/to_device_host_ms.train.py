"""Host milliseconds a call of the program's HostBatch.to_device takes (the
flat layout, a pinned copy of every array, the non-blocking H2D enqueue),
by the benchmark's host clock around each call that the DevicePrefetcher's
producer thread makes in the traced window; the mean over those calls.
Moves train_examples_per_s where the producer paces the steps."""

import statistics


def read(s):
    ms = s.host_ms.get("to_device") if s.kind == "train" else None
    if not ms:
        return None
    return {"value": statistics.fmean(ms), "calls": len(ms)}
