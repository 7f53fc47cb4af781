"""Host milliseconds a call of the program's HostBatch.to_device spends
pinning its arrays: the "DLRM to_device pin" spans (around each
pin_memory(), data/random_data.py) under the "DLRM to_device" calls that
the DevicePrefetcher's producer thread made in the traced stretch, mean
over those calls. Beside it: the calls; the pinned copy's GB/s (the bytes
counted inside the pin spans over their time); the fresh page-locked
allocations a call and their ms (the host allocator's own counters over
the stretch). Moves train_examples_per_s where the producer paces the
steps."""

from port_bench import program

CALL, PIN = "DLRM to_device", "DLRM to_device pin"
BYTES = "DLRM to_device bytes"
ALLOCS = "host_memory_stats.num_host_alloc"
ALLOC_US = "host_memory_stats.host_alloc_time.total"


def read(s, kind="train"):
    """kind: the cell's, "train" here; "serve" for to_device_pin_ms.serve,
    which reads the same spans."""
    spans = getattr(program.profiling, "spans", None)
    if s.kind != kind or spans is None:
        return None
    got = spans()
    calls = {x for x in got if x.name == CALL}
    pins = [x for x in got if x.name == PIN and x.parent in calls]
    if not pins:
        return None
    ms = sum(x.host_ms for x in pins)
    out = {"value": ms / len(calls), "calls": len(calls),
           "pinned_GB_per_s": sum(x.counts.get(BYTES, 0) for x in pins)
           / ms * 1e-6}
    c = program.profiling.counters()
    if ALLOCS in c:
        out["fresh_pinned_allocs_per_call"] = c[ALLOCS] / len(calls)
    if ALLOC_US in c:
        out["fresh_pinned_alloc_ms_per_call"] = c[ALLOC_US] * 1e-3 / len(
            calls)
    return out
