"""Host milliseconds a call of the program's HostBatch.to_device spends
enqueueing its non-blocking host-to-device copies: the "DLRM to_device
h2d" spans (around each .to(), data/random_data.py; a copy that waits,
as on a caching-allocator retry, waits here) under the "DLRM to_device"
calls that the DevicePrefetcher's producer thread made in the traced
stretch, mean over those calls. Beside it: the calls, and over the
stretch the device allocator's own counters: its retries, its
synchronizations of all streams, and its fresh device allocations and
frees (cudaMalloc and cudaFree, which a copy into a new block would make).
Moves train_examples_per_s where the producer paces the steps."""

from port_bench import program

CALL, H2D = "DLRM to_device", "DLRM to_device h2d"
STATS = {"alloc_retries": "memory_stats.num_alloc_retries",
         "sync_all_streams": "memory_stats.num_sync_all_streams",
         "device_allocs": "memory_stats.num_device_alloc",
         "device_frees": "memory_stats.num_device_free"}


def read(s):
    spans = getattr(program.profiling, "spans", None)
    if s.kind != "train" or spans is None:
        return None
    got = spans()
    calls = {x for x in got if x.name == CALL}
    copies = [x for x in got if x.name == H2D and x.parent in calls]
    if not copies:
        return None
    out = {"value": sum(x.host_ms for x in copies) / len(calls),
           "calls": len(calls)}
    c = program.profiling.counters()
    out.update({k: c[v] for k, v in STATS.items() if v in c})
    return out
