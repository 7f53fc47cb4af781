"""The prefetcher's CUDA side stream on the card: each prefetched batch
equals the same batch copied synchronously on the current stream, while a
busy current stream and a slow consumer give a missing wait or an early
memory reuse every chance to show. Needs a CUDA card (marked `cuda`,
skipped with a reason elsewhere) and imports nothing of JAX:
`python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_pipeline.py`."""

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.ops.stream_plan import make_stream_plan
from dlrm_tpu_torch.train.pipeline import DevicePrefetcher

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card (the side stream, events "
                       "and pinned copies exist only there)"),
]

TABLES = (30_000, 5_000, 70_000)
HOTS = (3, 1, 20)
B = 4096


def _host_batches(n):
    rng = np.random.default_rng(9)
    return [ragged_multihot_batch(rng, 13, TABLES, HOTS, B) for _ in range(n)]


def _equal(a, b):
    for name in ("dense", "idx", "wt", "labels"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name, x in a.stream._asdict().items():
        y = getattr(b.stream, name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), name


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetched_batches_equal_synchronous_copies(depth):
    plan = make_stream_plan(TABLES, 128, B, HOTS, block_rows=2048)

    def to_device(hb):
        return hb.with_stream_work(plan, update_touched_only=True).to_device(
            "cuda", flat_hots=plan.hot)

    hosts = _host_batches(6)
    busy = torch.randn((4096, 4096), device="cuda")
    got = []
    for batch in DevicePrefetcher(hosts, to_device, depth=depth,
                                  device="cuda"):
        # keep the current stream busy before reading the batch, and keep a
        # copy (made on the current stream) of what it read
        for _ in range(4):
            busy = busy @ busy * 1e-4
        got.append([t.clone() if isinstance(t, torch.Tensor) else t
                    for t in (batch.dense, batch.idx, batch.wt, batch.labels)]
                   + [batch.stream._replace(**{
                       k: v.clone() for k, v in batch.stream._asdict().items()
                       if isinstance(v, torch.Tensor)})])
        del batch
        torch.cuda.empty_cache()  # memory freed early would be reused here
    torch.cuda.synchronize()
    assert len(got) == len(hosts)
    for g, hb in zip(got, hosts):
        want = to_device(hb)
        torch.cuda.synchronize()
        dense, idx, wt, labels, stream = g
        _equal(want._replace(dense=dense, idx=idx, wt=wt, labels=labels,
                             stream=stream), want)
