"""The port's overlapped pipeline (dlrm_tpu_torch/train/pipeline.py) on the
CPU: the four prefetcher and trainer tests of tests/test_data_pipeline.py
(early exit without deadlock, the resume skip reaching the wrapped loader,
producer errors surfaced, the LR policy stepped), and the CPU prefetcher's
batches equal to a plain loop's, bit for bit. The CUDA side stream is
tested on the card (tests/test_torch_cuda_pipeline.py)."""

import threading
import time

import numpy as np
import pytest
import torch

from dlrm_tpu.train.pipeline import DevicePrefetcher as JaxDevicePrefetcher
from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.ops.stream_plan import make_stream_plan
from dlrm_tpu_torch.optim.lr_policy import LRPolicy
from dlrm_tpu_torch.train.harness import _skip_batches
from dlrm_tpu_torch.train.pipeline import (
    DevicePrefetcher,
    HostPrefetcher,
    PipelinedTrainer,
)


def test_prefetcher_early_exit_no_deadlock():
    """Breaking out of the prefetched iterator must not leave the producer
    blocked on a full queue."""
    produced = []

    def loader():
        for i in range(100):
            produced.append(i)
            yield i

    before = threading.active_count()
    pf = DevicePrefetcher(loader(), to_device=lambda x: x, depth=2,
                          device="cpu")
    for i, item in enumerate(pf):
        if i == 3:
            break  # early exit with the producer still active
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"
    assert len(produced) < 100  # it stopped early instead of draining


def test_prefetcher_resume_skip_reaches_wrapped_loader():
    """set_epoch is forwarded to the wrapped loader, and a resume skip (the
    port's harness._skip_batches) reaches it through the wrapper: the
    skipped batches are never read."""
    class FakeBinLoader:
        def __init__(self):
            self.epoch = None
            self.reads = []

        def set_epoch(self, epoch):
            self.epoch = epoch

        def batch_indices(self):
            return range(10)

        def read_batch(self, i):
            self.reads.append(i)
            return i

        def __iter__(self):
            for i in self.batch_indices():
                yield self.read_batch(i)

        def __len__(self):
            return 10

    src = FakeBinLoader()
    pf = HostPrefetcher(src, depth=2)
    assert len(pf) == 10
    pf.set_epoch(3)
    assert src.epoch == 3  # delegated through the wrapper
    assert list(_skip_batches(pf, 7)) == [7, 8, 9]
    assert src.reads == [7, 8, 9]
    pf.set_epoch(4)  # a loader without the hook: a no-op
    HostPrefetcher([1, 2]).set_epoch(4)
    assert list(HostPrefetcher([1, 2])) == [1, 2]


def test_prefetcher_propagates_producer_error():
    def loader():
        yield 1
        raise RuntimeError("boom")

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for item in DevicePrefetcher(loader(), to_device=lambda x: x,
                                     depth=2, device="cpu"):
            got.append(item)
    assert got == [1]


def test_pipelined_trainer_steps_lr_policy():
    lrs = []

    def step(params, opt_state, batch, lr):
        lrs.append(float(lr))
        return params, opt_state, 0.0, None

    policy = LRPolicy(1.0, num_warmup_steps=4, decay_start_step=4,
                      num_decay_steps=0)
    tr = PipelinedTrainer(step, {}, {}, policy)
    it = iter(range(4))
    for _ in range(4):
        tr.progress(it)
    assert lrs == sorted(lrs) and lrs[0] < lrs[-1], lrs  # warmup advanced
    assert tr.step_count == 4
    with pytest.raises(StopIteration):
        tr.progress(it)
    # a constant and a zero-arg callable serve as lr too
    for lr_fn in (0.25, lambda: 0.25):
        lrs.clear()
        PipelinedTrainer(step, {}, {}, lr_fn).progress(iter([0]))
        assert lrs == [0.25]


def test_cpu_prefetcher_batches_equal_a_plain_loop():
    """Host batches with their U-layout work, through the prefetcher to
    device="cpu" and through a plain loop: every tensor equal, in order,
    and the same order as the JAX package's prefetcher yields them."""
    tables, hots, b = (300, 50, 700), (3, 1, 4), 32
    plan = make_stream_plan(tables, 8, b, hots, block_rows=128)

    def host_batches():
        rng = np.random.default_rng(5)
        for _ in range(5):
            yield ragged_multihot_batch(rng, 13, tables, hots, b)

    def to_device(hb):
        return hb.with_stream_work(plan, update_touched_only=True).to_device(
            "cpu", flat_hots=plan.hot)

    got = list(DevicePrefetcher(list(host_batches()), to_device, depth=2,
                                device="cpu"))
    want = [to_device(hb) for hb in host_batches()]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for name in ("dense", "idx", "labels"):
            assert torch.equal(getattr(g, name), getattr(w, name)), name
        assert g.wt is None or torch.equal(g.wt, w.wt)
        for name, x in g.stream._asdict().items():
            y = getattr(w.stream, name)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), name
    order = list(JaxDevicePrefetcher(range(7), lambda x: x * 2))
    assert list(DevicePrefetcher(range(7), lambda x: x * 2)) == order
