"""Overlapped train pipeline: host batch prep / H2D transfer / device step
(the port of dlrm_tpu/train/pipeline.py).

Capability parity with torchrec's TrainPipelineSparseDist 3-stage overlap
(torchrec_dlrm/dlrm_main.py:63, 478-480: copy / input-dist / fwd-bwd). On
the card the stages map to:

  stage 1  host-side batch materialization (the read, the U-layout build,
           the flat per-hit layout) in a background thread; numpy, the
           native builder and the pinned copies release the GIL;
  stage 2  host->device copies, enqueued by that thread on a CUDA side
           stream, `depth` batches ahead, each batch closed by an event;
  stage 3  the train step on the consumer's current stream, which waits on
           the batch's event and nothing else.

On the CPU the producer is the same thread without streams or events.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import torch

from dlrm_tpu_torch.device import resolve_device


def _tensors(x):
    """Every tensor of a batch: Batch, StreamArrays and other tuples,
    lists and dicts are walked."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class DevicePrefetcher:
    """Wraps a host-batch iterable; yields device batches `depth` ahead.

    device: None or a CPU device runs to_device in a plain thread. A CUDA
    device runs it on a side stream of that card; the consumer's current
    stream waits on each batch's event, and every tensor of the batch is
    marked as used on that stream (record_stream), so the caching
    allocator cannot hand its memory out again while the step still reads
    it."""

    _DONE = object()

    def __init__(
        self,
        loader: Iterable,
        to_device: Callable,
        depth: int = 2,
        device=None,
    ):
        self.loader = loader
        self.to_device = to_device
        self.depth = max(1, depth)
        self.device = None if device is None else resolve_device(device)

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        """Delegate the trainer-epoch shuffle hook to the wrapped loader, so
        a resume fast-forward stays correct when the loader is
        prefetcher-wrapped; no-op when the wrapped loader has no
        epoch-dependent state."""
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator:
        cuda = self.device is not None and self.device.type == "cuda"
        side = torch.cuda.Stream(device=self.device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err = []

        def put(item) -> bool:
            """Bounded put that aborts when the consumer has gone away
            (early break / exception) instead of blocking forever with
            device batches pinned in the queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(hb):
            if not cuda:
                return self.to_device(hb), None
            with torch.cuda.stream(side):
                batch = self.to_device(hb)
                ready = torch.cuda.Event()
                ready.record(side)
            return batch, ready

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for hb in self.loader:
                    if not put(produce(hb)):
                        return
            except BaseException as e:  # surface worker errors
                err.append(e)
            finally:
                put(self._DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        done = False
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    done = True
                    break
                batch, ready = item
                if ready is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ready)
                    for x in _tensors(batch):
                        x.record_stream(cur)
                yield batch
        finally:
            stop.set()
            try:  # unblock the producer and release queued device batches
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
        if done and err:
            raise err[0]


class PipelinedTrainer:
    """progress()-style stepping (TrainPipelineSparseDist.progress analog):
    construct with the step fn and state, call progress(iterator) per step.

    lr may be a constant, a zero-arg callable, or an LRPolicy-like object
    with .lr/.step() — the policy is STEPPED here so schedules advance."""

    def __init__(self, train_step, params, opt_state, lr_fn):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.lr_fn = lr_fn
        self.step_count = 0

    def _next_lr(self):
        if hasattr(self.lr_fn, "lr") and hasattr(self.lr_fn, "step"):
            lr = self.lr_fn.lr
            self.lr_fn.step()
            return lr
        return self.lr_fn() if callable(self.lr_fn) else self.lr_fn

    def progress(self, it: Iterator):
        batch = next(it)  # raises StopIteration at epoch end, like torchrec
        lr = self._next_lr()
        self.params, self.opt_state, loss, probs = self.train_step(
            self.params, self.opt_state, batch, lr
        )
        self.step_count += 1
        return loss, probs


class HostPrefetcher(DevicePrefetcher):
    """Host-side analog of torch DataLoader(num_workers>0): a background
    thread materializes host batches `depth` ahead (one thread suffices
    because batch prep releases the GIL in numpy and the native builder).
    Re-iterable: each __iter__ spawns a fresh producer. Exactly
    DevicePrefetcher with an identity transform on the CPU path — the
    queue/drain/error machinery is shared."""

    def __init__(self, loader: Iterable, depth: int = 2):
        super().__init__(loader, lambda hb: hb, depth)
