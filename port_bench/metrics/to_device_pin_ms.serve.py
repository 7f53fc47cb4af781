"""Host milliseconds a call of the program's HostBatch.to_device spends
pinning its arrays, as to_device_pin_ms.train reads them (the same spans,
counters and companions), for the calls the serve loop's dispatch made in
the traced stretch. Moves serve_examples_per_s: the dispatch pins each
batch before its forward is enqueued."""

import os

from port_bench import core

_TRAIN = core.load_module(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "metrics", "to_device_pin_ms.train")


def read(s):
    return _TRAIN.read(s, kind="serve")
