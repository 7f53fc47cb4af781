"""The share of the traced window of a train cell in which no operation
ran on the device (the trace's window span less the union of its device
operations). Moves train_examples_per_s: the host holds the card back by
this much."""


def read(s):
    if s.kind != "train" or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return {"value": 100.0 * (1.0 - s.busy_s / s.window_s)}
