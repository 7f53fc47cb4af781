"""Device milliseconds a train step keeps the card busy: the union of the
device's operations in the traced window (kernels, copies and sets, the
prefetcher's H2D included) over the steps in it. Moves
train_examples_per_s where the device paces the steps."""


def read(s):
    if s.kind != "train" or s.steps == 0 or s.busy_s <= 0:
        return None
    return {"value": s.busy_s / s.steps * 1e3}
