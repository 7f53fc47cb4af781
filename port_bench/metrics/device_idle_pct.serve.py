"""The share of the traced window of a serving cell in which no operation
ran on the device. Moves serve_examples_per_s: the host's dispatch (the
H2D, some 1,300 launches a batch) holds the card back by this much."""


def read(s):
    if s.kind != "serve" or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return {"value": 100.0 * (1.0 - s.busy_s / s.window_s)}
