"""trunc_us.train: device µs an epoch in the port's trunc-reshare phase, its nested draws excluded (moves epoch_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.phase_us(r, "train", "trunc-reshare")
