"""apply_us.train: device µs an epoch in the port's apply phase (reveal, softmax, SGD's constant scales, the weight mean and write-back), the metrics excluded (moves epoch_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.phase_us(r, "train", "apply")
