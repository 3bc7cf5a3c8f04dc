"""host_launches.train: the host's graph launches, kernel launches and async copies an epoch (moves epoch_ms)."""

from benchmark.harness import readers


def read(r):
    return readers.host_launches(r, "train")
