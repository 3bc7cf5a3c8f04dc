"""protocol_us.train: device µs an epoch of the share arithmetic: every operation but K3 and the SpMM (moves epoch_ms)."""

from benchmark.harness import readers


def read(r):
    return readers.others_us(r, "train")
