"""idle_share.train: % of a traced train stretch with no operation on the card (moves epoch_ms)."""

from benchmark.harness import readers


def read(r):
    return readers.idle_share(r, "train")
