"""idle_share.serve: % of a traced serve stretch with no operation on the card (moves request_p50_ms)."""

from benchmark.harness import readers


def read(r):
    return readers.idle_share(r, "serve")
