"""protocol_us.serve: device µs a request of the share arithmetic: every operation but K3 and the SpMM (moves request_p50_ms)."""

from benchmark.harness import readers


def read(r):
    return readers.others_us(r, "serve")
