"""forward_host_us.serve: median host µs of the port's engine.forward span a request: the graph launch and the copies of its outputs (moves request_p50_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.forward_host_us(r, "serve")
