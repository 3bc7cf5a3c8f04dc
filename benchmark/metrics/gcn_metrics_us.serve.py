"""gcn_metrics_us.serve: device µs a request in the port's metrics phase, gcn_metrics' loss and accuracies (moves request_p50_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.phase_us(r, "serve", "metrics")
