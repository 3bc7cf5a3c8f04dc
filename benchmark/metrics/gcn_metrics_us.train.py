"""gcn_metrics_us.train: device µs an epoch in the port's metrics phase, gcn_metrics' loss and accuracies (moves epoch_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.phase_us(r, "train", "metrics")
