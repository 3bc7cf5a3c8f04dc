"""prng_us.train: device µs an epoch in the port's prng phase, the share randomness' torch.randint draws (moves epoch_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.phase_us(r, "train", "prng")
