"""prng_us.serve: device µs a request in the port's prng phase, the share randomness' torch.randint draws (moves request_p50_ms)."""

from benchmark.harness import phases


def read(r):
    return phases.phase_us(r, "serve", "prng")
