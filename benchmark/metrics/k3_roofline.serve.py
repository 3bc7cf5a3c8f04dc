"""k3_roofline.serve: K3's least time from the shapes of its requests over its launches' device time, % (moves request_p50_ms)."""

from benchmark.harness import readers, work


def read(r):
    return readers.roofline(r, "serve", readers.K3,
                            work.k3_bound_per_unit(r.cfg, r.unit))
