"""k3_roofline.train: K3's least time from the shapes of its epochs over its launches' device time, % (moves epoch_ms)."""

from benchmark.harness import readers, work


def read(r):
    return readers.roofline(r, "train", readers.K3,
                            work.k3_bound_per_unit(r.cfg, r.unit))
