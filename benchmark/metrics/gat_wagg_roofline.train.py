"""gat_wagg_roofline.train: the weighted ring SpMM's least time from the shapes of an epoch over the device µs of its phase (wagg: its launches alone), % (moves epoch_ms)."""

from benchmark.harness import phases, work_gat


def read(r):
    return work_gat.share(work_gat.wagg_bound_per_unit(r.cfg, r.unit),
                          phases.phase_us(r, "train", "wagg"))
