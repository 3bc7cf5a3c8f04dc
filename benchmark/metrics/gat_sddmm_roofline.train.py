"""gat_sddmm_roofline.train: the ring SDDMM's least time from the shapes of an epoch over the device µs of its phase (sddmm: its launches alone), % (moves epoch_ms)."""

from benchmark.harness import phases, work_gat


def read(r):
    return work_gat.share(work_gat.sddmm_bound_per_unit(r.cfg, r.unit),
                          phases.phase_us(r, "train", "sddmm"))
