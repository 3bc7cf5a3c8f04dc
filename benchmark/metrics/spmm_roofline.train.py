"""spmm_roofline.train: the ring CSR SpMM's least time from the shapes of its epochs over its launches' device time, % (moves epoch_ms)."""

from benchmark.harness import readers, work


def read(r):
    return readers.roofline(r, "train", readers.SPMM,
                            work.spmm_bound_per_unit(r.cfg, r.unit))
