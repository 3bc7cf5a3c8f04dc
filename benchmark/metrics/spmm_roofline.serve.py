"""spmm_roofline.serve: the ring CSR SpMM's least time from the shapes of its requests over its launches' device time, % (moves request_p50_ms)."""

from benchmark.harness import readers, work


def read(r):
    return readers.roofline(r, "serve", readers.SPMM,
                            work.spmm_bound_per_unit(r.cfg, r.unit))
