"""mfu.serve: % of the card's float32 peak that the GCN's own operations reach in requests (moves request_p50_ms)."""

from benchmark.harness import readers, work


def read(r):
    return readers.mfu(r, "serve", work.model_flops(r.cfg, r.unit),
                       work.F32_FLOPS_PER_S)
