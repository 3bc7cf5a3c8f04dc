"""mfu.train: % of the card's float32 peak that the GCN's own operations reach in epochs (moves epoch_ms)."""

from benchmark.harness import readers, work


def read(r):
    return readers.mfu(r, "train", work.model_flops(r.cfg, r.unit),
                       work.F32_FLOPS_PER_S)
