"""Inter-edge (cross-party) ratio per partition count (port of the repo's
``tools/plot/print_inter_edge_ratio.py``; reference
`tools/plot/print_inter_edge_ratio.py`).

With the round-robin partition the reference reports Cora 0.51/0.68/0.76/0.81
at 2/3/4/5 parties (BASELINE.md); the same computation over any edge list +
partition files or the built-in synthetic datasets. Host arithmetic only:
nothing runs on a device.

  python -m cognn_tpu_torch.tools.print_inter_edge_ratio --dataset cora
  python -m cognn_tpu_torch.tools.print_inter_edge_ratio --edge-file E \\
      --part-file P2 P3
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.print_inter_edge_ratio")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--edge-file", default=None)
    ap.add_argument("--part-file", nargs="*", default=[])
    ap.add_argument("--parties", type=int, nargs="+", default=[2, 3, 4, 5])
    args = ap.parse_args(argv)

    if args.edge_file:
        from cognn_tpu_torch.graph import read_edge_list, read_partition_file

        src, dst, _ = read_edge_list(args.edge_file)
        for pf in args.part_file:
            tidmap = read_partition_file(pf, 1 << 30)
            t = np.array([tidmap[int(v)] for v in src])
            u = np.array([tidmap[int(v)] for v in dst])
            ratio = float((t != u).mean())
            print(f"{pf}: inter-edge ratio {ratio:.2f} "
                  f"({(t != u).sum()}/{len(src)})")
    else:
        from cognn_tpu_torch.harness.datasets import synthetic_planetoid

        ds = synthetic_planetoid(args.dataset or "cora")
        for p in args.parties:
            inter = (ds.src % p) != (ds.dst % p)
            print(f"{ds.name} {p} parties: inter-edge ratio "
                  f"{float(inter.mean()):.2f} ({inter.sum()}/{len(ds.src)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
