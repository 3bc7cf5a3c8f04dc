"""Analytic per-epoch message-passing communication model (port of the
repo's ``tools/plot/plot_message_passing_comm.py``; reference
`tools/plot/plot_message_passing_comm.py:23-41`, the paper's Table 6).

Per-epoch bytes for n vertices, m directed edges, dimension sums Σd:
  adjacency-matrix baseline: 2 * 8 * Σd * (n^2 + n) / 2
  GraphSC:                   8 * Σd * 10 * (n + m)
  CoGNN:                     8 * Σd * (n + 5 m)
  CoGNN-Opt:                 same formula with hidden-space dims
Plus the port's measured-shape model: halo mirror rows per epoch (from the
device plan), what the sharded engines' halo ships. Host arithmetic only:
nothing runs on a device.

  python -m cognn_tpu_torch.tools.plot_message_passing_comm --dataset cora \\
      [--parties 2]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cognn_tpu_torch.engine import build_device_plan
from cognn_tpu_torch.graph import build_party_graph
from cognn_tpu_torch.harness.datasets import synthetic_planetoid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.plot_message_passing_comm")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--parties", type=int, default=2)
    args = ap.parse_args(argv)

    ds = synthetic_planetoid(args.dataset)
    p = ds.param
    n, m = p.num_samples, len(ds.src)
    # dims per GAS round: unopt {input,hidden,hidden}; opt hidden-space
    d_unopt = p.input_dim + 2 * p.hidden_dim
    d_opt = (2 * p.hidden_dim + 2 * p.num_labels + p.hidden_dim
             + p.hidden_dim)  # {h,l,0,l,h,h} (gcn.h:944-948)

    rows = [
        ("adjacency-matrix", 2 * 8 * d_unopt * (n * n + n) / 2),
        ("GraphSC", 8 * d_unopt * 10 * (n + m)),
        ("CoGNN", 8 * d_unopt * (n + 5 * m)),
        ("CoGNN-Opt", 8 * d_opt * (n + 5 * m)),
    ]
    print(f"{ds.name}: n={n} m={m} sum_dims unopt={d_unopt} opt={d_opt}")
    for name, b in rows:
        print(f"  {name:18s} {b/1e9:10.3f} GB/epoch (analytic, reference "
              f"model)")

    # the port: halo mirror rows per aggregation phase
    vids = np.arange(len(ds.features))
    tid = {v: v % args.parties for v in range(len(vids))}
    graphs = [build_party_graph(ds.src, ds.dst, None, tid, q, args.parties,
                                all_vids=vids)
              for q in range(args.parties)]
    plan = build_device_plan(graphs)
    mirrors = int(plan.recv_mask.sum())
    per_epoch = mirrors * 4 * (2 * p.hidden_dim + 2 * p.num_labels)
    print(f"  {'cognn_tpu (halo)':18s} {per_epoch/1e9:10.3f} GB/epoch "
          f"({mirrors} mirror rows x 4 GAS phases, f32 hidden dims)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
