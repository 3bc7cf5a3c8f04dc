"""Minimal end-to-end: 2-party plaintext CoGNN-Opt training on synthetic
Cora (port of the repo's ``examples/train_plaintext.py``).

  python -m cognn_tpu_torch.examples.train_plaintext [--parties 2] \\
      [--epochs 30] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.examples.train_plaintext")
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (the card by default)")
    args = ap.parse_args(argv)

    from cognn_tpu_torch.engine import GasEngine, build_device_plan
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid
    from cognn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # no card: raise before any work
    ds = synthetic_planetoid(args.dataset)
    n = len(ds.features)
    vids = np.arange(n)
    tid = ({v: v % args.parties for v in range(n)}
           if args.parties > 1 else None)
    graphs = []
    for p in range(args.parties):
        g = build_party_graph(ds.src, ds.dst, None, tid, p, args.parties,
                              all_vids=vids)
        g.set_vertex_data(vids, ds.features, ds.labels)
        graphs.append(g)

    engine = GasEngine(build_device_plan(graphs), ds.param, "opt",
                       device=device)
    for e in range(args.epochs):
        m = engine.metrics_host(engine.run_epoch())
        if (e + 1) % 10 == 0 or e == 0:
            print(f"epoch {e+1:3d}: loss={m['loss'].mean():.4f} "
                  f"train={m['train_acc'].mean():.3f} "
                  f"test={m['test_acc'].mean():.3f} "
                  f"border_test={m['border_test_acc'].mean():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
