"""Secret-shared training: every embedding and weight an additive share
pair in Z_2^64 fixed point; compared against plaintext on the same graphs
(port of the repo's ``examples/train_secret_shared.py``).

  python -m cognn_tpu_torch.examples.train_secret_shared [--epochs 20] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.examples.train_secret_shared")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--aggregation", default="auto",
                    choices=["auto", "sparse", "dense", "bcsr"],
                    help="aggregation backend (auto = the engines' rule; "
                         "every backend reveals the same values)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (the card by default)")
    args = ap.parse_args(argv)

    from cognn_tpu_torch.engine import GasEngine, build_device_plan
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid
    from cognn_tpu_torch.mpc import MpcGasEngine
    from cognn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # no card: raise before any work
    ds = synthetic_planetoid("cora_small")
    n = len(ds.features)
    vids = np.arange(n)
    tid = {v: v % 2 for v in range(n)}
    graphs = []
    for p in range(2):
        g = build_party_graph(ds.src, ds.dst, None, tid, p, 2, all_vids=vids)
        g.set_vertex_data(vids, ds.features, ds.labels)
        graphs.append(g)

    plain = GasEngine(build_device_plan(graphs), ds.param, device=device)
    mpc = MpcGasEngine(build_device_plan(graphs), ds.param, "opt",
                       aggregation=args.aggregation, device=device)
    mp = plain.metrics_host(plain.run_epochs(args.epochs))
    mm = mpc.metrics_host(mpc.run_epochs(args.epochs))
    print(f"plaintext:     loss={mp['loss'][0]:.4f} "
          f"test={mp['test_acc'].mean():.3f}")
    print(f"secret-shared: loss={mm['loss'][0]:.4f} "
          f"test={mm['test_acc'].mean():.3f}")
    w_sh = mpc.weights_sh[0].cpu().numpy()
    print(f"one weight SHARE (uniform noise, reveals nothing): "
          f"{w_sh[0, 0, 0, :3]}")
    print(f"reconstructed weight:                              "
          f"{mpc.reveal_weights()[0][0, 0, :3].cpu().numpy()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
