"""Vertex-centric graph analytics (pagerank / BFS / components) over a
2-party partitioned graph, plaintext and secret-shared (port of the repo's
``examples/analytics.py``).

  python -m cognn_tpu_torch.examples.analytics [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.examples.analytics")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (the card by default)")
    args = ap.parse_args(argv)

    from cognn_tpu_torch.engine import (
        AnalyticsEngine,
        bfs_program,
        build_device_plan,
        cc_program,
        pagerank_program,
    )
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid
    from cognn_tpu_torch.mpc.analytics import SSAnalyticsEngine
    from cognn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # no card: raise before any work
    ds = synthetic_planetoid("cora_small")
    n = len(ds.features)
    vids = np.arange(n)
    tid = {v: v % 2 for v in range(n)}
    graphs = [build_party_graph(ds.src, ds.dst, None, tid, p, 2,
                                all_vids=vids) for p in range(2)]
    plan = build_device_plan(graphs)

    def host(x):
        return x.cpu().numpy()

    pr = host(AnalyticsEngine(plan, pagerank_program(num_vertices=n),
                              device=device).run(30))
    top = np.argsort(-pr.ravel())[:5]
    print("pagerank top-5 (party*V + idx):", top.tolist())

    d = host(AnalyticsEngine(plan, bfs_program((0, 0)),
                             device=device).run(n))
    reach = d[d < 1e9]
    print(f"BFS from vid {graphs[0].local_vids[0]}: reached "
          f"{(d < 1e9).sum()} vertices, max hop {reach.max():.0f}")

    cc = host(AnalyticsEngine(plan, cc_program(), device=device).run(n))
    labels = cc[np.asarray(plan.vertex_mask)]
    print(f"connected components: {len(np.unique(labels))}")

    # secret-shared execution of the same programs (the reference's
    # ss-pagerank/ss-bfs HE path, rebuilt on additive shares)
    ss_bfs = host(SSAnalyticsEngine(plan, "bfs", source=(0, 0),
                                    device=device).run(n))
    match = np.allclose(np.minimum(d, 2.0**20), np.minimum(ss_bfs, 2.0**20),
                        atol=1e-3)
    print(f"secret-shared BFS == plaintext BFS: {match}")

    ss_pr = host(SSAnalyticsEngine(plan, "pagerank", num_vertices=n,
                                   device=device).run(30))
    err = np.abs(ss_pr - pr).max()
    print(f"secret-shared pagerank max |err| vs plaintext: {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
