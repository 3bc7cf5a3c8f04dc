"""Golden accuracy runs on the port (port of the repo's
``tools/golden_runs.py``).

90-epoch CoGNN-Opt training across party counts, plaintext and
secret-shared, on the port's engines (``aggregation="auto"``). Defaults to
the synthetic statistics-matched Planetoid datasets (deterministic, no
download); pass ``--planetoid-root DIR`` holding real ``ind.<name>.*`` raw
files to run the same runs on real Cora/CiteSeer/PubMed (reference accuracy
claim: `README.md:226-235`). One JSON line a run, and all of them in
``--out``.

  python -m cognn_tpu_torch.tools.golden_runs [--planetoid-root DIR]
      [--epochs 90] [--scan] [--device cpu] [--out golden.json]
      [--runs plaintext-1p:cora mpc-2p:cora:mpc ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.harness.datasets import (load_planetoid_raw,
                                              synthetic_planetoid)
from cognn_tpu_torch.mpc import MpcGasEngine
from cognn_tpu_torch.tools.run_cluster import build_graphs
from cognn_tpu_torch.utils.device import resolve_device

# (name, dataset, parties, secret-shared)
DEFAULT_RUNS = [
    ("plaintext-1p", "cora", 1, False),
    ("plaintext-2p", "cora", 2, False),
    ("plaintext-4p", "cora", 4, False),
    ("mpc-2p", "cora", 2, True),
    ("plaintext-2p", "citeseer", 2, False),
    ("plaintext-4p", "pubmed", 4, False),
]


def parse_runs(specs):
    """``name:dataset[:mpc]`` specs (e.g. ``mpc-2p:cora:mpc``) as runs; the
    party count is the name's ``-<P>p`` suffix."""
    runs = []
    for spec in specs:
        parts = spec.split(":")
        name, dataset = parts[0], parts[1]
        P = int(name.split("-")[-1].rstrip("p"))
        runs.append((name, dataset, P, "mpc" in parts[2:]))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.golden_runs")
    ap.add_argument("--planetoid-root", default=None, metavar="DIR")
    ap.add_argument("--epochs", type=int, default=90)
    ap.add_argument("--scan", action="store_true",
                    help="train through run_epochs_scan (every epoch's "
                         "metrics) rather than run_epochs")
    ap.add_argument("--out", default="golden.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--runs", nargs="+", default=None,
                    help="subset as name:dataset[:mpc], e.g. mpc-2p:cora:mpc")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    runs = parse_runs(args.runs) if args.runs else DEFAULT_RUNS

    cache = {}

    def get_ds(dataset):
        if dataset not in cache:
            if args.planetoid_root:
                cache[dataset] = load_planetoid_raw(args.planetoid_root,
                                                    dataset)
                print(f"# real {dataset}: n={len(cache[dataset].features)} "
                      f"m={len(cache[dataset].src)}", flush=True)
            else:
                cache[dataset] = synthetic_planetoid(dataset)
        return cache[dataset]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = []
    for name, dataset, P, mpc in runs:
        t0 = time.time()
        ds = get_ds(dataset)
        plan = build_device_plan(build_graphs(ds, P))
        eng = (MpcGasEngine if mpc else GasEngine)(plan, ds.param, "opt",
                                                   device=device)
        eng.metrics_host(eng.run_epoch())
        first_s = time.time() - t0
        t0 = time.time()
        if args.scan:
            m = eng.metrics_host(eng.run_epochs_scan(args.epochs - 1))
            m = {k: np.asarray(v)[:, -1] for k, v in m.items()}
        else:
            m = eng.metrics_host(eng.run_epochs(args.epochs - 1))
        sync()
        train_s = time.time() - t0
        row = dict(name=name, dataset=dataset, parties=P,
                   epochs=args.epochs, mpc=mpc,
                   real_data=bool(args.planetoid_root),
                   backend=eng.aggregation,
                   loss=float(m["loss"].mean()),
                   full=float(m["full_acc"].mean()),
                   train=float(m["train_acc"].mean()),
                   test=float(m["test_acc"].mean()),
                   border_test=float(m["border_test_acc"].mean()),
                   first_epoch_s=round(first_s, 2),
                   train_s=round(train_s, 2))
        print(json.dumps(row), flush=True)
        results.append(row)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
