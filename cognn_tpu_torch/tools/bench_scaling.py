"""Party-scaling benchmark: edge-iterations/s at 1..N parties (port of the
repo's ``tools/bench_scaling.py``).

The BASELINE north star: ">=80% edges/s scaling efficiency from 1 to 4 hosts
on 4-way-partitioned PubMed". P = 1 runs the stacked plaintext
``GasEngine(plan, param, "opt")``; P > 1 runs ``mode="sharded"`` with one
process a party (:func:`cognn_tpu_torch.utils.distributed.run_parties`),
over NCCL where there is a card for each party and otherwise over gloo
through host copies. Each party runs one warm epoch, then ``--epochs``
timed ones between a barrier and ``torch.cuda.synchronize()``; the epoch
time is the slowest party's. On the card every engine takes its default and
replays CUDA graphs (sharded: split at the collectives, which run between
the graphs), the warm epoch being the capture. The single-party run is the
baseline: speed-up = throughput(P) / throughput(1) on the PARTITIONED graph
(fixed total work, more parties), ``edge_iters_per_s = epoch_layers * E /
epoch_s``.

Where the parties share one card they are time-sliced on it, and the
efficiency says nothing about scaling: the tool prints a NOTE. It does
the same for parties on the CPU, which share the host's cores.

  python -m cognn_tpu_torch.tools.bench_scaling --dataset pubmed \\
      --parties 1 2 4 --epochs 5
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.graph import build_party_graph
from cognn_tpu_torch.harness.datasets import synthetic_planetoid
from cognn_tpu_torch.utils import distributed
from cognn_tpu_torch.utils.device import resolve_device

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
PARTY_TIMEOUT_S = 900  # a sweep point's party processes, start to end


def build_plan(ds, P: int):
    """The JAX tool's plan: vertex v to party v mod P, lane 128."""
    n = len(ds.features)
    vids = np.arange(n)
    tid = {v: v % P for v in range(n)} if P > 1 else None
    graphs = []
    for p in range(P):
        g = build_party_graph(ds.src, ds.dst, None, tid, p, P,
                              all_vids=vids)
        g.set_vertex_data(vids, ds.features, ds.labels)
        graphs.append(g)
    return build_device_plan(graphs, lane=128)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_epochs(eng, device, epochs: int, barrier=None) -> float:
    """One warm epoch, then seconds an epoch over ``epochs`` epochs from a
    barrier (sharded) to a device synchronization."""
    eng.run_epoch()
    _sync(device)
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    for _ in range(epochs):
        eng.run_epoch()
    _sync(device)
    return (time.perf_counter() - t0) / epochs


def _party(dataset: str, P: int, rank: int, port: int, epochs: int,
           device: str, backend: str, out_file: str) -> None:
    """``--_party`` entry: one party process of a sharded sweep point;
    writes its seconds an epoch and epoch_layers as JSON."""
    ds = synthetic_planetoid(dataset)
    plan = build_plan(ds, P)
    group = distributed.init_party_group(rank, P, f"127.0.0.1:{port}",
                                         backend=backend, device=device)
    try:
        eng = GasEngine(plan, ds.param, "opt", mode="sharded", group=group,
                        device=device)
        dt = time_epochs(eng, group.device, epochs, group.barrier)
        Path(out_file).write_text(json.dumps(
            {"epoch_s": dt, "epoch_layers": eng.epoch_layers,
             "device": str(group.device), "backend": backend}))
    finally:
        distributed.destroy_party_group()


def sharded_epoch(dataset: str, P: int, epochs: int, device, backend: str):
    """(slowest party's seconds an epoch, epoch_layers) of P party
    processes."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        port = distributed.free_port()
        outs = [tmp / f"party{r}.json" for r in range(P)]
        logs = [open(tmp / f"party{r}.log", "w") for r in range(P)]
        path = (str(PACKAGE_ROOT), os.environ.get("PYTHONPATH", ""))
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(p for p in path if p)}
        try:
            distributed.run_parties(
                [[sys.executable, "-m", "cognn_tpu_torch.tools.bench_scaling",
                  "--_party", dataset, str(P), str(r), str(port),
                  str(epochs), device.type, backend, str(outs[r])]
                 for r in range(P)],
                timeout=PARTY_TIMEOUT_S, stdouts=logs, stderrs=logs, env=env)
        except (RuntimeError, TimeoutError) as e:
            tail = "\n".join((tmp / f"party{r}.log").read_text()[-1500:]
                             for r in range(P))
            raise RuntimeError(f"{e}\n{tail}") from e
        finally:
            for f in logs:
                f.close()
        res = [json.loads(o.read_text()) for o in outs]
    return max(r["epoch_s"] for r in res), res[0]["epoch_layers"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.bench_scaling",
        description="edge-iterations/s at 1..N parties")
    ap.add_argument("--_party", dest="party", nargs=8, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dataset", default="pubmed")
    ap.add_argument("--parties", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the parties run (the card by default)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.party:
        dataset, P, rank, port, epochs, device, backend, out = args.party
        _party(dataset, int(P), int(rank), int(port), int(epochs), device,
               backend, out)
        return 0
    device = resolve_device(args.device)  # no card: raise before any work
    ds = synthetic_planetoid(args.dataset)
    n, E = len(ds.features), len(ds.src)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    where = (f"{torch.cuda.get_device_name(device)} x{cards}"
             if cards else f"cpu ({os.cpu_count()} cores)")
    print(f"device={where} dataset={args.dataset} V={n} E={E}", flush=True)

    base = None
    results = []
    for P in args.parties:
        if P == 1:
            plan = build_plan(ds, 1)
            eng = GasEngine(plan, ds.param, "opt", device=device)
            dt = time_epochs(eng, device, args.epochs)
            layers = eng.epoch_layers
            how = "stacked"
        else:
            backend = distributed.choose_backend(P, device)
            how = f"sharded, {P} processes over {backend}"
            if device.type == "cuda" and cards < P:
                how += " through host copies"
                print(f"NOTE: {P} parties share {cards} card(s), "
                      "time-sliced — efficiency numbers are NOT meaningful;"
                      " this validates the sharded code path only.",
                      flush=True)
            elif device.type == "cpu":
                print(f"NOTE: {P} party processes on the CPU's "
                      f"{os.cpu_count()} cores — efficiency numbers are NOT"
                      " meaningful; this validates the sharded code path "
                      "only.", flush=True)
            dt, layers = sharded_epoch(args.dataset, P, args.epochs, device,
                                       backend)
        print(f"[P={P}: {how}]", flush=True)
        thr = layers * E / dt
        if base is None:
            base = thr
        eff = thr / base
        results.append({"parties": P, "epoch_s": dt,
                        "edge_iters_per_s": thr, "speedup_vs_1": eff})
        print(f"P={P}: epoch={dt*1e3:.2f} ms  {thr/1e6:.2f}M edge-iters/s  "
              f"speedup vs 1-party: {eff:.2f}x "
              f"(efficiency {eff/P*100:.0f}%)", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
