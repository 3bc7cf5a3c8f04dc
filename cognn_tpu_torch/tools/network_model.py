"""Duration-vs-network model (port of the repo's ``tools/network_model.py``),
the reference's Tables 1/2 counterpart.

The reference evaluates epoch duration under a simulated WAN grid
({200,400,1000,4000} Mbit x {0.15,1,10,20} ms via netns/tc,
`tools/tmp_run_cluster.py:23-29`, `tools/scripts/setup_network.sh:32-39`).
One card shapes no traffic; instead the tool PREDICTS the epoch duration of
the sharded program on an interconnect with a given bandwidth and latency
from three quantities:

    duration = compute + wire_bytes * 8 / bandwidth + rounds * latency

* compute: the stacked engine's measured epoch time (or forward time for an
  ``*_inference`` variant) on the device, ``run_epochs_scan(16)`` repeated
  until one window ending in ``torch.cuda.synchronize()`` lasts 0.5 s; or
  an explicit ``--compute-ms``.
* wire_bytes and rounds: a party's collective bytes and calls in one epoch
  (or forward) of the sharded engines, COUNTED at the
  :class:`~cognn_tpu_torch.utils.distributed.PartyGroup` collectives in P
  party processes over gloo on the CPU
  (:func:`cognn_tpu_torch.tools.run_cluster.count_comm`); where counting
  cannot run (one party, or the party processes fail), the closed forms of
  :mod:`cognn_tpu_torch.engine.comm_model`. Each grid's title says which.
  Every collective call is a latency-bound synchronization, the
  counterpart of the reference's interactive 2PC rounds.

Prints a markdown grid per variant (opt / unopt / inference, plaintext or
--mpc) plus the GraphSC analytic comm row (bytes only: the paper's Table-6
model gives no round count, so its prediction is a lower bound).

Usage:
  python -m cognn_tpu_torch.tools.network_model --dataset cora --parties 2 \\
      --variants opt,unopt [--mpc] [--compute-ms opt=0.62,unopt=8.81]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.engine.comm_model import (
    REFERENCE_BANDWIDTHS_MBIT,
    REFERENCE_LATENCIES_MS,
    analytic_bytes_per_epoch,
    analytic_rounds_per_epoch,
    duration_grid,
)
from cognn_tpu_torch.harness.datasets import synthetic_planetoid
from cognn_tpu_torch.tools.run_cluster import (
    _timed_window,
    build_graphs,
    count_comm,
    default_partition,
    sharded_backend,
)
from cognn_tpu_torch.utils.device import resolve_device


def measure_compute(ds, plan, variant, mpc, budget=0.5, hoist_agg=True,
                    device="cuda"):
    """Stacked per-epoch (or per-forward) seconds on ``device``."""
    device = resolve_device(device)
    if mpc:
        from cognn_tpu_torch.mpc import MpcGasEngine

        eng = MpcGasEngine(plan, ds.param, variant, hoist_agg=hoist_agg,
                           device=device)
    else:
        eng = GasEngine(plan, ds.param, variant, device=device)
    fwd = variant.endswith("inference")
    scan_n = 1 if fwd else 16

    def run():
        if fwd:
            eng.forward()
        else:
            eng.run_epochs_scan(scan_n)

    run()  # first call: builds the kernels' libraries on the card
    dt, reps = _timed_window(run, device, budget)
    return dt / (reps * scan_n)


def fmt_s(x):
    return f"{x*1e3:.2f} ms" if x < 1 else f"{x:.3f} s"


def grid_markdown(title, compute_s, bytes_pe, rounds_pe):
    lines = [f"### {title}",
             f"compute {fmt_s(compute_s)}/epoch, "
             f"{bytes_pe/1e6:.3f} MB + {rounds_pe:.0f} collective rounds "
             "per party per epoch", "",
             "| latency \\ bandwidth | " +
             " | ".join(f"{bw} Mbit" for bw in REFERENCE_BANDWIDTHS_MBIT) +
             " |",
             "|---" * (len(REFERENCE_BANDWIDTHS_MBIT) + 1) + "|"]
    g = duration_grid(compute_s, bytes_pe, rounds_pe)
    for lat in REFERENCE_LATENCIES_MS:
        row = [f"| {lat} ms"]
        row += [fmt_s(g[(bw, lat)]) for bw in REFERENCE_BANDWIDTHS_MBIT]
        lines.append(" | ".join(row) + " |")
    lines.append("")
    return "\n".join(lines), g


def comm_per_epoch(ds, plan, tid, variant, mpc, parties, backend, reorder,
                   hoist):
    """(``{"bytes": ..., "rounds": ...}`` a party an epoch, how): counted
    in party processes, else the closed forms."""
    if parties > 1:
        try:
            return (count_comm(ds, tid, parties, variant, mpc, backend,
                               reorder, hoist_agg=hoist),
                    f"counted in {parties} gloo party processes")
        except (RuntimeError, TimeoutError, OSError) as e:
            print(f"[{variant}] comm counting failed: {e}", file=sys.stderr)
            why = f"{type(e).__name__}"
    else:
        why = "one party"
    hoisted = mpc and hoist
    return ({"bytes": analytic_bytes_per_epoch(
                plan, ds.param, variant, mpc=mpc, aggregation=backend,
                hoist_agg=hoisted),
             "rounds": analytic_rounds_per_epoch(ds.param, variant, mpc=mpc,
                                                 hoist_agg=hoisted)},
            f"analytic ({why})")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.network_model",
        description="epoch duration over the reference's network grid")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--variants", default="opt,unopt")
    ap.add_argument("--mpc", action="store_true")
    ap.add_argument("--aggregation", default="auto")
    ap.add_argument("--reorder", action="store_true")
    ap.add_argument("--compute-ms", default=None,
                    help="comma list variant=ms (skip live measurement)")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="also dump the grids as JSON")
    ap.add_argument("--planetoid-root", default=None)
    ap.add_argument("--faithful-unopt", action="store_true",
                    help="disable the mpc engines' loop-invariant agg(x0) "
                         "hoist for unopt variants, restoring the "
                         "reference-faithful per-epoch schedule (its "
                         "f-wide layer-0 halo ships EVERY epoch — the "
                         "paper's Tables 1/2 comparison)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where compute is measured (the card by default)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")

    if args.planetoid_root:
        from cognn_tpu_torch.harness.datasets import load_planetoid_raw

        ds = load_planetoid_raw(args.planetoid_root, args.dataset)
    else:
        ds = synthetic_planetoid(args.dataset)
    compute_ms = {}
    if args.compute_ms:
        for kv in args.compute_ms.split(","):
            k, v = kv.split("=")
            compute_ms[k] = float(v)

    out_json = {"dataset": args.dataset, "parties": args.parties,
                "mpc": args.mpc, "grids": {}}
    tid = default_partition(len(ds.features), args.parties)
    graphs = build_graphs(ds, args.parties, tid=tid)
    plan = build_device_plan(graphs, reorder=args.reorder)
    for variant in args.variants.split(","):
        hoist = not (args.faithful_unopt and variant.startswith("unopt"))
        backend = sharded_backend(plan, ds.param, variant, args.mpc,
                                  args.aggregation, device, hoist_agg=hoist)
        comm, comm_src = comm_per_epoch(ds, plan, tid, variant, args.mpc,
                                        args.parties, backend, args.reorder,
                                        hoist)
        if variant in compute_ms:
            comp = compute_ms[variant] * 1e-3
            src = "provided"
        else:
            comp = measure_compute(ds, plan, variant, args.mpc,
                                   hoist_agg=hoist, device=device)
            src = f"measured on {where}"
        title = (f"{args.dataset} {args.parties}p "
                 f"{'mpc' if args.mpc else 'plaintext'} {variant} "
                 f"[{backend} sharded; comm {comm_src}; compute {src}"
                 + ("; faithful schedule" if not hoist else "") + "]")
        md, g = grid_markdown(title, comp, comm["bytes"]["total"],
                              comm["rounds"]["total"])
        print(md)
        out_json["grids"][variant] = {
            "backend": backend, "compute_s": comp, "compute_src": src,
            "bytes_per_epoch": comm["bytes"],
            "rounds_per_epoch": comm["rounds"],
            "durations": {f"{bw}Mbit/{lat}ms": v
                          for (bw, lat), v in g.items()}}

    # GraphSC analytic comparison row (paper Table 6: 8*sum_dims*10*(n+m)
    # bytes; no round model published -> bytes-only lower bound)
    p = ds.param
    sum_dims = p.input_dim + 2 * p.hidden_dim
    n, m = len(ds.features), len(ds.src)
    gsc_bytes = 8 * sum_dims * 10 * (n + m)
    print(f"### graphsc analytic (comparison): {gsc_bytes/1e6:.1f} MB/epoch"
          f" -> bandwidth term alone "
          + ", ".join(f"{bw} Mbit: {fmt_s(gsc_bytes*8/(bw*1e6))}"
                      for bw in REFERENCE_BANDWIDTHS_MBIT)
          + "  (no published round count; lower bound)")
    out_json["graphsc_analytic_bytes"] = gsc_bytes

    if args.json:
        Path(args.json).write_text(json.dumps(out_json, indent=1))
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
