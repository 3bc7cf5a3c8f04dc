"""The readings that a cell's limits are set from, on the card at the
cell's own size: the compared numbers of sound runs of the program on many
seeds, of the control (the program's own 32-bit ring, at the
configuration's fractional bits and at 8) and, for a training cell, of its
faults planted in the reference put in the program's place (half of each
party's training rows, the mean taken over them). A state left unchanged
reads 1 by the measure and needs no run.

    python benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... [--seconds <s>] [--faults-only] \
        [--out <file.json>]

A training cell's readings need no window (``--seconds 0``); a serving
cell's take a short one, long enough to sample its answers. Not run by
the benchmark's own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROL_RINGS = ((32, 16), (32, 8))


def fault_numbers(cfg: dict, traffic: dict, seed: int, fault: str,
                  device) -> dict:
    """The numbers of the reference with ``fault`` planted, in the
    program's place, against the sound reference."""
    from benchmark.harness import check, spec
    from benchmark.harness.data import draw_graph, seeds_of

    reference = spec.module("reference", cfg["reference"])
    seeds = seeds_of(seed)
    graph = draw_graph(cfg, seeds.graph)
    steps = traffic["checked_steps"]
    bad = reference.for_config(cfg, graph, seeds, device, fault=fault)
    good = reference.for_config(cfg, graph, seeds, device)
    return check.train_numbers(bad.readings(steps), good.readings(steps),
                               cfg["learning_rate"])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--rings", nargs="*", default=[f"{b}:{f}" for b, f in
                                                    CONTROL_RINGS],
                    help="the control's rings, bits:fractional bits")
    ap.add_argument("--faults-only", action="store_true",
                    help="only the faults in the reference")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell, spec

    bench = spec.load_benchmark()
    c = spec.cell(bench, args.workload)
    cfg = spec.config(bench, c["config"])
    traffic = spec.traffic(c["traffic"])
    print(f"card: {cell.card_line()}", flush=True)
    rows = []

    def record(kind, seed, numbers, t0):
        rows.append({"kind": kind, "seed": seed, "numbers": numbers})
        print(f"{kind} seed={seed} {json.dumps(numbers)} "
              f"({time.time() - t0:.1f} s)", flush=True)

    for seed in args.seeds:
        t0 = time.time()
        r = cell.run(args.workload, seed, args.seconds, False)
        record("sound", seed, {k: v["value"] for k, v in r["checks"].items()},
               t0)
    rings = [tuple(int(x) for x in r.split(":")) for r in args.rings]
    for bits, frac in () if args.faults_only else rings:
        for seed in args.control_seeds:
            t0 = time.time()
            try:
                r = cell.run(args.workload, seed, args.seconds, False,
                             ring=(bits, frac))
                numbers = {k: v["value"] for k, v in r["checks"].items()}
            except Exception as e:  # a control that crashes has failed
                numbers = {"error": repr(e)}
            record(f"control ring{bits} f{frac}", seed, numbers, t0)
    if traffic["loop"] == "train":
        for seed in args.control_seeds:
            t0 = time.time()
            record("fault half_batch", seed,
                   fault_numbers(cfg, traffic, seed, "half_batch",
                                 torch.device("cuda")), t0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
