"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with as many
NVIDIA cards as the cell asks for (``BENCHMARK.json``). The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``:
each compared number beside its limit); the same numbers end standard
error. Without the cards it asks for, or with JAX or the JAX package
loaded once the window has closed, it exits with another code than 0 and
prints no result.
"""

import time

T_START = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell, spec

    chips = spec.cell(spec.load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    print(f"card: {cell.card_line()}", file=sys.stderr, flush=True)
    try:
        result = cell.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except Exception:
        traceback.print_exc()
        return 1
    foreign = cell.foreign_modules()
    if foreign:
        print(f"loaded modules of JAX or the JAX package: {foreign}: no "
              "result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
