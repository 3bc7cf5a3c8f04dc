"""The port's own account of a cell's work: its tracer's phase tables,
host spans and counters (``cognn_tpu_torch/utils/logging_utils.py``),
read by the per-layer metrics that name a phase or a span.

The harness's run turns nothing on in the program, so these readings come
from a probe of their own: :func:`reading` starts a process of its own
(``python -m benchmark.harness.phases <role>``, the configuration on its
standard input), which builds the cell's system from seed 0 with the
port's tracer on, runs a short stretch of the cell's loop, and collects
the phase table of each unit after its fetch (the tracer never
synchronises by itself). A process of its own, since a process that has
run the profiler (the traced run's stretch) makes its later CUDA calls
slower on the host, which ``engine.forward``'s span would read; the
phases' device times read the same in both (PERF.md).

``train``: one warm dispatch of ``epochs(90)`` (the capture), then 4
dispatches, one epoch's table each (the last replay of each dispatch).
``serve``: 20 warm requests, then 300, a table and the host time of
``engine.forward`` each. On the CPU (the tests) ``epochs(1)``, and 1 warm
and 2 requests. A graph captured with tracing on holds its phase
boundaries as kernel nodes, so the probe's own epochs and requests run
slower than the window's: the phase times are its, and no end-to-end
metric is read from it.

Besides the system module, this is the one file of the benchmark that
imports ``cognn_tpu_torch``, inside :func:`measure`: a checkout whose port
has no tracer gives no reading (None), and its metrics are left out.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.harness import spec
from benchmark.harness.data import draw_graph, seeds_of

TIMEOUT_S = 900  # of the probe's process

# role -> (warm units, measured units) on the card; on the CPU
PROBES = {"train": ((90, 4), (1, 1)), "serve": ((20, 300), (1, 2))}
EPOCHS = 90  # a dispatch on the card, as the train mix's
FORWARD = "engine.forward"

_CACHE: Dict[Tuple[str, str], Optional[dict]] = {}


def reading(r) -> Optional[dict]:
    """The probe's reading for ``r``'s configuration and role, once a
    process: ``phase_us`` (median exclusive device µs a unit, by phase),
    ``forward_host_us`` (median host µs of ``engine.forward`` a request,
    serve), ``spans``, ``counters`` and ``units``; None for a role with no
    probe or a port with no tracer."""
    key = (json.dumps(r.cfg, sort_keys=True), r.role)
    if key not in _CACHE:
        _CACHE[key] = _probe(r.cfg, r.role)
    return _CACHE[key]


def phase_us(r, role: str, name: str) -> Optional[float]:
    """Median exclusive µs a unit of phase ``name`` in ``role``'s cells."""
    got = reading(r) if r.role == role else None
    return None if got is None else got["phase_us"].get(name)


def forward_host_us(r, role: str) -> Optional[float]:
    got = reading(r) if r.role == role else None
    return None if got is None else got.get("forward_host_us")


def _probe(cfg: dict, role: str) -> Optional[dict]:
    """:func:`measure` in a process of its own (module docstring)."""
    if role not in PROBES:
        return None
    r = subprocess.run([sys.executable, "-m", "benchmark.harness.phases",
                        role], input=json.dumps(cfg), stdout=subprocess.PIPE,
                       text=True, cwd=spec.ROOT, timeout=TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"the phase probe of {cfg['name']} {role} "
                           f"exited {r.returncode}")
    return json.loads(r.stdout.splitlines()[-1])


def measure(cfg: dict, role: str) -> Optional[dict]:
    """The probe's stretch in this process: the reading of
    :func:`reading`, or None where the port has no tracer."""
    try:
        from cognn_tpu_torch.utils.logging_utils import (collect, reset,
                                                         snapshot, tracing)
    except ImportError:  # a port without the tracer
        return None
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda" if cuda else "cpu")
    warm, measured = PROBES[role][0 if cuda else 1]
    seeds = seeds_of(0)
    tables: List[Dict[str, int]] = []
    host_us: List[float] = []

    def forward_ns() -> int:
        s = snapshot()["spans"].get(FORWARD)
        return 0 if s is None else round(s["s"] * 1e9)

    with tracing():
        reset()
        sut = spec.module("systems", cfg["system"]).build(
            cfg, draw_graph(cfg, seeds.graph), seeds, dev)
        if role == "train":
            n = EPOCHS if cuda else 1
            sut.epochs(n)  # the capture
            collect()
            for _ in range(measured):
                sut.epochs(n)
                tables += [u["ns"] for u in collect()]
        else:
            for _ in range(warm):
                sut.request()
            collect()
            for _ in range(measured):
                t0 = forward_ns()
                sut.request()
                host_us.append((forward_ns() - t0) * 1e-3)
                tables += [u["ns"] for u in collect()]
        snap = snapshot()
        reset()
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    names = sorted({k for t in tables for k in t})
    out = {"phase_us": {k: statistics.median(t.get(k, 0) * 1e-3
                                             for t in tables)
                        for k in names},
           "spans": snap["spans"], "counters": snap["counters"],
           "units": len(tables)}
    if host_us:
        out["forward_host_us"] = statistics.median(host_us)
    print(f"phases {cfg['name']} {role} ({len(tables)} units, median "
          f"exclusive us a unit): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              out["phase_us"].items(), key=lambda kv: -kv[1]))
          + f"; total {sum(out['phase_us'].values()):.2f}; spans "
          + ", ".join(f"{k} {v['count']} x {1e6 * v['s'] / v['count']:.2f} us"
                      for k, v in snap["spans"].items())
          + f"; counters {snap['counters']}"
          + (f"; engine.forward median {out['forward_host_us']:.2f} us"
             if host_us else ""), file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    print(json.dumps(measure(json.loads(sys.stdin.read()), sys.argv[1])),
          flush=True)
