"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything that belongs to one configuration or one traffic mix is found
by name (:mod:`benchmark.harness.spec`): the configuration's ``system``
builds the system under test (``systems/<system>.py``) and its
``reference`` is the plain reference (``reference/<reference>.py``); the
traffic mix's ``loop`` drives it (``loops/<loop>.py``). A loop module
gives ``UNIT`` (what one unit of work is), ``ROLE`` (the suffix of its
per-layer metrics) and ``Job(sut, traffic, seed)``, whose construction is
the loop's set-up and which offers ``step(k)`` (k calls, returning the
units they ran), ``window(seconds)`` (units and end-to-end metrics),
``close()`` (keep what the check needs, drop the system) and
``numbers(reference, cfg, graph, seeds, device)`` (the compared numbers).

Set-up, counted in ``setup_s``: the inputs drawn from the seed, the
system, and the loop's set-up (the checked first steps, one call of every
shape the window uses). The window then runs for the run's seconds. A
traced run profiles a bounded stretch after a warm-up step and runs
untraced for the rest of its seconds, whose work and time the ``mfu``
metrics read and the ``idle_share`` metrics the card's utilization
counter. Once the window has closed and the peak memory is read, the
system is freed and the reference runs on the same card.
"""

from __future__ import annotations

import contextlib
import gc
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.harness import check, spec
from benchmark.harness.data import draw_graph, seeds_of
from benchmark.harness.readers import Reading
from benchmark.harness.trace import (TOP, Stretch, Utilization,
                                     profile_stretch, smi_command)

FORBIDDEN = ("jax", "jaxlib", "flax", "cognn_tpu")
NAME_CHARS = 120  # of a kernel's name in the breakdown


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``cognn_tpu_torch`` is not ``cognn_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traced(job, seconds: float, dev: torch.device
            ) -> Tuple[Stretch, int, float, Optional[float]]:
    """A traced window: the profiler's warm-up step and stretch, then
    untraced calls until ``seconds`` have passed since the window opened,
    the card's utilization counter read meanwhile (on a card). Returns the
    stretch, the untraced units and seconds, and the utilization, %."""
    t0 = time.perf_counter()
    read = profile_stretch(lambda: job.step(job.trace_warmup),
                           lambda: job.step(job.trace_steps))
    after = 0
    with (Utilization(smi_command(dev)) if dev.type == "cuda"
          else contextlib.nullcontext()) as util:
        t1 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            after += job.step(1)
        _sync(dev)
        after_s = time.perf_counter() - t1
    return read(), after, after_s, util.percent if util else None


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        ring: Optional[Tuple[int, int]] = None,
        bench: Optional[dict] = None, cfg: Optional[dict] = None,
        traffic: Optional[dict] = None) -> dict:
    """Run cell ``workload`` once and return its result line (a dict).
    ``device`` "cpu" runs the same path on the CPU, for the tests, and
    reports no device metric. ``ring`` (bits, fractional bits) runs the
    program at another precision (the control); ``cfg`` and ``traffic``
    replace the configuration and the mix (a test's small size).
    ``seconds`` 0 runs no window: the check's readings only."""
    t_start = time.time() if t_start is None else t_start
    bench = bench or spec.load_benchmark()
    c = spec.cell(bench, workload)
    cfg = cfg or spec.config(bench, c["config"])
    traffic = traffic or spec.traffic(c["traffic"])
    system = spec.module("systems", cfg["system"])
    loop = spec.module("loops", traffic["loop"])
    reference = spec.module("reference", cfg["reference"])
    limits = spec.limits(workload)
    dev = torch.device(device)

    t0 = time.time()
    seeds = seeds_of(seed)
    graph = draw_graph(cfg, seeds.graph)
    t1 = time.time()
    job = loop.Job(system.build(cfg, graph, seeds, dev, ring=ring), traffic,
                   seed)
    _sync(dev)
    e2e: Dict[str, float] = {"setup_s": time.time() - t_start}
    print(f"set-up: inputs {t1 - t0:.3f} s, system and loop "
          f"{time.time() - t1:.3f} s", file=sys.stderr, flush=True)

    reading = None
    if trace:
        st, after, after_s, util = _traced(job, seconds, dev)
        units = st.units + after
        reading = Reading(role=loop.ROLE, unit=loop.UNIT, cfg=cfg,
                          chips=c["chips"], stretch=st, after_units=after,
                          after_s=after_s, utilization=util)
    else:
        units, measured = job.window(seconds)
        e2e.update(measured)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    job.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.time()
    numbers = job.numbers(reference, cfg, graph, seeds, dev)
    print(f"reference: {time.time() - t0:.3f} s", file=sys.stderr, flush=True)

    metrics: Dict[str, dict] = {}
    if on_card and not trace and seconds > 0:
        for m in spec.end_to_end(bench, workload):
            if m["name"] not in e2e:
                raise RuntimeError(f"{workload} lists {m['name']}, which "
                                   f"loop {traffic['loop']!r} does not "
                                   "measure")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if on_card and trace:
        for m in spec.per_layer(bench, workload):
            v = spec.reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": check.judge(numbers, limits),
        "attempted": int(units),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": c["chips"] if on_card else 0,
                   "memory_peak_bytes": int(peak)},
    }
    if trace:
        st = reading.stretch
        result["device"]["busy_s"] = st.busy_s
        result["device"]["window_s"] = st.wall_s
        ops = sorted(st.device_s.items(), key=lambda kv: -kv[1])[:TOP]
        result["breakdown"] = {
            "device_ops": [[name[:NAME_CHARS], s / st.units]
                           for name, s in ops],
            "idle_gaps": [[name[:NAME_CHARS], s] for name, s in st.gaps]}
    # a number that is not finite fails, and is written as null
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": limits.get(k)}
                        for k, v in numbers.items()}
    return result
