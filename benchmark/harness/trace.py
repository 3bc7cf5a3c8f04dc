"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` (host and
CUPTI device activity) over a bounded stretch after one warm-up step, read
from its Chrome trace into a :class:`Stretch`.

Device time is the union of the intervals of kernels, copies and sets, so
work that overlaps counts once. The trace file is written to the run's
temporary directory and deleted once read.

:class:`Utilization` reads the card's own utilization counter instead,
with no profiler on: CUPTI's records of the kernels inside a graph hold
the host for milliseconds at some graph launches, so a traced stretch
idles the card for the profiler's sake.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10  # entries of each breakdown list
SMI_PERIOD_MS = 250  # between readings of the utilization counter


@dataclasses.dataclass
class Stretch:
    """What one traced stretch held: ``units`` epochs or requests, its
    length and device-busy seconds, device seconds by operation name, the
    host's runtime calls by name, and the longest device-idle gaps, each
    named by the innermost host operation running at its middle."""

    units: int
    wall_s: float
    busy_s: float
    device_s: Dict[str, float]
    host_calls: Dict[str, int]
    gaps: List[Tuple[str, float]]


def profile_stretch(warmup: Callable[[], None],
                    stretch: Callable[[], int]) -> Callable[[], Stretch]:
    """Trace ``stretch()`` (which returns the units it ran) after one
    untraced ``warmup()``: without a warm-up step CUPTI now and then loses a
    window's first device records. Returns the reading of the trace, to be
    called once the rest of the window has run (exporting and reading the
    trace takes seconds of the host)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        warmup()
        sync()
        prof.step()
        with record_function(STRETCH):
            units = stretch()
            sync()
        prof.step()

    def read() -> Stretch:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
        finally:
            os.remove(path)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        return summarize(events, units)
    return read


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end] rows of ``intervals`` sorted by start."""
    if len(intervals) == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.array(merged)


def summarize(events: list, units: int) -> Stretch:
    """A :class:`Stretch` of the Chrome trace ``events`` (times in µs)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in spans if e["name"] == STRETCH
             and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"{len(marks)} '{STRETCH}' spans in the trace")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])

    def inside(e):
        return lo <= float(e["ts"]) < hi

    dev = [e for e in spans if e.get("cat") in DEVICE_CATS and inside(e)]
    device_s: Dict[str, float] = {}
    for e in dev:
        device_s[e["name"]] = device_s.get(e["name"], 0.0) + e["dur"] * 1e-6

    busy = _union(np.array([[float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                            for e in dev], np.float64).reshape(-1, 2))
    busy_us = (float((np.minimum(busy[:, 1], hi) - busy[:, 0]).sum())
               if len(busy) else 0.0)

    host_calls: Dict[str, int] = {}
    for e in spans:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and inside(e):
            host_calls[e["name"]] = host_calls.get(e["name"], 0) + 1

    gaps = []
    if len(busy):
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        length = edges[:, 1] - edges[:, 0]
        host = [e for e in spans if e.get("cat") in HOST_CATS
                and e["name"] != STRETCH
                and not e["name"].startswith("ProfilerStep")]
        hs = np.array([float(e["ts"]) for e in host])
        he = hs + np.array([float(e["dur"]) for e in host])
        for i in np.argsort(-length, kind="stable")[:TOP]:
            if length[i] <= 0:
                break
            mid = (edges[i, 0] + edges[i, 1]) / 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid)) \
                if len(hs) else []
            name = (host[cover[np.argmax(hs[cover])]]["name"] if len(cover)
                    else "(no host operation traced)")
            gaps.append((name, float(length[i]) * 1e-6))
    return Stretch(units=units, wall_s=(hi - lo) * 1e-6,
                   busy_s=busy_us * 1e-6, device_s=device_s,
                   host_calls=host_calls, gaps=gaps)


def smi_command(device: torch.device) -> List[str]:
    """``nvidia-smi`` reading the card's utilization counter (NVML's share
    of each sample period in which a kernel ran) every
    :data:`SMI_PERIOD_MS`."""
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    card = f"GPU-{uuid}" if uuid is not None else str(device.index or 0)
    return ["nvidia-smi", "--query-gpu=utilization.gpu",
            "--format=csv,noheader,nounits", f"--id={card}", "-lms",
            str(SMI_PERIOD_MS)]


class Utilization:
    """The card's utilization counter over the ``with`` block, read by
    ``command`` in a process of its own: ``percent`` is the mean of its
    readings, the first left out (its period began before the block), or
    None where it gave none."""

    def __init__(self, command: Sequence[str]):
        self.command, self.percent = list(command), None

    def __enter__(self) -> "Utilization":
        self.proc = subprocess.Popen(self.command, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        readings = [float(x) for x in out.split() if x.isdigit()][1:]
        self.percent: Optional[float] = (statistics.fmean(readings)
                                         if readings else None)
