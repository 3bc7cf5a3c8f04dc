"""Per-party logging with the reference's grep-able span format (port of
``cognn_tpu/utils/logging_utils.py``), and the port's tracer.

The reference's only profiler is wall-clock spans printed as
``::<tag> took <seconds>`` lines, which its plot suite greps (reference
`tools/plot/plot_duration_breakdown_and_comm.py:23-47`); the port keeps that
exact line format (:func:`duration_span`).

PyTorch returns from a launch before the card has run it, so a span given a
CUDA ``device`` ends after ``torch.cuda.synchronize()``: its time covers the
device work, not only the launches.

**The tracer.** Off by default (:func:`set_tracing`, :func:`tracing`); off,
each site costs one read of the module-level bool :data:`TRACING`. It keeps
three things, which :func:`snapshot` returns and :func:`reset` clears:

  * **Host spans** (:func:`span`): a count and a sum of
    ``time.perf_counter_ns`` a name. Whenever a ``torch.profiler`` records,
    tracing on or off, a span also opens a ``record_function`` of its name,
    so the program's spans lie in the profiler's Chrome trace on the clock
    of its device records; while a profiler records, spans are not added
    to the sums (the profiler holds some graph launches for milliseconds).
  * **Device phases** (:func:`phase`), the counterpart of the JAX package's
    ``jax.named_scope``: each entry and exit of a phase is a boundary. On
    the card a boundary is a one-thread kernel on the current stream that
    writes the card's ``%globaltimer`` (ns) into a slot of pinned host
    memory (``csrc/stamp.cu``): inside a CUDA graph capture it becomes a
    node of the graph, which each replay runs again into the same slot. A
    timing ``torch.cuda.Event`` recorded in a graph (``external=True``)
    would do the same at 4.6 times the cost (3.6 against 0.8 µs a node on
    the H100). On the CPU, where operations run synchronously, a boundary
    reads ``time.perf_counter_ns``. Phases nest; the time between two
    consecutive boundaries goes to the innermost open phase, or to
    ``unphased`` when none is open (:func:`phase_times`). Boundaries are
    kept only inside a unit of work that an engine's
    :class:`~cognn_tpu_torch.engine.graphs.EngineGraphs` runs (a request, an
    epoch: :func:`recording`), and :func:`collect` turns the last call or
    replay of each unit into a phase table. A graph captured with tracing
    off holds no boundary.
  * **Counters** (:func:`count`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import sys
import time
from typing import Dict, Iterator, List, Optional, TextIO, Tuple

import torch

#: Whether the tracer records. Read at every site; set by
#: :func:`set_tracing` / :func:`tracing`.
TRACING = False

UNPHASED = "unphased"
BLOCK = 8192  # slots of a pinned block of device-clock stamps
RESERVE = 2048  # free slots a unit on the card starts with

# a boundary: ("enter" | "exit", phase name, perf_counter_ns or a slot
# (pinned block, index) that the card's clock fills)
Boundary = Tuple[str, str, object]


class _State:
    """What the tracer holds between :func:`reset` calls."""

    def __init__(self):
        self.spans: Dict[str, List[int]] = {}  # name -> [count, ns]
        self.counters: Dict[str, int] = {}
        self.units: List[dict] = []  # collected phase tables
        # (engine key, step) -> (step, the boundaries of its last call or
        # replay), until collected
        self.pending: Dict[tuple, Tuple[str, List[Boundary]]] = {}
        self.marks: Optional[List[Boundary]] = None  # the unit now running
        self.device: Optional[torch.device] = None  # its card, or None
        self.block: Optional[torch.Tensor] = None  # pinned stamp slots
        self.used = BLOCK  # of the block


_STATE = _State()
_NULL = contextlib.nullcontext()


def set_tracing(on: bool) -> None:
    global TRACING
    TRACING = bool(on)


@contextlib.contextmanager
def tracing(on: bool = True) -> Iterator[None]:
    """Tracing ``on`` (or off) inside the block, as it was after it."""
    was = TRACING
    set_tracing(on)
    try:
        yield
    finally:
        set_tracing(was)


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name, self.t0, self.rf = name, None, None

    def __enter__(self):
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        elif TRACING:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        elif self.t0 is not None:
            dt = time.perf_counter_ns() - self.t0
            s = _STATE.spans.setdefault(self.name, [0, 0])
            s[0] += 1
            s[1] += dt
        return False


def span(name: str):
    """A host span ``name`` around the ``with`` block (module docstring)."""
    if TRACING or _profiling():
        return _Span(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (tracing on)."""
    if TRACING:
        _STATE.counters[name] = _STATE.counters.get(name, 0) + n


def _pinned_block() -> torch.Tensor:
    return torch.zeros(BLOCK, dtype=torch.int64, pin_memory=True)


@functools.cache
def _stamp_kernel():
    from cognn_tpu_torch.ops import _build

    fn = _build.load("stamp").cognn_stamp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stamp(block: torch.Tensor, i: int, device: torch.device) -> None:
    """Launch the kernel that writes the card's clock into ``block[i]``
    on ``device``'s current stream."""
    with torch.cuda.device(device):
        err = _stamp_kernel()(block.data_ptr() + i * block.element_size(),
                              torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"stamp kernel launch failed: CUDA error {err}")


def _take_slots(n: int) -> None:
    """A fresh pinned block unless ``n`` slots are free (outside a
    capture, which may not allocate pinned memory)."""
    if _STATE.used > BLOCK - n:
        _STATE.block, _STATE.used = _pinned_block(), 0


def _boundary(kind: str, name: str) -> None:
    if _STATE.device is None:
        mark = time.perf_counter_ns()
    else:
        _take_slots(1)
        mark = (_STATE.block, _STATE.used)
        _STATE.used += 1
        _stamp(*mark, _STATE.device)
    _STATE.marks.append((kind, name, mark))


class _Phase:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _boundary("enter", self.name)
        return self

    def __exit__(self, *exc):
        _boundary("exit", self.name)
        return False


def phase(name: str):
    """A device phase ``name`` around the ``with`` block (module
    docstring); nothing outside a unit that :func:`recording` keeps."""
    if TRACING and _STATE.marks is not None:
        return _Phase(name)
    return _NULL


class recording:
    """Keep the phase boundaries of the unit of work run inside the block,
    on ``device`` (the card's clock on a CUDA device, the host's
    elsewhere), in ``marks``. With ``key`` (an engine's step: ``(engine,
    name)``), they are the step's last call, which :func:`collect` reads.
    Tracing off: nothing is kept."""

    def __init__(self, device: Optional[torch.device], key=None):
        self.device, self.key = device, key
        self.marks: List[Boundary] = []

    def __enter__(self):
        self.outer = (_STATE.marks, _STATE.device)
        if TRACING:
            _STATE.marks = self.marks
            cuda = self.device is not None and self.device.type == "cuda"
            _STATE.device = self.device if cuda else None
            if cuda:
                _take_slots(RESERVE)
        return self

    def __exit__(self, *exc):
        _STATE.marks, _STATE.device = self.outer
        if self.key is not None:
            replayed(self.key, self.marks)
        return False


def replayed(key, marks: List[Boundary]) -> None:
    """Step ``key`` (``(engine, name)``) ran the boundaries ``marks`` again
    (a replay of the graph they were captured into)."""
    if TRACING and marks:
        _STATE.pending[id(key[0]), key[1]] = (key[1], marks)


def phase_times(marks: List[Tuple[str, str, int]]) -> Dict[str, int]:
    """Exclusive time by phase of boundaries ``marks`` ``[(kind, name,
    t)]`` in order, t an integer time: each interval between two
    consecutive boundaries goes to the innermost phase open over it, or to
    ``unphased``; together they tile the first boundary to the last."""
    out: Dict[str, int] = {}
    stack: List[str] = []
    for (kind, name, t), nxt in zip(marks, marks[1:] + [None]):
        if kind == "enter":
            stack.append(name)
        elif stack and stack[-1] == name:
            stack.pop()
        else:
            raise ValueError(f"exit of phase {name!r} inside {stack}")
        if nxt is not None:
            key = stack[-1] if stack else UNPHASED
            out[key] = out.get(key, 0) + nxt[2] - t
    return out


def _as_ns(marks: List[Boundary]) -> List[Tuple[str, str, int]]:
    """Boundaries with their times as integer ns from the first, a card's
    read from its pinned slots (the caller synchronised)."""
    ts = [t if isinstance(t, int) else int(t[0][t[1]]) for _, _, t in marks]
    return [(k, n, t - ts[0]) for (k, n, _), t in zip(marks, ts)]


def collect() -> List[dict]:
    """Turn the last call or replay of every step run since the last
    :func:`collect` into a phase table ``{"step", "ns": {phase: exclusive
    ns}, "total_ns"}``, kept for :func:`snapshot` and returned. Call it
    after the caller's own synchronisation (a fetch of the results): it
    never synchronises, and reads the card's slots as they stand."""
    units = []
    for step, marks in _STATE.pending.values():
        ns = _as_ns(marks)
        units.append({"step": step, "ns": phase_times(ns),
                      "total_ns": ns[-1][2]})
    _STATE.pending.clear()
    _STATE.units += units
    return units


def snapshot() -> dict:
    """The spans (``{name: {"count", "s"}}``), the collected phase tables
    (``phases``) and the counters so far."""
    return {"spans": {k: {"count": c, "s": ns * 1e-9}
                      for k, (c, ns) in _STATE.spans.items()},
            "phases": list(_STATE.units),
            "counters": dict(_STATE.counters)}


def reset() -> None:
    """Drop every span, phase table, pending step and counter."""
    _STATE.spans.clear()
    _STATE.counters.clear()
    _STATE.units.clear()
    _STATE.pending.clear()


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def duration_span(tag: str, *, out: Optional[TextIO] = None,
                  device: Optional[torch.device] = None) -> Iterator[None]:
    """A :func:`span` ``tag`` that also prints ``::<tag> took <secs>``
    (reference format) to ``out`` (the current ``sys.stdout`` by default);
    on a CUDA ``device`` the span ends after the card's work."""
    t0 = time.perf_counter()
    with span(tag):
        try:
            yield
        finally:
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            print(f"::{tag} took {dt:.6f}", file=out or sys.stdout,
                  flush=True)
