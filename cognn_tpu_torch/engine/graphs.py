"""One device program per request, per epoch and per analytics sweep: the
engines' entry points replayed as CUDA graphs, the port's counterpart of the
JAX package's ``jax.jit`` of the forward and the epoch, of its ``lax.scan``
over epochs and of its ``shard_map`` of a sharded party's step
(``cognn_tpu/engine/gas.py:481-505, 794-807, 863-882``;
``cognn_tpu/mpc/engine.py:637-653, 1292-1345``;
``cognn_tpu/engine/analytics.py:75``, ``cognn_tpu/mpc/analytics.py:164``).

An engine's forward and epoch are many small operations launched one at a
time from Python, and the card waits on the host that launches them. A CUDA
graph captured from the same code launches them all at once.
:class:`EngineGraphs` holds one engine's captured steps (``"forward"``,
``"epoch"``, ``"sweep"``):

  * **Warm-up.** The first call of a step runs eager, on a side stream of
    the engine's card, and returns its own result; it also loads the
    kernels' libraries and does their one-time set-up (K3's
    ``cudaFuncSetAttribute``). The step is captured right after it
    (``torch.cuda.CUDAGraph`` on the same side stream); later calls replay
    the graph on the card's current stream. The side stream is the
    engine's card's, not the current card's: a capture on another card's
    stream would record nothing of the engine's work.
  * **Collectives.** A sharded party's step calls its collectives (the halo
    ``all_to_all``, the weight mean's ``all_reduce``) through
    :meth:`EngineGraphs.collective`, and the capture splits the step there:
    the device work between two collectives is one graph (a segment). At a
    collective the capture ends the current segment, runs nothing (its
    input holds no values yet, and the comm counters must not count it),
    records the collective with its static input and a static output
    allocated outside the graphs' pool (no segment's allocations can
    overwrite it), and begins the next segment, which reads that output. A
    replay runs segment 0, collective 0 from its static input into its
    static output, segment 1, and so on; every party replays in the same
    order, so the collectives match across the parties as they do eagerly,
    over gloo (host copies, which no capture can hold) and over NCCL alike.
    A stacked engine's step has no collective: one segment.
  * **Static inputs and outputs.** The graph reads the engine's tensors
    where they lie (plan arrays, features, weights, aggregation operands),
    so the engine updates its weights in place and drops its graphs
    (:meth:`EngineGraphs.clear`) when it replaces them. A replay overwrites
    the graph's outputs, so :meth:`EngineGraphs.call` hands out copies.
  * **Memory.** One memory pool an engine, shared by its graphs and by the
    segments of a step, which replay one at a time on one stream in the
    order they were captured; a tensor that a later segment reads stays
    referenced, so no later segment's allocation takes its memory.
  * **Randomness.** The engine's ``torch.Generator``s are registered with
    every graph: a replay draws fresh words at the generator's current
    offset and advances it by what an eager call would (reused masks would
    be a privacy fault).
  * **Launch counts.** The kernel wrappers count launches that reach the
    card: a capture adds nothing, and each replay adds the launches its
    segments hold.
  * **Tracing** (:mod:`cognn_tpu_torch.utils.logging_utils`, off by
    default). Host spans ``graphs.replay`` (a replay's launches),
    ``graphs.copy_out`` (:meth:`EngineGraphs.call`'s copies) and
    ``graphs.capture``; counters ``graphs.replays``, ``graphs.captures``,
    ``graphs.clears`` and ``graphs.copied_bytes``. Each call of a step
    keeps the phase boundaries its code records (``recording``): an eager
    call's own, a capture's as nodes of its graph, which every replay
    records again, so the tracer's ``collect`` reads a replay's phases.

Graphs run on the card on the ``bcsr`` and ``dense`` backends, stacked and
sharded (:func:`use_graphs`); the CPU and the ``sparse`` backend run eager.
A capture or replay that fails raises; nothing runs eager in its place.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from cognn_tpu_torch.ops import intmatmul
from cognn_tpu_torch.ops import metrics as metric_ops
from cognn_tpu_torch.utils import logging_utils as trace

# (object, attribute) of a plain-int launch counter
Counter = Tuple[object, str]


def use_graphs(cuda_graphs: Optional[bool], device: torch.device,
               aggregation: Optional[str] = None) -> bool:
    """Whether an engine replays CUDA graphs. ``None`` (the default): where
    it can, on the card on any backend but ``sparse`` (stacked or sharded;
    ``aggregation`` None for an engine without one); ``True``: there, and
    raises ``ValueError`` elsewhere; ``False``: never (eager on the card
    too)."""
    eager = []
    if device.type != "cuda":
        eager.append(f"on the {device.type.upper()}")
    if aggregation == "sparse":
        eager.append("on the sparse backend (the eager yardstick of the "
                     "kernel paths)")
    if cuda_graphs is None:
        return not eager
    if cuda_graphs and eager:
        raise ValueError("cuda_graphs=True: an engine runs eager "
                         + " and ".join(eager))
    return bool(cuda_graphs)


def kernel_counters(spmm) -> list:
    """The launch counters an engine's steps move: K3's int64 and int32
    counts, the metrics kernel's and, with the ``bcsr`` backend, its
    :class:`Spmm`'s three."""
    counters = [(intmatmul, "launches"), (intmatmul, "launches_i32"),
                (metric_ops, "launches")]
    if spmm is not None:
        counters += [(spmm, name) for name in
                     ("launches", "ring_launches", "ring32_launches")]
    return counters


def _nbytes(out) -> int:
    """The bytes of every tensor in ``out`` (tuples, lists, dicts)."""
    if isinstance(out, torch.Tensor):
        return out.nbytes
    if isinstance(out, dict):
        return _nbytes(list(out.values()))
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(v) for v in out)
    return 0


def _copy(out):
    """``out`` (tensors in tuples, lists and dicts) with every tensor
    cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _copy(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_copy(v) for v in out)
    return out


class _Step:
    """One captured step: its segments, the collectives between them (each
    a call reading its static input and writing its static output), its
    static outputs, the launches it holds and the phase boundaries captured
    into it (none when tracing was off)."""

    def __init__(self, segments: Sequence, collectives: Sequence[Callable],
                 out, counters: Sequence[Counter], launches: Sequence[int],
                 marks: list):
        self.segments, self.collectives = list(segments), list(collectives)
        self.out = out
        self.moved = [(c, n) for c, n in zip(counters, launches) if n]
        self.marks = marks

    def replay(self):
        for graph, collective in itertools.zip_longest(self.segments,
                                                       self.collectives):
            graph.replay()
            if collective is not None:
                collective()
        for (obj, name), n in self.moved:
            setattr(obj, name, getattr(obj, name) + n)
        return self.out


class EngineGraphs:
    """The captured steps of one engine (module docstring). ``enabled``
    False runs every step eager; ``counters`` are the kernel launch counters
    its steps move (:func:`kernel_counters`); ``generators`` the generators
    they draw from; ``device`` the engine's card, whose streams capture and
    replay the steps whichever card is current."""

    def __init__(self, enabled: bool, counters: Sequence[Counter],
                 generators: Sequence[torch.Generator] = (),
                 device: Optional[torch.device] = None):
        self.enabled = enabled
        self.device = device
        self._counters = list(counters)
        self._generators = tuple(generators)
        self._steps: Dict[str, _Step] = {}
        self._pool = None
        self._stream = None
        # the step being captured: its segments and collectives so far
        self._segments: Optional[List] = None
        self._collectives: List[Callable] = []

    def clear(self) -> None:
        """Drop the captured graphs: the tensors they read were replaced.
        The next call of each step warms up and captures again."""
        if self._steps:
            trace.count("graphs.clears")
        self._steps.clear()
        self._pool = None

    def segments(self, name: str) -> int:
        """The graphs a replay of step ``name`` launches (0: not
        captured)."""
        step = self._steps.get(name)
        return 0 if step is None else len(step.segments)

    def run(self, name: str, fn: Callable):
        """``fn()``'s outputs: eager when not enabled; else the first call
        eager, then the capture; later calls replay. A replay's outputs are
        the graph's own, valid until the step's next call."""
        key = (self, name)
        if not self.enabled:
            with trace.recording(self.device, key):
                return fn()
        step = self._steps.get(name)
        if step is not None:
            with trace.span("graphs.replay"):
                out = step.replay()
            trace.count("graphs.replays")
            trace.replayed(key, step.marks)
            return out
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream), \
                trace.recording(self.device, key):
            out = fn()
        current.wait_stream(self._stream)
        self._capture(name, fn)
        return out

    def call(self, name: str, fn: Callable):
        """:meth:`run`, with the caller's own copy of a replay's outputs."""
        replay = self.enabled and name in self._steps
        out = self.run(name, fn)
        if not replay:
            return out
        if trace.TRACING:
            trace.count("graphs.copied_bytes", _nbytes(out))
        with trace.span("graphs.copy_out"):
            return _copy(out)

    def collective(self, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """``fn(x)``, a collective of
        :class:`cognn_tpu_torch.utils.distributed.PartyGroup` (one that
        takes ``out=``), at a breakpoint of the step being captured: eager
        outside a capture; in one, the current segment ends, the collective
        is recorded on the static ``x`` and a static output (returned), and
        the next segment begins."""
        if self._segments is None:
            return fn(x)
        x = x.contiguous()  # in the segment that ends here
        self._segments[-1].capture_end()
        out = torch.empty_like(x)  # outside the pool
        self._collectives.append(functools.partial(fn, x, out=out))
        self._begin_segment()
        return out

    def _begin_segment(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        self._segments.append(graph)
        # other threads may use the card meanwhile (NCCL's watchdog polls
        # its events): only this thread's calls must be capturable
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")

    def _capture(self, name: str, fn: Callable) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [getattr(obj, attr) for obj, attr in self._counters]
        torch.cuda.synchronize(self.device)
        self._segments, self._collectives = [], []
        try:
            with trace.span("graphs.capture"), \
                    torch.cuda.stream(self._stream), \
                    trace.recording(self.device) as rec:
                self._begin_segment()
                try:
                    out = fn()
                finally:
                    if torch.cuda.is_current_stream_capturing():
                        self._segments[-1].capture_end()
            segments, collectives = self._segments, self._collectives
        finally:
            self._segments, self._collectives = None, []
        trace.count("graphs.captures")
        # the capture launched nothing: take its counts back, and let each
        # replay add them
        launches = [getattr(obj, attr) - b
                    for (obj, attr), b in zip(self._counters, before)]
        for (obj, attr), b in zip(self._counters, before):
            setattr(obj, attr, b)
        self._steps[name] = _Step(segments, collectives, out, self._counters,
                                  launches, rec.marks)
