"""One device program per request and per epoch: the stacked engines' entry
points replayed as CUDA graphs, the port's counterpart of the JAX package's
``jax.jit`` of the forward and the epoch and of its ``lax.scan`` over epochs
(``cognn_tpu/engine/gas.py:485-487, 794-807, 863-882``;
``cognn_tpu/mpc/engine.py:648-653, 1292-1345``).

An engine's forward and epoch are many small operations launched one at a
time from Python, and the card waits on the host that launches them. A CUDA
graph captured from the same code launches them all at once.
:class:`EngineGraphs` holds one engine's captured steps (``"forward"``,
``"epoch"``):

  * **Warm-up.** The first call of a step runs eager, on a side stream, and
    returns its own result; it also loads the kernels' libraries and does
    their one-time set-up (K3's ``cudaFuncSetAttribute``). The step is
    captured right after it (``torch.cuda.CUDAGraph`` on the same side
    stream); later calls replay the graph on the current stream.
  * **Static inputs and outputs.** The graph reads the engine's tensors
    where they lie (plan arrays, features, weights, aggregation operands),
    so the engine updates its weights in place and drops its graphs
    (:meth:`EngineGraphs.clear`) when it replaces them. A replay overwrites
    the graph's outputs, so :meth:`EngineGraphs.call` hands out copies.
  * **Memory.** One memory pool an engine, shared by its graphs, which
    replay one at a time on one stream.
  * **Randomness.** The engine's ``torch.Generator``s are registered with
    every graph: a replay draws fresh words at the generator's current
    offset and advances it by what an eager call would (reused masks would
    be a privacy fault).
  * **Launch counts.** The kernel wrappers count launches that reach the
    card: a capture adds nothing, and each replay adds the launches its
    graph holds.

A capture or replay that fails raises; nothing runs eager in its place.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from cognn_tpu_torch.ops import intmatmul

# (object, attribute) of a plain-int launch counter
Counter = Tuple[object, str]


def use_graphs(cuda_graphs: Optional[bool], device: torch.device,
               rank: Optional[int], aggregation: str) -> bool:
    """Whether an engine replays CUDA graphs. ``None`` (the default): where
    it can, stacked on the card on the ``bcsr`` or ``dense`` backend;
    ``True``: there, and raises ``ValueError`` elsewhere; ``False``: never
    (eager on the card too)."""
    eager = []
    if device.type != "cuda":
        eager.append(f"on the {device.type.upper()}")
    if rank is not None:
        eager.append("in sharded mode (its collectives pass through the "
                     "host)")
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
    counts and, with the ``bcsr`` backend, its :class:`Spmm`'s three."""
    counters = [(intmatmul, "launches"), (intmatmul, "launches_i32")]
    if spmm is not None:
        counters += [(spmm, name) for name in
                     ("launches", "ring_launches", "ring32_launches")]
    return counters


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
    """One captured graph, its static outputs and the launches it holds."""

    def __init__(self, graph, out, counters: Sequence[Counter],
                 launches: Sequence[int]):
        self.graph, self.out = graph, out
        self.moved = [(c, n) for c, n in zip(counters, launches) if n]

    def replay(self):
        self.graph.replay()
        for (obj, name), n in self.moved:
            setattr(obj, name, getattr(obj, name) + n)
        return self.out


class EngineGraphs:
    """The captured steps of one engine (module docstring). ``enabled``
    False runs every step eager; ``counters`` are the kernel launch counters
    its steps move (:func:`kernel_counters`); ``generators`` the generators
    they draw from."""

    def __init__(self, enabled: bool, counters: Sequence[Counter],
                 generators: Sequence[torch.Generator] = ()):
        self.enabled = enabled
        self._counters = list(counters)
        self._generators = tuple(generators)
        self._steps: Dict[str, _Step] = {}
        self._pool = None
        self._stream = None
        self.capture_s: Dict[str, float] = {}  # each step's last capture

    def clear(self) -> None:
        """Drop the captured graphs: the tensors they read were replaced.
        The next call of each step warms up and captures again."""
        self._steps.clear()
        self._pool = None

    def run(self, name: str, fn: Callable):
        """``fn()``'s outputs: eager when not enabled; else the first call
        eager, then the capture; later calls replay. A replay's outputs are
        the graph's own, valid until the step's next call."""
        if not self.enabled:
            return fn()
        step = self._steps.get(name)
        if step is not None:
            return step.replay()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        current = torch.cuda.current_stream()
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = fn()
        current.wait_stream(self._stream)
        self._capture(name, fn)
        return out

    def call(self, name: str, fn: Callable):
        """:meth:`run`, with the caller's own copy of a replay's outputs."""
        replay = self.enabled and name in self._steps
        out = self.run(name, fn)
        return _copy(out) if replay else out

    def _capture(self, name: str, fn: Callable) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [getattr(obj, attr) for obj, attr in self._counters]
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = fn()
        self.capture_s[name] = time.perf_counter() - t0
        # the capture launched nothing: take its counts back, and let each
        # replay add them
        launches = [getattr(obj, attr) - b
                    for (obj, attr), b in zip(self._counters, before)]
        for (obj, attr), b in zip(self._counters, before):
            setattr(obj, attr, b)
        self._steps[name] = _Step(graph, out, self._counters, launches)
