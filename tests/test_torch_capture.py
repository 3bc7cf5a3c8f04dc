"""CUDA graphs of the sharded parties and of the analytics sweeps
(``cognn_tpu_torch/engine/graphs.py``), on the CPU, where every engine runs
eager.

Checked here: the capture rule (sharded engines on the card capture now;
the CPU and ``sparse`` still refuse ``cuda_graphs=True``), and a sharded
engine's collectives going through its graphs; how a step is split at its
collectives, with ``torch.cuda``'s graph API replaced by a recorder (the
segments begin and end around each collective, a capture runs no
collective, a replay runs segment, collective, segment in the captured
order on the static buffers, the launch counters and the generators as for
one graph, a failed capture leaves nothing behind, the streams those of the
engine's card and not the current card's: a party on cuda:1 whose current
card was cuda:0 captured nothing, and its graphed results differed from
eager); the analytics engines'
``cuda_graphs`` argument; ``SSAnalyticsEngine.run(iters, seed)`` re-seeding
the engine's one generator: the same revealed values and shares as a fresh
engine and as the former fresh-generator ``run``, whatever ran before, and
still bit-equal to the JAX package's. The graphs themselves run only on
the card, where ``chip_smoke.py`` holds them against eager engines built
from the same seeds (``sharded_phase``, ``analytics_phase``).
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cognn_tpu.engine import build_device_plan as jax_build_device_plan
from cognn_tpu.mpc.analytics import SSAnalyticsEngine as JaxSSAnalytics
from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
from cognn_tpu_torch.engine import GasEngine, analytics, build_device_plan
from cognn_tpu_torch.engine.analytics import AnalyticsEngine
from cognn_tpu_torch.engine.graphs import EngineGraphs, use_graphs
from cognn_tpu_torch.mpc import MpcGasEngine, SSAnalyticsEngine
from cognn_tpu_torch.mpc.protocol import Protocol

from test_torch_analytics import N, graphs_of, source_of
from test_torch_graphs import build

torch.set_num_threads(1)


@pytest.mark.parametrize("cls", [GasEngine, MpcGasEngine],
                         ids=["plain", "mpc"])
def test_sharded_engines_capture_on_the_card(cls):
    """The rule takes no rank: bcsr and dense capture on the card, sharded
    or stacked; the CPU and sparse refuse True. A sharded engine's halo and
    weight mean go through its own graphs."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for agg in ("bcsr", "dense"):
        assert use_graphs(None, cuda, agg) and use_graphs(True, cuda, agg)
    for device, agg in ((cpu, "bcsr"), (cuda, "sparse")):
        assert not use_graphs(None, device, agg)
        with pytest.raises(ValueError, match="cuda_graphs=True"):
            use_graphs(True, device, agg)
    party = SimpleNamespace(world=2, rank=1, device=cpu)
    eng = build(cls is MpcGasEngine, mode="sharded", group=party,
                aggregation="bcsr")
    assert eng.comm.graphs is eng._graphs and not eng._graphs.enabled
    assert build(cls is MpcGasEngine)._graphs.enabled is False
    with pytest.raises(ValueError, match="sparse backend"):
        build(cls is MpcGasEngine, mode="sharded", group=party,
              aggregation="sparse", cuda_graphs=True)


class _Recorder:
    """Stands in for ``torch.cuda``'s streams and graphs: records each
    segment's capture and replay in ``log``; a "captured" operation runs on
    the CPU at once (what a replay would compute is not modelled)."""

    def __init__(self, monkeypatch):
        self.log, self.graphs, self.capturing = [], [], False
        self.devices = []  # the card each stream call named
        rec = self

        class Graph:
            def __init__(self):
                self.id, self.gens = len(rec.graphs), []
                rec.graphs.append(self)

            def register_generator_state(self, gen):
                self.gens.append(gen)

            def capture_begin(self, pool=None, capture_error_mode=None):
                assert not rec.capturing and pool == "pool"
                rec.capturing = True
                rec.log.append(("begin", self.id))

            def capture_end(self):
                assert rec.capturing
                rec.capturing = False
                rec.log.append(("end", self.id))

            def replay(self):
                rec.log.append(("replay", self.id))

        stream = SimpleNamespace(wait_stream=lambda other: None)

        def on(device, value=None):
            rec.devices.append(device)
            return value

        for name, value in (
                ("CUDAGraph", Graph),
                ("Stream", lambda device=None: on(device, stream)),
                ("current_stream", lambda device=None: on(device, stream)),
                ("stream", lambda s: contextlib.nullcontext()),
                ("graph_pool_handle", lambda: "pool"),
                ("synchronize", lambda device=None: on(device)),
                ("is_current_stream_capturing", lambda: rec.capturing)):
            monkeypatch.setattr(torch.cuda, name, value)

    def collective(self, x, out=None):
        """A collective of PartyGroup's form: adds 100."""
        assert not self.capturing
        self.log.append(("collective", x, out))
        if out is None:
            return x + 100
        return out.copy_(x + 100)


def test_a_step_is_split_at_its_collectives(monkeypatch):
    rec = _Recorder(monkeypatch)
    kernel = SimpleNamespace(launches=0)
    gen = torch.Generator()
    card = torch.device("cuda", 1)
    graphs = EngineGraphs(True, [(kernel, "launches")], (gen,), card)
    x = torch.arange(4.0)

    def step():
        kernel.launches += 1
        h = graphs.collective(rec.collective, (x * 2)[::2])  # a view
        kernel.launches += 1
        h = graphs.collective(rec.collective, h + 1)
        return {"out": h * 3}

    first = graphs.run("epoch", step)  # the warm-up, then the capture
    assert torch.equal(first["out"], ((x * 2)[::2] + 201) * 3)
    warm, capture = rec.log[:2], rec.log[2:]
    assert [e[0] for e in warm] == ["collective"] * 2
    assert all(e[2] is None for e in warm)
    assert capture == [("begin", 0), ("end", 0), ("begin", 1), ("end", 1),
                       ("begin", 2), ("end", 2)]  # no collective captured
    assert [g.gens for g in rec.graphs] == [[gen]] * 3
    assert kernel.launches == 2 and graphs.segments("epoch") == 3
    # the side stream, the current stream and the synchronize are the
    # engine's card's, whichever card is current (a party on cuda:1 whose
    # current card was cuda:0 captured nothing of its work)
    assert rec.devices == [card] * 3

    rec.log.clear()
    out = graphs.run("epoch", step)
    kinds = [e[0] if e[0] == "collective" else e for e in rec.log]
    assert kinds == [("replay", 0), "collective", ("replay", 1),
                     "collective", ("replay", 2)]
    (_, in0, out0), (_, in1, out1) = rec.log[1], rec.log[3]
    # static inputs contiguous, static outputs their own buffers
    assert in0.is_contiguous() and in1.is_contiguous()
    assert out0.shape == in0.shape and out1.shape == in1.shape
    assert out0.data_ptr() != in0.data_ptr() != out1.data_ptr()
    assert kernel.launches == 4  # a replay adds what the capture held
    assert graphs.call("epoch", step) is not out  # call hands out a copy

    calls = []

    def failing():  # fails in its capture, after a collective
        calls.append(len(calls))
        h = graphs.collective(rec.collective, x)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return h

    rec.log.clear()
    with pytest.raises(RuntimeError, match="boom"):
        graphs.run("broken", failing)
    assert [e[0] for e in rec.log] == ["collective", "begin", "end", "begin",
                                       "end"]
    assert not rec.capturing and graphs.segments("broken") == 0
    assert torch.equal(graphs.collective(rec.collective, x), x + 100)
    graphs.clear()
    assert graphs.segments("epoch") == 0


def _plan(P, **kw):
    _, _, _, jgraphs, graphs = graphs_of(P, **kw)
    return build_device_plan(graphs), graphs, jgraphs


def test_analytics_cuda_graphs_argument():
    plan, graphs, _ = _plan(2)
    for make in (lambda **kw: AnalyticsEngine(
                     plan, analytics.pagerank_program(num_vertices=N),
                     device="cpu", **kw),
                 lambda **kw: SSAnalyticsEngine(
                     plan, "bfs", source=source_of(graphs), device="cpu",
                     **kw)):
        for flag in (None, False):
            assert not make(cuda_graphs=flag)._graphs.enabled
        with pytest.raises(ValueError, match="on the CPU"):
            make(cuda_graphs=True)


def test_plaintext_run_hands_out_its_own_values():
    """run() sweeps the engine's buffer in place and returns a copy: a
    later run, from other values, leaves it alone; tol stops as before."""
    plan, graphs, _ = _plan(2)
    eng = AnalyticsEngine(plan, analytics.bfs_program(source_of(graphs)),
                          device="cpu")
    first = eng.run(12)
    kept = first.clone()
    h0 = torch.zeros_like(first)
    assert torch.equal(eng.run(3, h0=h0), h0) and torch.equal(first, kept)
    assert torch.equal(eng.run(12), kept)
    assert torch.equal(eng.run(500, tol=0.5), kept)


@pytest.mark.parametrize("name,truncation", [
    ("pagerank", "exact"), ("bfs", "exact"), ("pagerank", "probabilistic")])
def test_ss_run_reseeds_its_generator(name, truncation):
    """run(iters, seed) on one engine: the same seed twice, and again after
    a run with another seed, gives what a fresh engine gives and what the
    former run (a fresh generator a call) gave: revealed values and shares
    torch.equal. Under probabilistic truncation the reveal depends on the
    seed, so a wrong seed would show there too."""
    plan, graphs, _ = _plan(2)
    kw = ({"num_vertices": N} if name == "pagerank"
          else {"source": source_of(graphs)})
    proto = Protocol(FixedPointSpec(frac_bits=24), truncation)

    def engine():
        return SSAnalyticsEngine(plan, name, proto=proto, device="cpu", **kw)

    eng, iters = engine(), 6
    runs = [(eng.run(iters, seed), eng._h_sh.clone()) for seed in (5, 5, 9,
                                                                   5)]
    fresh = engine()
    want = (fresh.run(iters, 5), fresh._h_sh)
    gen = torch.Generator().manual_seed(5)  # the former run()
    h = proto.share(gen, torch.as_tensor(fresh.init_values()))
    for _ in range(iters):
        h = fresh.iteration(gen, h)
    assert torch.equal(h, want[1]) and torch.equal(proto.reveal(h), want[0])
    for (z, sh) in (runs[0], runs[1], runs[3]):
        assert torch.equal(z, want[0]) and torch.equal(sh, want[1])
    assert not torch.equal(runs[2][1], want[1])  # another seed, other shares
    if truncation == "probabilistic":
        assert not torch.equal(runs[2][0], want[0])


def test_reseeded_run_bit_equal_to_jax():
    """bfs on 2 parties, after a run with another seed: the revealed hop
    counts bit-equal to the JAX package's engine."""
    plan, graphs, jgraphs = _plan(2)
    src = source_of(graphs)
    want = JaxSSAnalytics(jax_build_device_plan(jgraphs), "bfs",
                          source=src).run(12)
    eng = SSAnalyticsEngine(plan, "bfs", source=src, device="cpu")
    eng.run(4, seed=11)
    np.testing.assert_array_equal(eng.run(12, seed=3).numpy(),
                                  np.asarray(want))
