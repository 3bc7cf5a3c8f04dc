"""The port's tracer (``cognn_tpu_torch/utils/logging_utils.py``) on the
CPU: off, an epoch and a request of the secret-shared engine read no clock
for it, make no CUDA event and leave nothing behind; on, an epoch records
every phase of the protocol layer, and the exclusive phase times tile the
epoch's boundaries exactly; the boundary arithmetic on a hand-built
sequence; spans as ``user_annotation`` events of a ``torch.profiler``
trace; ``duration_span``'s line; and the replay path of
:class:`~cognn_tpu_torch.engine.graphs.EngineGraphs` with ``torch.cuda``'s
graphs and the card's clock (``csrc/stamp.cu``) replaced by stand-ins
(spans, counters, a capture's boundaries read back after a replay, none in
a capture made with tracing off). The stamp kernel itself runs on the card
only (``chip_smoke.py``).
"""

import contextlib
import io
import json
import re
import time
from types import SimpleNamespace

import pytest
import torch

from cognn_tpu_torch.engine.graphs import EngineGraphs
from cognn_tpu_torch.tools.profile_epoch import build_engine
from cognn_tpu_torch.utils import logging_utils as tr

torch.set_num_threads(1)

PHASES = ("matmul", "scale", "oga", "nonlinear", "trunc-reshare", "prng",
          "apply", "metrics")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def engine():
    """Secret-shared CoGNN-Opt on ``cora_small``, P = 2, eager on the
    CPU."""
    return build_engine("cora_small", 2, "auto", "opt", device="cpu")[1]


@pytest.fixture(autouse=True)
def clean():
    tr.reset()
    yield
    tr.set_tracing(False)
    tr.reset()


def test_off_records_nothing(engine, monkeypatch):
    clock = time.perf_counter_ns
    calls = []

    def counted():
        calls.append(1)
        return clock()

    def no_device_clock(*a, **kw):
        raise AssertionError("a CUDA event or stamp with tracing off")

    monkeypatch.setattr(tr.time, "perf_counter_ns", counted)
    monkeypatch.setattr(torch.cuda, "Event", no_device_clock)
    monkeypatch.setattr(tr, "_stamp", no_device_clock)
    assert not tr.TRACING
    engine.run_epoch()
    engine.forward()
    assert calls == [] and tr.collect() == []
    assert tr.snapshot() == {"spans": {}, "phases": [], "counters": {}}


def test_epoch_records_every_phase(engine):
    with tr.tracing():
        engine.run_epoch()
        engine.forward()
        units = tr.collect()
    assert not tr.TRACING
    assert [u["step"] for u in units] == ["epoch", "forward"]
    epoch = units[0]["ns"]
    for name in PHASES:
        assert epoch.get(name, 0) > 0, (name, epoch)
    for u in units:  # exclusive times and unphased tile the unit exactly
        assert sum(u["ns"].values()) == u["total_ns"] > 0
    snap = tr.snapshot()
    assert snap["phases"] == units
    assert snap["spans"]["engine.forward"]["count"] == 1
    assert tr.collect() == []  # each call read once


def test_tiles_the_boundaries(engine):
    with tr.tracing(), tr.recording(CPU) as rec:
        engine._epoch_step()
    marks = rec.marks
    assert len(marks) > 2 * len(PHASES)
    assert all(isinstance(t, int) for _, _, t in marks)
    ns = tr.phase_times(marks)
    assert sum(ns.values()) == marks[-1][2] - marks[0][2]
    assert set(ns) == set(PHASES) | {"reconstruct", tr.UNPHASED}
    # outside a unit, or off, a phase keeps nothing
    with tr.recording(CPU) as off:
        engine._epoch_step()
    assert off.marks == []


def test_phase_times_by_hand():
    marks = [("enter", "a", 100), ("enter", "b", 110), ("exit", "b", 125),
             ("enter", "b", 127), ("enter", "c", 130), ("exit", "c", 131),
             ("exit", "b", 140), ("exit", "a", 150), ("enter", "c", 160),
             ("exit", "c", 165)]
    assert tr.phase_times(marks) == {"a": 10 + 2 + 10, "b": 15 + 3 + 9,
                                     "c": 1 + 5, tr.UNPHASED: 10}
    assert tr.phase_times(marks[:1]) == {}
    with pytest.raises(ValueError, match="exit of phase 'a'"):
        tr.phase_times([("enter", "b", 0), ("exit", "a", 1)])


def test_spans_in_a_profiler_trace(engine, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    out = io.StringIO()
    with tr.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.forward()
        with tr.duration_span("iteration", out=out):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"engine.forward", "iteration"} <= names
    # while a profiler records, spans are not added to the sums
    assert tr.snapshot()["spans"] == {}
    # off, without a profiler, no record_function
    assert tr.span("x") is tr.span("y")


def test_duration_span_line():
    out = io.StringIO()
    with tr.duration_span("graph_load", out=out):
        pass
    assert re.fullmatch(r"::graph_load took \d+\.\d{6}\n", out.getvalue())
    with tr.tracing():
        with tr.duration_span("iteration", out=out):
            tr.count("things", 3)
        tr.count("things")
    assert re.fullmatch(r"::iteration took \d+\.\d{6}\n",
                        out.getvalue().splitlines(True)[1])
    snap = tr.snapshot()
    assert snap["spans"]["iteration"]["count"] == 1
    assert snap["counters"] == {"things": 4}


class _FakeCuda:
    """``torch.cuda``'s graphs and streams and the card's clock as
    stand-ins: a capture runs the step once on the CPU; a stamp writes the
    host clock into its slot when launched (a replay writes nothing
    again)."""

    def __init__(self, monkeypatch):
        self.stamps = 0
        fake = self

        class Graph:
            def register_generator_state(self, gen):
                pass

            def capture_begin(self, pool=None, capture_error_mode=None):
                fake.capturing = True

            def capture_end(self):
                fake.capturing = False

            def replay(self):
                pass

        def stamp(block, i, device):
            assert device.type == "cuda"
            fake.stamps += 1
            block[i] = time.perf_counter_ns()

        monkeypatch.setattr(tr, "_stamp", stamp)
        monkeypatch.setattr(tr, "_pinned_block", lambda: torch.zeros(
            tr.BLOCK, dtype=torch.int64))
        self.capturing = False
        stream = SimpleNamespace(wait_stream=lambda other: None)
        for name, value in (
                ("CUDAGraph", Graph),
                ("Stream", lambda device=None: stream),
                ("current_stream", lambda device=None: stream),
                ("stream", lambda s: contextlib.nullcontext()),
                ("graph_pool_handle", lambda: "pool"),
                ("synchronize", lambda device=None: None),
                ("is_current_stream_capturing", lambda: self.capturing)):
            monkeypatch.setattr(torch.cuda, name, value)


@pytest.mark.parametrize("traced_capture", [False, True],
                         ids=["captured-off", "captured-on"])
def test_replay_path(monkeypatch, traced_capture):
    fake = _FakeCuda(monkeypatch)
    graphs = EngineGraphs(True, [], device=torch.device("cuda"))
    x = torch.ones(4, 2)

    def step():
        with tr.phase("matmul"):
            h = x @ x.T
            with tr.phase("prng"):
                h = h + 1
        return {"h": h, "n": h.sum()}

    with tr.tracing(traced_capture):
        graphs.call("forward", step)  # the warm-up and the capture
    stamps = fake.stamps
    assert stamps == (4 + 4 if traced_capture else 0)
    tr.reset()
    with tr.tracing():
        for _ in range(3):
            out = graphs.call("forward", step)
        units = tr.collect()
        graphs.clear()
    snap = tr.snapshot()
    assert fake.stamps == stamps  # a replay launches nothing new
    assert snap["counters"] == {"graphs.replays": 3, "graphs.clears": 1,
                                "graphs.copied_bytes": 3 * (64 + 4)}
    assert snap["spans"]["graphs.replay"]["count"] == 3
    assert snap["spans"]["graphs.copy_out"]["count"] == 3
    assert "graphs.capture" not in snap["spans"]
    assert torch.equal(out["h"], x @ x.T + 1)
    if traced_capture:  # the last replay's boundaries, the capture's slots
        assert [u["step"] for u in units] == ["forward"]
        assert set(units[0]["ns"]) <= {"matmul", "prng"}
    else:
        assert units == []
    with tr.tracing():
        graphs.call("forward", step)  # captured again after the clear
    assert tr.snapshot()["counters"]["graphs.captures"] == 1
    assert tr.snapshot()["spans"]["graphs.capture"]["count"] == 1
