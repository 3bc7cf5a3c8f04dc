"""The readers of the port's own phase tables and spans
(``benchmark/harness/phases.py``): the seven metrics on a hand-made
reading, each None in another role and where the port has no tracer; and
the probe itself on the CPU at ``cora_small``'s size."""

import math

import pytest

from benchmark.harness import phases, spec
from benchmark.harness.readers import Reading

BENCH = spec.load_benchmark()
NEW = {"prng_us.train": ("train", 11.0), "trunc_us.train": ("train", 22.0),
       "apply_us.train": ("train", 33.0),
       "gcn_metrics_us.train": ("train", 44.0),
       "prng_us.serve": ("serve", 11.0),
       "gcn_metrics_us.serve": ("serve", 44.0),
       "forward_host_us.serve": ("serve", 17.5)}
# cora_small's statistics (the port's DATASET_STATS)
SMALL = dict(num_samples=64, num_edges=256, input_dim=16, num_labels=3)


def reading(role, cfg):
    return Reading(role, "epoch" if role == "train" else "request", cfg, 1,
                   None, 0, 0.0)


@pytest.fixture
def made(monkeypatch):
    """A hand-made probe reading for every configuration."""
    got = {"phase_us": {"prng": 11.0, "trunc-reshare": 22.0, "apply": 33.0,
                        "metrics": 44.0, "unphased": 5.0},
           "forward_host_us": 17.5, "spans": {}, "counters": {}, "units": 4}
    monkeypatch.setattr(phases, "_probe", lambda cfg, role: got)
    monkeypatch.setattr(phases, "_CACHE", {})
    return got


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_on_a_made_reading(made, name):
    role, want = NEW[name]
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert m["unit"] == "us" and m["better"] == "lower"
    cfg = spec.config(BENCH, spec.cell(BENCH, m["workloads"][0])["config"])
    read = spec.reader(name)
    assert read(reading(role, cfg)) == want
    other = "serve" if role == "train" else "train"
    assert read(reading(other, cfg)) is None
    made["phase_us"].clear()
    made.pop("forward_host_us")
    assert read(reading(role, cfg)) is None  # the phase is not there


def test_no_tracer_no_reading(monkeypatch):
    """A port without the tracer (the parent's): None, nothing raised;
    and no probe for a role without one."""
    import cognn_tpu_torch.utils.logging_utils as lu

    monkeypatch.delattr(lu, "tracing")
    cfg = dict(spec.config(BENCH, "gcn2_cora_2p_ss"), **SMALL)
    assert phases.measure(cfg, "train") is None
    monkeypatch.setattr(phases, "_CACHE", {})
    assert phases.reading(reading("other", cfg)) is None


@pytest.mark.parametrize("role", ["train", "serve"])
def test_probe_on_the_cpu(monkeypatch, role):
    monkeypatch.setattr(phases, "_CACHE", {})
    cfg = dict(spec.config(BENCH, "gcn2_cora_2p_ss"), **SMALL)
    r = reading(role, cfg)
    got = phases.reading(r)
    assert phases.reading(r) is got  # once a process
    want = {"matmul", "scale", "oga", "nonlinear", "trunc-reshare", "prng",
            "apply", "metrics", "reconstruct", "unphased"}
    assert set(got["phase_us"]) == want
    assert all(v > 0 and math.isfinite(v) for v in got["phase_us"].values())
    assert got["units"] == phases.PROBES[role][1][1]
    if role == "serve":
        assert got["forward_host_us"] > 0
        assert got["spans"]["engine.forward"]["count"] == 1 + 2
    else:
        assert "forward_host_us" not in got
        assert got["spans"]["engine.stack"]["count"] == 2
    assert got["counters"] == {}  # the CPU runs no graph
    from cognn_tpu_torch.utils import logging_utils

    assert not logging_utils.TRACING
    assert logging_utils.snapshot()["phases"] == []
