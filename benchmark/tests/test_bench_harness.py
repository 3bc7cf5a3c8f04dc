"""The harness on the CPU: every file it finds by name, the contract's
shape of ``BENCHMARK.json``, the work counts against hand counts, the
reference against the port's engine, the trace reduction, whole runs at a
small size, and a run without a card."""

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, check, readers, spec, trace, work
from benchmark.harness.data import draw_graph, seeds_of
from benchmark.harness.trace import STRETCH, summarize

BENCH = spec.load_benchmark()
SYSTEM = spec.module("systems", "mpc_gas")
REFERENCE = spec.module("reference", "gcn_fixed")
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the numbers each loop compares (cell.run's check)
NUMBERS = {"train": {"loss_gap", "grad_gap", "change_gap"},
           "serve": {"logit_gap"}}
# cora_small's statistics (the port's DATASET_STATS) at PubMed's split
SMALL = dict(num_samples=400, num_edges=1600, input_dim=24, num_labels=3)


def small(workload: str, **kw) -> dict:
    cfg = spec.config(BENCH, spec.cell(BENCH, workload)["config"])
    cfg.update(SMALL, **kw)
    return cfg


@pytest.mark.parametrize("workload", CELLS)
def test_files_found_by_name(workload):
    c = spec.cell(BENCH, workload)
    cfg = spec.config(BENCH, c["config"])
    traffic = spec.traffic(c["traffic"])
    loop = spec.module("loops", traffic["loop"])
    assert loop.UNIT in ("epoch", "request") and callable(loop.Job)
    assert callable(spec.module("systems", cfg["system"]).build)
    assert callable(spec.module("reference", cfg["reference"]).for_config)
    assert set(spec.limits(workload)) == NUMBERS[traffic["loop"]]
    assert cfg["name"] == c["config"]
    for m in spec.per_layer(BENCH, workload):
        assert callable(spec.reader(m["name"]))


def test_a_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="loops 'nowhere'"):
        spec.module("loops", "nowhere")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:  # each reports the metric it moves
            assert m["moves"] in {x["name"] for x in spec.end_to_end(BENCH,
                                                                      w)}
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    four = sum(c["chips"] == 4 for c in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in CELLS:
        assert spec.per_layer(BENCH, w) and len(spec.end_to_end(BENCH, w)) >= 2
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["reduced"] == []


def test_work_counts_by_hand():
    """cora_small's shapes (64 vertices, 256 edges, 16 -> 16 -> 3) on 2
    parties, counted by hand."""
    cfg = dict(num_samples=64, num_edges=256, input_dim=16, hidden_dim=16,
               num_labels=3, num_layers=2, parties=2, ring_bits=64)
    # forward: 2*64*16*16 + agg (256+64)*16 + scale 64*16; layer 1:
    # 2*64*16*3 + src scale 64*3 + agg (320)*3 + 64*3
    fwd = 32768 + 5120 + 1024 + 6144 + 192 + 960 + 192
    assert work.model_flops(cfg, "request") == fwd
    # backward: delta W1^T 6144; phase 3: scale 192, agg 960, scale 192,
    # gradient 6144 + SGD 96; phase 5: scale 1024, agg 5120; gradient
    # 32768 + SGD 512
    bwd = 6144 + 192 + 960 + 192 + 6144 + 96 + 1024 + 5120 + 32768 + 512
    assert work.model_flops(cfg, "epoch") == fwd + bwd
    assert work.k3_shapes(cfg, "epoch") == [
        (2, 32, 16, 16), (2, 32, 16, 3), (2, 32, 3, 16), (2, 16, 32, 3),
        (2, 16, 32, 16)]
    b = work.k3_bound_s((2, 32, 16, 16), 64)
    assert b == max(8 * (2 * 32 * 16 + 2 * 16 * 16 + 2 * 32 * 16) / 3.35e12,
                    2 * 36 * 2 * 32 * 16 * 16 / 1979e12)
    assert work.aggregation_widths(cfg, "epoch") == [16, 3, 3, 16]
    n = 64  # 2 parties x 32 rows
    assert work.spmm_bound_s(cfg, 16, 64) == max(
        (4 * 65 + 12 * 256 + 8 * 2 * 2 * n * 16) / 3.35e12,
        2 * 256 * 16 * 3 / (64 * 132 * 1980e6))


@pytest.mark.parametrize("parties", [1, 2, 3])
def test_reference_matches_port(parties):
    """Bit for bit: the port's revealed losses, weights and logits and the
    plain fixed-point reference's, at a small size on the CPU."""
    cfg = small("cora2p-ss-train", parties=parties, learning_rate=0.5,
                train_ratio=0.2, val_ratio=0.2)
    seeds = seeds_of(2 ** 40 + parties)
    graph = draw_graph(cfg, seeds.graph)
    sut = SYSTEM.build(cfg, graph, seeds, "cpu")
    w0 = sut.weights()
    m1 = sut.epochs(1)
    w1 = sut.weights()
    m2 = sut.epochs(2)
    ref = REFERENCE.for_config(cfg, graph, seeds)
    r = ref.readings(3)
    loss = np.concatenate([m1["loss"], m2["loss"]], 1)
    np.testing.assert_array_equal(loss, r["loss"])
    for got, want in zip(w0 + w1 + sut.weights(),
                         r["w0"] + r["w1"] + r["wn"]):
        np.testing.assert_array_equal(got, want)
    z = sut.rows(sut.request())
    valid = ref.valid.numpy()
    np.testing.assert_array_equal(z[valid], ref.forward().numpy()[valid])
    numbers = check.train_numbers(
        {"loss": loss, "w0": w0, "w1": w1, "wn": sut.weights()}, r, 0.5)
    assert numbers == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def test_summarize_trace():
    """Busy time is the union of device intervals, gaps are named by the
    innermost host operation at their middle."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": STRETCH, "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "ring_matmul_u8_mma",
           "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "csr_gather_sum", "ts": 20,
           "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70,
           "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 35, "dur": 40},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 50, "dur": 8},
          {"ph": "X", "cat": "kernel", "name": "elementwise",
           "ts": 85, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 150,
           "dur": 5}]
    st = summarize(ev, units=2)
    assert st.busy_s == pytest.approx(45e-6)
    assert st.wall_s == pytest.approx(100e-6)
    assert st.device_s["csr_gather_sum"] == pytest.approx(20e-6)
    assert "late" not in st.device_s
    assert st.host_calls == {"cudaGraphLaunch": 1}
    assert st.gaps[0] == ("cudaGraphLaunch", pytest.approx(30e-6))
    r = readers.Reading("train", "epoch", {}, 1, st, 4, 200e-6,
                        utilization=97.5)
    assert readers.idle_share(r, "train") == pytest.approx(2.5)
    assert readers.idle_share(r, "serve") is None
    assert readers.roofline(r, "train", readers.K3, 5e-6) == pytest.approx(
        50.0)
    assert readers.others_us(r, "train") == pytest.approx(7.5)
    assert readers.host_launches(r, "train") == 0.5
    assert readers.mfu(r, "train", 1.0, 1.0) == pytest.approx(
        100 * 4 / 200e-6)
    r.after_units = 0  # no untraced part: nothing to read
    assert readers.mfu(r, "train", 1.0, 1.0) is None
    r.utilization = None  # no counter read: nothing to read
    assert readers.idle_share(r, "train") is None


def test_utilization_counter():
    """The mean of the counter's readings over the block, the first left
    out; the reading process stopped at the block's end."""
    fake = [sys.executable, "-c", "import time\nfor x in (5, 60, 80, 100): "
            "print(x, flush=True)\ntime.sleep(60)"]
    with trace.Utilization(fake) as util:
        time.sleep(2.0)
    assert util.percent == pytest.approx(80.0)
    assert util.proc.poll() is not None


@pytest.mark.parametrize("workload,trace", [
    ("pubmed4p-ss-train", False), ("pubmed4p-ss-train", True),
    ("pubmed4p-ss-serve", False), ("cora2p-ss-train", False)])
def test_cpu_run_is_correct(workload, trace):
    r = cell.run(workload, 2 ** 35 + 11, 0.5, trace, device="cpu",
                 cfg=small(workload))
    assert r["correct"], r["checks"]
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "checks" and r["attempted"] > 0
    json.dumps(r)


def test_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    p = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=spec.ROOT, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.parametrize("workload", CELLS)
def test_every_reader_reads(workload):
    """Each per-layer metric of the cell reads a stretch at the cell's own
    configuration: a share between 0 and 100 where it is one."""
    c = spec.cell(BENCH, workload)
    cfg = spec.config(BENCH, c["config"])
    loop = spec.module("loops", spec.traffic(c["traffic"])["loop"])
    ev = [{"ph": "X", "cat": "user_annotation", "name": STRETCH, "ts": 0,
           "dur": 1e6},
          {"ph": "X", "cat": "kernel", "name": "ring_matmul_u8_mma",
           "ts": 0, "dur": 2e5},
          {"ph": "X", "cat": "kernel", "name": "csr_gather_sum", "ts": 2e5,
           "dur": 1e5},
          {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 3e5,
           "dur": 5e5},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 1, "dur": 8}]
    r = readers.Reading(loop.ROLE, loop.UNIT, cfg, c["chips"],
                        summarize(ev, units=100), 1000, 10.0, 90.0)
    for m in spec.per_layer(BENCH, workload):
        v = spec.reader(m["name"])(r)
        assert v is not None and np.isfinite(v), m["name"]
        if m["unit"] == "%":
            assert 0 < v < 100, (m["name"], v)
