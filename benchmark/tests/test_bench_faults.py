"""The check catches what it is there for: with the timed path broken
underneath (a fault planted in the port's engine, ``faults.py``), a whole
run at a small size on the CPU comes out not correct, once for each fault
its cell can have; and so does the control, the program's own 32-bit
ring. The look for a card is skipped (``cell.run`` on the CPU).

The control at each cell's own size runs on the card by
``benchmark/calibrate.py``."""

import importlib.util
from pathlib import Path

import pytest

from benchmark.harness import cell, spec

FAULTS = Path(__file__).resolve().parent / "faults.py"
BENCH = spec.load_benchmark()
SMALL = dict(num_samples=400, num_edges=1600, input_dim=24, num_labels=3)
SEED = 2 ** 36 + 5


def small_run(workload, **kw):
    c = spec.cell(BENCH, workload)
    cfg = dict(spec.config(BENCH, c["config"]), **SMALL)
    traffic = dict(spec.traffic(c["traffic"]))
    for key in ("epochs_per_dispatch", "train_epochs"):
        if key in traffic:
            traffic[key] = 4
    return cell.run(workload, SEED, 0.2, False, device="cpu", cfg=cfg,
                    traffic=traffic, bench=BENCH, **kw)


@pytest.fixture
def plant(monkeypatch):
    """Calls a fault of ``faults.py`` with the engine's attributes saved,
    so that each test's fault is undone after it."""
    from cognn_tpu_torch.mpc import engine as mpc_engine

    for name in ("_epoch_step", "__init__", "_forward_body"):
        monkeypatch.setattr(mpc_engine.MpcGasEngine, name,
                            mpc_engine.MpcGasEngine.__dict__[name])
    loader = importlib.util.spec_from_file_location("faults", FAULTS)
    faults = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(faults)
    return lambda name: getattr(faults, name)()


@pytest.mark.parametrize("workload,fault", [
    ("pubmed4p-ss-train", "state_unchanged"),
    ("pubmed4p-ss-train", "half_batch"),
    ("cora2p-ss-train", "state_unchanged"),
    ("cora2p-ss-train", "half_batch"),
    ("pubmed4p-ss-serve", "answer_altered")])
def test_stacked_fault_is_not_correct(plant, workload, fault):
    assert small_run(workload)["correct"]
    plant(fault)
    r = small_run(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", [c["name"] for c in BENCH["workloads"]
                                      if c["chips"] == 1])
@pytest.mark.parametrize("ring", [(32, 16), (32, 8)])
def test_control_is_not_correct(workload, ring):
    """The program on its 32-bit ring, the precision below the
    configuration's 64-bit one, fails the check."""
    r = small_run(workload, ring=ring)
    assert not r["correct"], r["checks"]
