"""The port's evaluation-matrix driver and summarizer
(``cognn_tpu_torch/tools/{run_cluster,log_parse,summarize_matrix}.py``) on
the CPU, against the JAX package's log parser and summarizer and the port's
engines and oracle.

A module fixture runs the driver on a tiny graph (``tests/test_oracle.py``'s
``make_dataset``, 2 parties, 2 epochs): plaintext and secret-shared
CoGNN-Opt training through :func:`run_training`, and, through
:func:`main`, the secret-shared unopt inference and the plaintext opt
inference on ``cora_small``, and the GraphSC rows. Each party's log parses
the same by the port's ``log_parse`` and by ``tools/plot/log_parse.py``; its
metric lines are the port's engine's (the same plan, seeds and epochs),
and lie within 5e-4 (plaintext) or 5e-3 (secret-shared) of the port's
float64 oracle (tests/test_engine.py:43, tests/test_mpc.py:104). Every
``.comm`` payload is counted (``"measured": true``, two gloo party
processes) and equals the closed-form ``analytic_bytes_per_epoch``. On the
same log tree the port's summarizer gives the JAX ``one_cell``'s cells and
the JAX summary's table rows; only the header differs.
"""

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cognn_tpu_torch.engine import build_device_plan
from cognn_tpu_torch.harness.datasets import Dataset, synthetic_planetoid
from cognn_tpu_torch.models.oracle import GasOracle
from cognn_tpu_torch.tools import log_parse, run_cluster, summarize_matrix

from test_oracle import make_dataset
from test_torch_gas import data, torch_param

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EPOCHS = 2
TOL = {False: 5e-4, True: 5e-3}  # tests/test_engine.py:43, test_mpc.py:104
METRIC_LINES = (("loss", "cross-entropy-loss"), ("full_acc", "full set"),
                ("train_acc", "training set"),
                ("border_train_acc", "border training set"),
                ("test_acc", "test set"),
                ("border_test_acc", "border test set"))
# (setting, dataset, parties, variant, secret-shared, epochs)
RUNS = (("opt_accuracy_2p", "tiny", 2, "opt", False, EPOCHS),
        ("mpc_opt_accuracy_2p", "tiny", 2, "opt", True, EPOCHS),
        ("mpc_unopt_inference", "cora_small", 2, "unopt_inference", True, 1),
        ("opt_inference", "cora_small", 2, "opt_inference", False, 1))


def load_tool(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny():
    src, dst, feats, labels, param = data()
    return Dataset("tiny", src, dst, feats, labels, torch_param(param))


def dataset(name):
    return tiny() if name == "tiny" else synthetic_planetoid(name)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("matrix")
    log_root, comm_root = root / "log", root / "comm"
    for setting, name, P, variant, mpc, epochs in RUNS[:2]:
        run_cluster.run_training(tiny(), P, epochs, variant, mpc, setting,
                                 log_root=log_root, comm_root=comm_root,
                                 time_budget=0.01, device="cpu")
    common = ["--device", "cpu", "--dataset", "cora_small", "--log-root",
              str(log_root), "--comm-root", str(comm_root)]
    assert run_cluster.main(["--cognn-unopt-inference", "--mpc"]
                            + common) == 0
    assert run_cluster.main(["--cognn-opt-inference", "--graphsc",
                             "--parties", "2", "3"] + common) == 0
    return log_root, comm_root


def engine_metrics(name, P, variant, mpc, epochs):
    ds = dataset(name)
    plan = build_device_plan(run_cluster.build_graphs(ds, P))
    eng = run_cluster.make_engine(plan, ds.param, variant, mpc, "auto",
                                  "cpu")
    if variant.endswith("inference"):
        m = eng.metrics_host(eng.forward()[2])
        return {k: v[:, None] for k, v in m.items()}, plan, ds.param
    return eng.metrics_host(eng.run_epochs_scan(epochs)), plan, ds.param


@pytest.mark.parametrize("run", RUNS, ids=lambda r: r[0])
def test_logs_parse_like_jax(tree, run):
    jax_parse = load_tool("jax_log_parse", ROOT / "tools/plot/log_parse.py")
    log_root, _ = tree
    setting, name, P, variant, mpc, epochs = run
    logs = sorted((log_root / setting).glob(f"gcn_test_{name}_*.log"))
    assert len(logs) == P
    layers = 2
    spans = (epochs * (3 if variant == "opt" else 2) * layers
             if not variant.endswith("inference") else layers)
    for lg in logs:
        got = log_parse.parse_party_log(lg)
        assert got == jax_parse.parse_party_log(lg)
        assert len(got["durations"]["iteration"]) == spans
        assert len(got["loss"]) == epochs
        per_epoch = spans // epochs
        assert log_parse.epoch_durations(
            got["durations"]["iteration"], per_epoch) == \
            jax_parse.epoch_durations(got["durations"]["iteration"],
                                      per_epoch)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: r[0])
def test_metrics_equal_engine(tree, run):
    log_root, _ = tree
    setting, name, P, variant, mpc, epochs = run
    m, _, _ = engine_metrics(name, P, variant, mpc, epochs)
    for p in range(P):
        got = log_parse.parse_party_log(
            log_root / setting / f"gcn_test_{name}_{p}.log")
        for key, line in METRIC_LINES:
            logged = got["loss"] if key == "loss" else got["accuracy"][line]
            want = [float(f"{v:.6f}") for v in m[key][p]]
            assert logged == want, (p, key)


@pytest.mark.parametrize("mpc", [False, True], ids=["plaintext", "mpc"])
def test_metrics_within_oracle(tree, mpc):
    log_root, _ = tree
    setting = "mpc_opt_accuracy_2p" if mpc else "opt_accuracy_2p"
    ds = tiny()
    orc = GasOracle(run_cluster.build_graphs(ds, 2), ds.param, "opt")
    orc.run_epochs(EPOCHS)
    got = log_parse.parse_party_log(log_root / setting / "gcn_test_tiny_0.log")
    want = orc.metrics  # party 0's, an epoch each
    assert len(want) == EPOCHS
    np.testing.assert_allclose(got["loss"], [w.loss for w in want],
                               atol=TOL[mpc])
    for key, line in METRIC_LINES[1:]:
        np.testing.assert_allclose(got["accuracy"][line],
                                   [getattr(w, key) for w in want],
                                   atol=TOL[mpc], err_msg=key)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: r[0])
def test_comm_counted_equals_analytic(tree, run):
    _, comm_root = tree
    setting, name, P, variant, mpc, epochs = run
    _, plan, param = engine_metrics(name, P, "opt_inference", False, 1)
    want = run_cluster.analytic_bytes_per_epoch(plan, param, variant, mpc,
                                                "bcsr")
    rounds = run_cluster.analytic_rounds_per_epoch(param, variant, mpc)
    for p in range(P):
        c = log_parse.parse_comm_file(comm_root / setting / f"{name}_{p}.comm")
        assert c["measured"] is True and c["mode"] == "sharded"
        assert c["backend"] == c["run_backend"] == "bcsr"
        assert c["per_epoch_bytes"] == c["analytic_per_epoch_bytes"] == want
        assert c["per_epoch_rounds"] == rounds
        assert want["total"] > 0 and want["all_to_all"] > 0
        assert (want["all_reduce"] > 0) == (not variant.endswith("inference"))
        assert math.isclose(c["sent_MB"], want["total"] * epochs / 1e6)


def test_graphsc_rows(tree):
    log_root, comm_root = tree
    for k in (2, 3):
        files = sorted((comm_root / f"graphsc_{k}s").glob("*.comm"))
        assert len(files) == k
        c = log_parse.parse_comm_file(files[0])
        assert c["model"] == "graphsc-analytic" and c["measured"] is False
    assert not (log_root / "graphsc_2s").exists()


def test_summary_equals_jax_summarizer(tree, tmp_path, monkeypatch):
    jax_sum = load_tool("jax_summarize_matrix",
                        ROOT / "tools/summarize_matrix.py")
    log_root, comm_root = tree
    rows = summarize_matrix.cells(log_root, comm_root)
    assert [(s, d) for s, d, _ in rows] == [
        ("mpc_opt_accuracy_2p", "tiny"), ("mpc_unopt_inference",
                                          "cora_small"),
        ("opt_accuracy_2p", "tiny"), ("opt_inference", "cora_small")]
    for setting, name, cell in rows:
        want = jax_sum.one_cell(log_root / setting, comm_root / setting, name)
        assert cell.keys() == want.keys()
        for k, v in cell.items():
            assert v == want[k] or (v != v and want[k] != want[k]), k
    out, jax_out = tmp_path / "port.md", tmp_path / "jax.md"
    assert summarize_matrix.main(["--log-root", str(log_root), "--comm-root",
                                  str(comm_root), "--out", str(out),
                                  "--device", "CPU (test)"]) == 0
    monkeypatch.setattr(sys, "argv", [
        "summarize_matrix.py", "--log-root", str(log_root), "--comm-root",
        str(comm_root), "--out", str(jax_out)])
    jax_sum.main()
    port_lines, jax_lines = (f.read_text().splitlines()
                             for f in (out, jax_out))
    start = port_lines.index(summarize_matrix.COLUMNS)
    assert port_lines[start:] == jax_lines[jax_lines.index(
        summarize_matrix.COLUMNS):]
    assert port_lines[0] == "# Evaluation matrix (CPU (test)) — summary"
    assert "TPU" not in "\n".join(port_lines[:start])


def test_make_dataset_is_the_tiny_graph():
    """The driver's tiny dataset is the oracle tests' graph."""
    src, dst, feats, labels = make_dataset(n=48, m=300, homophily=0.7)
    ds = tiny()
    np.testing.assert_array_equal(ds.src, src)
    np.testing.assert_array_equal(ds.features, feats)
