"""The port's experiment tools and examples on the CPU, against the JAX
package's (``tools/network_model.py``, ``tools/bench_scaling.py``,
``tools/plot/plot_message_passing_comm.py``,
``tools/plot/print_inter_edge_ratio.py``, ``examples/*.py``):

* ``network_model``: ``grid_markdown`` gives the JAX tool's text for the
  same (compute, bytes, rounds); the CLI with ``--compute-ms`` on
  ``cora_small`` 2p ``--mpc --faithful-unopt`` counts its bytes and rounds
  in two gloo party processes, equal to the closed forms (unopt without
  the hoist), and writes the JAX tool's JSON keys (the JAX tool run here,
  plaintext, with ``--compute-ms``);
* ``bench_scaling`` at P = 1, 2 (the second in two gloo party
  processes): JAX's JSON keys, ``edge_iters_per_s = epoch_layers x E /
  epoch_s``;
* the two printers print what the JAX tools print, for ``--dataset`` and
  for an edge file with partition files;
* each example runs 2 epochs, and the plaintext one's metrics lie within
  5e-4 of the JAX example's (tests/test_engine.py:43).
"""

import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from cognn_tpu_torch.engine import build_device_plan
from cognn_tpu_torch.engine.comm_model import (analytic_bytes_per_epoch,
                                               analytic_rounds_per_epoch)
from cognn_tpu_torch.examples import (analytics, train_plaintext,
                                      train_secret_shared)
from cognn_tpu_torch.harness.datasets import synthetic_planetoid, transform
from cognn_tpu_torch.tools import (bench_scaling, network_model,
                                   plot_message_passing_comm,
                                   print_inter_edge_ratio)
from cognn_tpu_torch.tools.run_cluster import build_graphs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PLAIN_TOL = 5e-4  # tests/test_engine.py:43
MPC_LOSS_TOL = 2e-2  # secret-shared vs plaintext, tests/test_mpc.py:90
# the JSON of each party-scaling point, tools/bench_scaling.py:86-87
SCALING_KEYS = {"parties", "epoch_s", "edge_iters_per_s", "speedup_vs_1"}


def load_tool(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_out(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def jax_out(mod, argv, monkeypatch) -> str:
    """Standard output of a JAX tool's ``main()``, which reads sys.argv."""
    monkeypatch.setattr(sys, "argv", ["tool"] + list(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


@pytest.fixture(scope="module")
def jax_network_model():
    return load_tool("jax_network_model", ROOT / "tools" / "network_model.py")


def test_grid_markdown_matches_jax(jax_network_model):
    for comp, b, r in ((6.2e-4, 156_440_000.0, 6.0), (1.5, 1234.0, 4.0),
                       (0.0123, 0.0, 0.0), (0.999, 9.9e9, 12.0)):
        assert network_model.grid_markdown("t", comp, b, r) == \
            jax_network_model.grid_markdown("t", comp, b, r)
    for x in (0.0, 1e-5, 0.5, 0.999999, 1.0, 12.3456):
        assert network_model.fmt_s(x) == jax_network_model.fmt_s(x)


def test_network_model_counts_and_keys(jax_network_model, tmp_path,
                                       monkeypatch):
    out = tmp_path / "port.json"
    text = port_out(network_model.main, [
        "--dataset", "cora_small", "--parties", "2", "--mpc", "--variants",
        "opt,unopt", "--faithful-unopt", "--compute-ms", "opt=1.5,unopt=2.5",
        "--device", "cpu", "--json", str(out)])
    assert text.count("comm counted in 2 gloo party processes") == 2
    assert text.count("; faithful schedule]") == 1
    assert "### graphsc analytic (comparison): " in text
    port = json.loads(out.read_text())
    ds = synthetic_planetoid("cora_small")
    plan = build_device_plan(build_graphs(ds, 2))
    for variant, g in port["grids"].items():
        hoist = variant == "opt"  # --faithful-unopt: unopt not hoisted
        assert g["compute_src"] == "provided"
        assert g["bytes_per_epoch"] == analytic_bytes_per_epoch(
            plan, ds.param, variant, mpc=True, aggregation=g["backend"],
            hoist_agg=hoist)
        assert g["rounds_per_epoch"] == analytic_rounds_per_epoch(
            ds.param, variant, mpc=True, hoist_agg=hoist)
        assert g["bytes_per_epoch"]["total"] > 0
    # the f-wide layer-0 halo ships every epoch without the hoist
    assert port["grids"]["unopt"]["rounds_per_epoch"]["all_to_all"] == \
        analytic_rounds_per_epoch(ds.param, "unopt", mpc=True,
                                  hoist_agg=True)["all_to_all"] + 1
    assert port["grids"]["opt"]["compute_s"] == 1.5e-3

    theirs = tmp_path / "jax.json"
    jax_out(jax_network_model, [
        "--dataset", "cora_small", "--parties", "2", "--variants", "opt",
        "--compute-ms", "opt=1.5", "--json", str(theirs)], monkeypatch)
    ref = json.loads(theirs.read_text())
    assert set(port) == set(ref)
    assert set(port["grids"]["opt"]) == set(ref["grids"]["opt"])
    assert set(port["grids"]["opt"]["durations"]) == \
        set(ref["grids"]["opt"]["durations"])
    assert port["graphsc_analytic_bytes"] == ref["graphsc_analytic_bytes"]


def test_bench_scaling_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    text = port_out(bench_scaling.main, [
        "--dataset", "cora_small", "--parties", "1", "2", "--epochs", "1",
        "--device", "cpu"])
    rows = json.loads(text.strip().splitlines()[-1])
    assert [r["parties"] for r in rows] == [1, 2]
    assert "NOTE: 2 party processes on the CPU" in text
    ds = synthetic_planetoid("cora_small")
    layers = 3 * ds.param.num_layers  # GasEngine("opt").epoch_layers
    for r in rows:
        assert set(r) == SCALING_KEYS
        assert r["epoch_s"] > 0
        assert r["edge_iters_per_s"] == pytest.approx(
            layers * len(ds.src) / r["epoch_s"], rel=1e-12)
    assert rows[0]["speedup_vs_1"] == 1.0
    assert rows[1]["speedup_vs_1"] == pytest.approx(
        rows[1]["edge_iters_per_s"] / rows[0]["edge_iters_per_s"])


@pytest.mark.parametrize("dataset,parties", [("cora_small", 2),
                                             ("cora", 3)])
def test_message_passing_rows_match_jax(dataset, parties, monkeypatch):
    jax_mod = load_tool("jax_plot_message_passing_comm", ROOT / "tools"
                        / "plot" / "plot_message_passing_comm.py")
    argv = ["--dataset", dataset, "--parties", str(parties)]
    assert port_out(plot_message_passing_comm.main, argv) == \
        jax_out(jax_mod, argv, monkeypatch)


def test_inter_edge_ratios_match_jax(tmp_path, monkeypatch):
    jax_mod = load_tool("jax_print_inter_edge_ratio", ROOT / "tools" / "plot"
                        / "print_inter_edge_ratio.py")
    for argv in (["--dataset", "cora"],
                 ["--dataset", "cora_small", "--parties", "2", "7"]):
        assert port_out(print_inter_edge_ratio.main, argv) == \
            jax_out(jax_mod, argv, monkeypatch)
    out = transform(synthetic_planetoid("cora_small"), tmp_path,
                    partitions=(2, 3, 5))
    argv = ["--edge-file", str(out / "cora_small.edge.preprocessed"),
            "--part-file"] + [str(out / f"cora_small.part.preprocessed.{p}p")
                              for p in (2, 3, 5)]
    text = port_out(print_inter_edge_ratio.main, argv)
    assert text == jax_out(jax_mod, argv, monkeypatch)
    assert len(text.splitlines()) == 3


NUMBER = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")


def test_example_train_plaintext_matches_jax(monkeypatch):
    jax_mod = load_tool("jax_example_train_plaintext",
                        ROOT / "examples" / "train_plaintext.py")
    argv = ["--epochs", "2", "--dataset", "cora_small", "--parties", "2"]
    ours = port_out(train_plaintext.main, argv + ["--device", "cpu"])
    theirs = jax_out(jax_mod, argv, monkeypatch)
    assert ours.startswith("epoch   1: loss=")
    ours_n = [float(x) for x in NUMBER.findall(ours)]
    theirs_n = [float(x) for x in NUMBER.findall(theirs)]
    assert len(ours_n) == len(theirs_n) == 4
    assert ours_n == pytest.approx(theirs_n, abs=PLAIN_TOL)


def test_example_train_secret_shared():
    text = port_out(train_secret_shared.main, ["--epochs", "2", "--device",
                                               "cpu"])
    losses = [float(line.split("loss=")[1].split()[0])
              for line in text.splitlines() if "loss=" in line]
    assert len(losses) == 2
    assert abs(losses[0] - losses[1]) <= MPC_LOSS_TOL
    assert "reconstructed weight:" in text


def test_example_analytics():
    text = port_out(analytics.main, ["--device", "cpu"])
    assert "secret-shared BFS == plaintext BFS: True" in text
    assert text.startswith("pagerank top-5 (party*V + idx): [")
    err = float(text.split("max |err| vs plaintext: ")[1])
    assert err < 2e-3  # tests/test_mpc_analytics.py's pagerank tolerance
