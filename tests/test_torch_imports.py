"""The port stands alone: no JAX and nothing of ``cognn_tpu``, of the JAX
tools (``tools/``) or of the JAX examples (``examples/``) in its imports,
and its entry points raise instead of falling back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "cognn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

torch.set_num_threads(1)


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "cognn_tpu", "tools",
                           "examples"), (path, mod)


def test_package_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cognn_tpu_torch\n"
        "for m in pkgutil.walk_packages(cognn_tpu_torch.__path__,"
        " 'cognn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'cognn_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_card():
    from cognn_tpu_torch.convert import mpc_state_from_jax, weights_from_jax
    from cognn_tpu_torch.engine import GasEngine, build_device_plan
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid
    from cognn_tpu_torch.mpc import MpcGasEngine

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    ds = synthetic_planetoid("cora_small")
    g = build_party_graph(ds.src, ds.dst, None, None, 0, 1)
    g.set_vertex_data(g.local_vids, ds.features[g.local_vids],
                      ds.labels[g.local_vids])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GasEngine(build_device_plan([g]), ds.param)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights_from_jax([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MpcGasEngine(build_device_plan([g]), ds.param)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpc_state_from_jax(None, [], None)


def test_slice3_entry_points_raise_without_card():
    from cognn_tpu_torch.ops.sddmm import Sddmm
    from cognn_tpu_torch.ops.spmm_merged import SpmmMerged
    from cognn_tpu_torch.tools import bench_spmm
    from cognn_tpu_torch.utils.timing import device_ms

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for make in (SpmmMerged, Sddmm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make([0], [1], 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_spmm.setup(64, 128, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_spmm.main(["--v", "64", "--e", "128"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_ms(lambda: None)
    with pytest.raises(ValueError, match="CUDA"):
        device_ms(lambda: None, device="cpu")  # no host-clock fallback


def test_party_processes_raise_without_card(tmp_path):
    """A CUDA party process and the CLI's --mode sharded raise before they
    join or start anything; a CPU party takes gloo."""
    from cognn_tpu_torch.harness.run_party import main
    from cognn_tpu_torch.utils import distributed

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_party_group(0, 2, "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mode", "sharded"] + [str(tmp_path / "absent")] * 5)
    assert distributed.choose_backend(2, "cpu") == "gloo"
    assert distributed.choose_backend(2, "cuda") == "gloo"  # no card here
    assert distributed.party_device(3, "cpu") == torch.device("cpu")


def test_scan_covers_every_subpackage():
    scanned = {p.parent.name for p in PORT_FILES}
    assert {"core", "mpc", "ops", "engine", "tools", "utils", "models",
            "graph", "harness", "examples"} <= scanned
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"cognn_tpu_torch/models/oracle.py",
            "cognn_tpu_torch/graph/native_io.py",
            "cognn_tpu_torch/tools/run_cluster.py",
            "cognn_tpu_torch/tools/log_parse.py",
            "cognn_tpu_torch/tools/summarize_matrix.py",
            "cognn_tpu_torch/tools/golden_runs.py",
            "cognn_tpu_torch/tools/profile_epoch.py",
            "cognn_tpu_torch/tools/network_model.py",
            "cognn_tpu_torch/tools/bench_scaling.py",
            "cognn_tpu_torch/tools/plot_message_passing_comm.py",
            "cognn_tpu_torch/tools/print_inter_edge_ratio.py",
            "cognn_tpu_torch/examples/__init__.py",
            "cognn_tpu_torch/examples/train_plaintext.py",
            "cognn_tpu_torch/examples/train_secret_shared.py",
            "cognn_tpu_torch/examples/analytics.py"} <= names


def test_oracle_imports_no_torch():
    """The float64 oracle is a host reference: importing it loads neither
    torch nor JAX."""
    code = ("import sys\n"
            "import cognn_tpu_torch.models.oracle\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('torch', 'jax', 'jaxlib', 'cognn_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_new_entry_points_raise_without_card(tmp_path):
    """The matrix driver, the golden runs, the experiment tools and the
    examples default to the card and raise without one, before any work."""
    from cognn_tpu_torch.examples import (analytics, train_plaintext,
                                          train_secret_shared)
    from cognn_tpu_torch.tools import (bench_scaling, golden_runs,
                                       network_model, profile_epoch,
                                       run_cluster)

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cluster.main(["--smallest-cognn-efficiency", "--log-root",
                          str(tmp_path / "log")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_runs.main(["--out", str(tmp_path / "g.json")])
    assert not (tmp_path / "log").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_epoch.main(["--dataset", "cora_small", "--outdir",
                            str(tmp_path / "trace")])
    assert not (tmp_path / "trace").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network_model.main(["--dataset", "cora_small", "--json",
                            str(tmp_path / "n.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scaling.main(["--dataset", "cora_small"])
    for example, argv in ((train_plaintext, ["--dataset", "cora_small"]),
                          (train_secret_shared, []), (analytics, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main(argv)
    assert not (tmp_path / "n.json").exists()
