"""No file of the benchmark imports JAX, jaxlib, flax or the JAX package,
and the reference imports nothing of the port either: each module's
top-level name (the part before the first dot) is compared whole, since
``cognn_tpu_torch`` begins with ``cognn_tpu``."""

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cognn_tpu"}
PORT = "cognn_tpu_torch"
FILES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(BENCH_DIR)) for p in FILES])
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_no_port():
    ref = sorted((BENCH_DIR / "reference").rglob("*.py"))
    assert ref
    for path in ref:
        names = top_level_imports(path)
        assert PORT not in names, path
        # the reference's own imports outside the standard library
        assert names <= {"__future__", "dataclasses", "typing", "numpy",
                         "torch", "benchmark"}, (path, names)
    harness_used = {"benchmark.harness.data"}
    for path in ref:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("benchmark.harness"):
                assert node.module in harness_used, (path, node.module)


def test_the_scan_sees_a_forbidden_name(tmp_path):
    """The scan itself: it finds ``jax`` and ``cognn_tpu`` and tells the
    port's name apart."""
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy\nfrom cognn_tpu.mpc import x\n"
                     "import cognn_tpu_torch\n")
    assert top_level_imports(probe) == {"jax", "cognn_tpu", PORT}
