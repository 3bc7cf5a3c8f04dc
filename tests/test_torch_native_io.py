"""The port's native graph reader (``csrc/graph_io.cpp`` through
``graph/native_io.py``) on the CPU: built by the host compiler at first use,
named by a hash of its source and flags; its arrays equal to the port's
numpy parse and to the JAX package's readers on the same files (``#``
comments, blank lines, a weight column and none); malformed rows and a wrong
``input_dim`` raise; ``-t 1`` and ``-t 4`` give equal arrays; without a
compiler, or with a compile that fails, it raises instead of falling back.
"""

import numpy as np
import pytest

from cognn_tpu.graph import io as jax_io
from cognn_tpu_torch.config import GNNParam, RunConfig
from cognn_tpu_torch.graph import io, native_io
from cognn_tpu_torch.harness.run_party import load_party_graphs
from cognn_tpu_torch.ops import _build

EDGE_FILES = {
    "weighted": "# a comment\n0 1 0.5\n\n1 2 2.0\n  2 0 1.5\n"
                "# another\n3 1 1\n",
    "plain": "0 1\n1 2\n\n2 0\n",
    "no final newline": "0 1\n\t1 2 # inline\n2 0",
    "crlf": "0 1 0.25\r\n1 2 4\r\n",
    "empty": "# nothing\n\n",
}
VERTEX_TEXT = ("# vid f0 f1 label\n0 0.5 1.0 2\n\n1 -1.25 0 0\n"
               "  2 3e-1 4 1\n# last\n")


@pytest.fixture(autouse=True)
def auto_threads():
    yield
    native_io.set_threads(0)


def assert_same(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.filterwarnings("ignore:loadtxt")
@pytest.mark.parametrize("name", EDGE_FILES)
def test_edge_list_equals_numpy_and_jax(tmp_path, name):
    path = tmp_path / "edges"
    path.write_text(EDGE_FILES[name])
    for undirected in (False, True):
        got = io.read_edge_list(path, 1.0, undirected)
        for plain in (io.read_edge_list_numpy, jax_io.read_edge_list):
            assert_same(got, plain(path, 1.0, undirected), name)
    src, _, w = io.read_edge_list(path, default_weight=2.5)
    if name == "plain":
        assert len(src) == 3 and (w == 2.5).all()


def test_vertex_file_equals_numpy_and_jax(tmp_path):
    path = tmp_path / "v"
    path.write_text(VERTEX_TEXT)
    got = io.read_vertex_file(path, 2)
    assert_same(got, io.read_vertex_file_numpy(path, 2), "numpy")
    assert_same(got, jax_io.read_vertex_file(path, 2), "jax")
    assert got[1].shape == (3, 2) and got[1][2, 0] == 0.3


@pytest.mark.parametrize("text", ["0 1\n1 x\n", "0 1\n7\n8 9\n",
                                  "0 1 w\n", "a b\n"],
                         ids=["no dst", "short row", "bad weight", "words"])
def test_malformed_edge_rows_raise(tmp_path, text):
    path = tmp_path / "edges"
    path.write_text(text)
    with pytest.raises(ValueError, match="malformed row"):
        io.read_edge_list(path)


def test_vertex_file_errors_raise(tmp_path):
    path = tmp_path / "v"
    path.write_text(VERTEX_TEXT)
    for reader in (io.read_vertex_file, io.read_vertex_file_numpy):
        with pytest.raises(ValueError, match="4 columns, expected 5"):
            reader(path, 3)
        with pytest.raises(ValueError, match="4 columns, expected 3"):
            reader(path, 1)
    path.write_text("0 0.5 1.0 2\n1 0.5 nan? 0\n")
    with pytest.raises(ValueError, match="malformed row"):
        io.read_vertex_file(path, 2)
    with pytest.raises(OSError):
        io.read_vertex_file(tmp_path / "absent", 2)


def test_thread_counts_give_equal_arrays(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 9000, 5  # above the auto pool's 4096-row threshold
    edges, verts = tmp_path / "e", tmp_path / "v"
    edges.write_text("".join(f"{a} {b} {float(w)!r}\n" for a, b, w in zip(
        rng.integers(0, n, n), rng.integers(0, n, n), rng.random(n))))
    io.write_vertex_file(verts, np.arange(n), rng.standard_normal((n, d)),
                         rng.integers(0, 7, n))
    out = {}
    for t in (1, 4, 0):
        native_io.set_threads(t)
        out[t] = (io.read_edge_list(edges), io.read_vertex_file(verts, d))
    for t in (4, 0):
        for got, want in zip(out[t], out[1]):
            assert_same(got, want, f"-t {t}")
    assert_same(out[1][0], io.read_edge_list_numpy(edges), "numpy edges")
    assert_same(out[1][1], io.read_vertex_file_numpy(verts, d),
                "numpy vertices")


def test_run_party_threads_flag(tmp_path):
    """``load_party_graphs`` applies ``-t`` > 0 and leaves 0 alone."""
    (tmp_path / "e").write_text("0 1\n1 0\n")
    (tmp_path / "v").write_text("0 1.0 0\n1 2.0 1\n")
    param = GNNParam(num_layers=2, num_labels=2, input_dim=1, hidden_dim=2,
                     num_samples=2, num_edges=2)
    for t, want in ((3, 3), (0, 3)):
        cfg = RunConfig(threads=t, tiles=1, edge_file=tmp_path / "e",
                        vertex_file=tmp_path / "v")
        graphs = load_party_graphs(cfg, param)
        assert native_io._threads == want
        assert graphs[0].num_local == 2


def test_library_named_by_source_hash():
    path = _build.lib_path("graph_io")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("graph_io-") and path.suffix == ".so"
    _build.build("graph_io")
    assert path.exists()
    assert _build.build("graph_io") == ""  # reused, not rebuilt
    assert _build.lib_path("graph_io") != _build.lib_path("spmm")


def test_no_compiler_raises(tmp_path, monkeypatch):
    path = tmp_path / "edges"
    path.write_text("0 1\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            io.read_edge_list(path)
        monkeypatch.delenv("CXX")
        monkeypatch.setattr(_build, "HOST_FLAGS",
                            _build.HOST_FLAGS + ("-include", "no_such.h"))
        with pytest.raises(RuntimeError,
                           match="(?s)failed for graph_io.cpp.*no_such.h"):
            io.read_vertex_file(path, 0)
        assert not (tmp_path / "build").exists() or not any(
            (tmp_path / "build").glob("*.so"))
    finally:
        _build.load.cache_clear()
