"""ctypes bindings for the native graph parser (port of
``cognn_tpu/graph/native_io.py``).

The library is ``csrc/graph_io.cpp``, built by the host C++ compiler into
``cognn_tpu_torch/_build/`` at first use (:mod:`cognn_tpu_torch.ops._build`,
named by a hash of its source and flags). Where the JAX package falls back
to numpy when its library cannot be built, the port raises with the
compiler's output: :mod:`cognn_tpu_torch.graph.io` reads through this module
only, and keeps its numpy parse as a named plain function.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

_threads = 0  # the -t override, applied to the library at every call


def set_threads(n: int) -> None:
    """Cap the parser's thread pool (the harness's ``-t`` flag; reference
    `graph_io_util.h:118` 8-thread load pool). 0 = auto: one thread below
    4096 rows, else the host's cores up to 16."""
    global _threads
    _threads = int(n)


def _lib() -> ctypes.CDLL:
    """The built library with its signatures set and the thread cap
    applied; raises if it cannot be built."""
    from cognn_tpu_torch.ops import _build

    lib = _build.load("graph_io")
    lib.cognn_set_threads.restype = None
    lib.cognn_set_threads.argtypes = [ctypes.c_int64]
    lib.cognn_count_rows.restype = ctypes.c_int64
    lib.cognn_count_rows.argtypes = [ctypes.c_char_p]
    lib.cognn_parse_edge_list.restype = ctypes.c_int64
    lib.cognn_parse_edge_list.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double]
    lib.cognn_parse_vertex_file.restype = ctypes.c_int64
    lib.cognn_parse_vertex_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64)]
    lib.cognn_set_threads(_threads)
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _rows(lib, path: Path) -> int:
    n = lib.cognn_count_rows(str(path).encode())
    if n < 0:
        raise OSError(-n, f"cannot read {path}")
    return n


def parse_edge_list(path: str | Path, default_weight: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, weight) of ``<src> <dst> [weight]`` rows; raises
    ValueError on a row without two integers or with a weight that is no
    number."""
    lib, path = _lib(), Path(path)
    n = _rows(lib, path)
    src = np.empty(n, np.int64)
    dst = np.empty(n, np.int64)
    w = np.empty(n, np.float64)
    rows = lib.cognn_parse_edge_list(
        str(path).encode(), n, _ptr(src, ctypes.c_int64),
        _ptr(dst, ctypes.c_int64), _ptr(w, ctypes.c_double), default_weight)
    if rows < 0:
        raise ValueError(f"edge list {path}: malformed row (expected "
                         f"'<src> <dst> [weight]'; err {-rows})")
    return src[:rows], dst[:rows], w[:rows]


def parse_vertex_file(path: str | Path, input_dim: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(vid, features [V, input_dim], label) of ``<vid> <f_0> ...
    <f_{D-1}> <label>`` rows; raises ValueError on a row of another column
    count (naming it) or with a token that is no number."""
    lib, path = _lib(), Path(path)
    n = _rows(lib, path)
    vid = np.empty(n, np.int64)
    feat = np.empty((n, input_dim), np.float64)
    label = np.empty(n, np.int64)
    rows = lib.cognn_parse_vertex_file(
        str(path).encode(), n, input_dim, _ptr(vid, ctypes.c_int64),
        _ptr(feat, ctypes.c_double), _ptr(label, ctypes.c_int64))
    if rows < 0:
        want = input_dim + 2
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#") \
                    and len(line.split()) != want:
                raise ValueError(
                    f"vertex file {path} has {len(line.split())} columns, "
                    f"expected {want} (vid + {input_dim} features + label)")
        raise ValueError(f"vertex file {path}: malformed row (expected vid + "
                         f"{input_dim} features + label; err {-rows})")
    return vid[:rows], feat[:rows], label[:rows]
