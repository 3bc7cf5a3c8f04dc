"""Graph file IO in the reference's text formats (port of
``cognn_tpu/graph/io.py``).

Formats (reference `include/graph_io_util.h:41-208`, `tools/data_transform.py`):

  * edge list   — ``<src> <dst> [weight]`` per line, ``#`` comments
  * vertex list — ``<vid> <f_0> ... <f_{D-1}> <label>`` per line
  * partition   — ``<vid> <tid>`` per line (tab or space separated)

:func:`read_edge_list` and :func:`read_vertex_file` parse with the native
C++ library (:mod:`cognn_tpu_torch.graph.native_io`, ``csrc/graph_io.cpp``,
built at first use; ``-t`` sizes its thread pool). The JAX package falls back
to numpy where its library is not built; the port raises instead. The numpy
parse stays as :func:`read_edge_list_numpy` and :func:`read_vertex_file_numpy`,
which return the same arrays: the plain versions the tests hold the native
reader to.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from cognn_tpu_torch.graph import native_io


def _effective_lines(path: Path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def _undirected(src, dst, w, undirected: bool):
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    return src, dst, w


def read_edge_list(path: str | Path, default_weight: float = 1.0,
                   undirected: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (src[E], dst[E], weight[E]), parsed natively. ``undirected``
    appends reverses (reference `graph_io_util.h:159-163`)."""
    return _undirected(*native_io.parse_edge_list(path, default_weight),
                       undirected)


def read_edge_list_numpy(path: str | Path, default_weight: float = 1.0,
                         undirected: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`read_edge_list` by ``np.loadtxt``, its plain version."""
    rows = np.loadtxt(path, dtype=np.float64, comments="#", ndmin=2)
    if rows.size == 0:
        src = dst = np.zeros(0, np.int64)
        w = np.zeros(0, np.float64)
    else:
        src = rows[:, 0].astype(np.int64)
        dst = rows[:, 1].astype(np.int64)
        w = (rows[:, 2] if rows.shape[1] > 2
             else np.full(len(src), default_weight))
    return _undirected(src, dst, w, undirected)


def read_vertex_file(path: str | Path, input_dim: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (vid[V], features[V, input_dim], label[V]), parsed natively
    (reference `harness.cpp:21-48` loadVertexData)."""
    return native_io.parse_vertex_file(path, input_dim)


def read_vertex_file_numpy(path: str | Path, input_dim: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`read_vertex_file` by ``np.loadtxt``, its plain version."""
    rows = np.loadtxt(path, dtype=np.float64, comments="#", ndmin=2)
    if rows.shape[1] != input_dim + 2:
        raise ValueError(
            f"vertex file {path} has {rows.shape[1]} columns, expected "
            f"{input_dim + 2} (vid + {input_dim} features + label)")
    return (rows[:, 0].astype(np.int64), rows[:, 1:-1].copy(),
            rows[:, -1].astype(np.int64))


def read_partition_file(path: str | Path, tile_count: int,
                        tile_merge_factor: int = 1) -> dict:
    """Returns {vid: tid} with the reference's tile-merge divide
    (`graph_io_util.h:67-87`)."""
    tid_map: dict = {}
    for line in _effective_lines(Path(path)):
        parts = line.split()
        vid, tid = int(parts[0]), int(parts[1]) // tile_merge_factor
        if tid >= tile_count:
            raise ValueError(f"tid {tid} out of range for {tile_count} tiles")
        if vid in tid_map:
            raise ValueError(f"duplicate vid {vid} in partition file")
        tid_map[vid] = tid
    return tid_map


def write_edge_list(path: str | Path, src, dst) -> None:
    np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d")


def write_vertex_file(path: str | Path, vid, features, label) -> None:
    d = features.shape[1]
    rows = np.concatenate([np.asarray(vid)[:, None], features,
                           np.asarray(label)[:, None]], axis=1)
    np.savetxt(path, rows, fmt="%d " + "%f " * d + "%d")


def write_partition_file(path: str | Path, vid_to_tid: dict) -> None:
    with open(path, "w") as f:
        for vid in sorted(vid_to_tid):
            f.write(f"{vid}\t{vid_to_tid[vid]}\n")
