"""Sparse adjacency structures for the SpMM kernels (counterpart of
``cognn_tpu/ops/bcsr.py``).

The JAX package tiles the edge-count matrix into dense 128x128 blocks for the
TPU's matrix unit; on a 0.1%-dense graph those blocks are mostly zeros. The
port keeps the same function, U = Aᵀ·H over an edge-count matrix A, but
stores A as destination-sorted CSR: one entry per distinct (src, dst) pair
with its multiplicity, so duplicate edges accumulate as in ``build_bcsr``.

The block-merged tensor-core SpMM (``csrc/spmm_merged.cu``) takes A as
16x16 tiles instead (:func:`build_tiles_by_dst`), at an edge fitted to
``mma.sync``, not to the TPU's 128x128 unit, each stored as its entries
only: the kernel expands a tile in shared memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class CsrMatrix:
    """Destination-sorted CSR of a [n_src, n_dst] edge-count matrix: the
    entries of destination d are ``indptr[d]:indptr[d+1]``, sources
    ascending."""

    indptr: np.ndarray  # int32[n_dst + 1]
    indices: np.ndarray  # int32[nnz] source row of each entry
    counts: np.ndarray  # f32[nnz] edge multiplicity of (src, dst)
    n_src: int
    n_dst: int

    @property
    def nnz(self) -> int:
        return len(self.indices)


TILE = 16  # tile edge: mma.m16n8k16's M and K; a position fits 8 bits


@dataclasses.dataclass
class TileMatrix:
    """The non-empty 16x16 tiles of a [n_src, n_dst] edge-count matrix,
    compressed to their entries: one entry per distinct (src, dst) pair,
    sorted by destination tile, then source tile, then position. The
    entries of destination tile t are ``dptr[t]:dptr[t+1]``; a tile is a
    run of entries with one source tile (``esrc // 16``). An entry is two
    32-bit words: ``entries`` holds the position ``(d % 16) * 16 + s % 16``
    (destination-major, the transpose of the JAX package's ``vals[k,
    src%128, dst%128]``) in bits 0-7 and the bf16 bits of the edge count
    (rounded to nearest even, as JAX's bf16 ``vals``) in bits 16-31;
    ``esrc`` holds its source row s.
    """

    dptr: np.ndarray  # int32[n_dst_tiles + 1]
    entries: np.ndarray  # int32[nnz] position | bf16(count) << 16
    esrc: np.ndarray  # int32[nnz] source row
    n_tiles: int
    n_src: int
    n_dst: int

    @property
    def nbytes(self) -> int:
        return self.dptr.nbytes + self.entries.nbytes + self.esrc.nbytes


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """uint32 bf16 bit patterns of finite f32 values, rounded to nearest
    even (``torch``'s f32 -> bf16 cast)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def edge_arrays(src, dst, n_src: int, n_dst: int):
    """Validated int64 edge arrays; indices must fit int32."""
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    if len(src) != len(dst):
        raise ValueError(f"{len(src)} sources but {len(dst)} destinations")
    if max(n_src, n_dst) > _INT32_MAX or len(src) > _INT32_MAX:
        raise ValueError("indices are int32; the graph is too large")
    if len(src) and (src.min() < 0 or src.max() >= n_src
                     or dst.min() < 0 or dst.max() >= n_dst):
        raise ValueError("edge endpoint out of range")
    return src, dst


def build_tiles_by_dst(src: np.ndarray, dst: np.ndarray, n_src: int,
                       n_dst: int) -> TileMatrix:
    """Edge list (duplicates accumulate into counts) -> compressed 16x16
    tiles of the edge-count matrix (counterpart of ``build_bcsr`` with the
    run grouping of ``PallasSpmmMerged``; the TPU grid's group size,
    supertiles, padding and coverage groups have no counterpart: a
    destination tile with no edge simply has no entry, and the kernel
    writes its rows zero). No dense tile is ever formed."""
    src, dst = edge_arrays(src, dst, n_src, n_dst)
    nst = max(-(-n_src // TILE), 1)
    ndt = -(-n_dst // TILE)
    area = TILE * TILE
    # one key per (tile, position in tile), tiles ordered by (dst, src) tile
    key = ((dst // TILE) * nst + src // TILE) * area \
        + (dst % TILE) * TILE + src % TILE
    pos, counts = np.unique(key, return_counts=True)
    tiles = pos // area
    dptr = np.zeros(ndt + 1, np.int64)
    np.cumsum(np.bincount(tiles // nst, minlength=ndt), out=dptr[1:])
    entries = (pos % area).astype(np.uint32) | (bf16_bits(counts) << 16)
    return TileMatrix(dptr=dptr.astype(np.int32),
                      entries=entries.view(np.int32),
                      esrc=(tiles % nst * TILE + pos % TILE).astype(np.int32),
                      n_tiles=len(np.unique(tiles)), n_src=n_src,
                      n_dst=n_dst)


def build_csr_by_dst(src: np.ndarray, dst: np.ndarray, n_src: int,
                     n_dst: int) -> CsrMatrix:
    """Edge list (duplicates accumulate into counts) -> destination CSR."""
    src, dst = edge_arrays(src, dst, n_src, n_dst)
    uniq, counts = np.unique(dst * max(n_src, 1) + src, return_counts=True)
    dst_u = uniq // max(n_src, 1)
    indptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(dst_u, minlength=n_dst), out=indptr[1:])
    return CsrMatrix(indptr=indptr.astype(np.int32),
                     indices=(uniq % max(n_src, 1)).astype(np.int32),
                     counts=counts.astype(np.float32),
                     n_src=n_src, n_dst=n_dst)


def reorder_for_locality(src: np.ndarray, dst: np.ndarray,
                         n: int) -> np.ndarray:
    """BFS-order permutation: perm[new] = old. Clusters neighborhoods into
    nearby indices (the reference keeps a ``reorderedIndex`` per vertex,
    `graph.h`)."""
    order = []
    seen = np.zeros(n, bool)
    adj: dict = {}
    for u, v in zip(src, dst):
        adj.setdefault(int(u), []).append(int(v))
    deg = np.bincount(src, minlength=n)
    for seed in np.argsort(-deg):
        if seen[seed]:
            continue
        stack = [int(seed)]
        seen[seed] = True
        while stack:
            u = stack.pop(0)
            order.append(u)
            for v in adj.get(u, ()):  # noqa: B905
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
    return np.array(order, np.int64)
