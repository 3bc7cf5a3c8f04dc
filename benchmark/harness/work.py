"""The yardstick's arithmetic, frozen here: the card's data-sheet peaks, the
GCN's own operations a request or an epoch, and the least time the two
kernels of the secret-shared path could take, counted from the
configuration's shapes (the rules of ``chip_smoke.py``'s
``ring_matmul_phase`` and ``ring_spmm_phase``), so that a roofline share
reads the same work whatever kernel implements it.

Shapes are the stacked layout's: P parties, ``V = ceil(n / P)`` rows a
party (the largest party's vertex count, before any padding of the
program's), the flat aggregation matrix ``P V x P V`` with one entry a
directed edge.
"""

from __future__ import annotations

import math
from typing import List, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
INT8_TC_OPS_PER_S = 1979e12
# byte-limb products of one multiply-add in K3 (ring_matmul.cu): 64-bit
# operands are 8 bytes a side, the products that land below bit 64 (36);
# 32-bit ones 10
LIMB_PAIRS = {64: 36, 32: 10}
# the ring SpMM's 32-bit multiplies a multiply-add on the IMAD pipe (the
# wide lo*lo and the two cross terms; 1 at 32 bits), at 64 IMAD a clock an
# SM (CUDA C++ Programming Guide, compute capability 9.0), 132 SMs, the
# 1980 MHz maximum SM clock
IMAD_PER_S = 64 * 132 * 1980e6
MULTIPLIES_PER_MAC = {64: 3, 32: 1}

Shape = Tuple[int, int, int, int]  # B, N, K, M


def dims_of(cfg: dict) -> List[int]:
    return ([cfg["input_dim"]] + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1)
            + [cfg["num_labels"]])


def rows_per_party(cfg: dict) -> int:
    return math.ceil(cfg["num_samples"] / cfg["parties"])


def k3_shapes(cfg: dict, unit: str) -> List[Shape]:
    """The share matmuls of a request (``unit`` "request": the L forward
    products) or an epoch ("epoch": those, the L - 1 products delta W^T and
    the L weight gradients h^T delta), stacked over the parties."""
    d, P, V = dims_of(cfg), cfg["parties"], rows_per_party(cfg)
    L = len(d) - 1
    shapes = [(P, V, d[l], d[l + 1]) for l in range(L)]
    if unit == "epoch":
        shapes += [(P, V, d[l + 1], d[l]) for l in range(L - 1, 0, -1)]
        shapes += [(P, d[l], V, d[l + 1]) for l in range(L - 1, -1, -1)]
    return shapes


def k3_bound_s(shape: Shape, bits: int) -> float:
    """The larger of A, B and C moved once at the memory rate and K3's
    byte-limb products at the int8 tensor-core rate."""
    B, N, K, M = shape
    e = bits // 8
    return max(e * (B * N * K + B * K * M + B * N * M) / HBM_BYTES_PER_S,
               2 * LIMB_PAIRS[bits] * B * N * K * M / INT8_TC_OPS_PER_S)


def aggregation_widths(cfg: dict, unit: str) -> List[int]:
    """Widths of the aggregations of a request (each layer's output) or an
    epoch (those, and the backward phases' at each layer's output width,
    but the phases that run Apply only)."""
    d = dims_of(cfg)
    L = len(d) - 1
    widths = list(d[1:])
    if unit == "epoch":
        for phase in range(L, 3 * L):
            if phase % L != 0:
                widths.append(d[L - 1 - (phase - L) // 2 + 1])
    return widths


def spmm_bound_s(cfg: dict, width: int, bits: int, shares: int = 2) -> float:
    """One ring SpMM over the flat matrix on both shares: the larger of
    its compulsory bytes (row pointers, an index and a count an entry, the
    rows in and out) at the memory rate and its multiply-adds on the IMAD
    pipe."""
    n = cfg["parties"] * rows_per_party(cfg)
    nnz, e = cfg["num_edges"], bits // 8
    nbytes = 4 * (n + 1) + (4 + e) * nnz + e * shares * 2 * n * width
    ops_s = shares * nnz * width * MULTIPLIES_PER_MAC[bits] / IMAD_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops_s)


def k3_bound_per_unit(cfg: dict, unit: str) -> float:
    return sum(k3_bound_s(s, cfg["ring_bits"]) for s in k3_shapes(cfg, unit))


def spmm_bound_per_unit(cfg: dict, unit: str) -> float:
    return sum(spmm_bound_s(cfg, w, cfg["ring_bits"])
               for w in aggregation_widths(cfg, unit))


def model_flops(cfg: dict, unit: str) -> float:
    """The plaintext GCN's own operations a request or an epoch, on the
    real vertices and edges: 2 N K M a matrix product, (E + n) w adds an
    aggregation of width w, n w an elementwise scale; softmax, ReLU and
    the metrics uncounted."""
    d = dims_of(cfg)
    L = len(d) - 1
    n, E = cfg["num_samples"], cfg["num_edges"]

    def agg(w):
        return (E + n) * w

    flops = 0.0
    for l in range(L):  # forward: matmul, source scale, aggregation, scale
        w = d[l + 1]
        flops += 2 * n * d[l] * w + (n * w if l else 0) + agg(w) + n * w
    if unit == "request":
        return flops
    for phase in range(L, 3 * L):
        l = L - 1 - (phase - L) // 2
        w = d[l + 1]
        if phase % L != 0:
            flops += n * w + agg(w) + (n * w if phase + 1 != 3 * L else 0)
        if (phase - L) % 2 == 0:
            if l != 0:
                flops += 2 * n * w * d[l]  # delta W^T
        else:
            flops += 2 * n * d[l] * w + 2 * d[l] * w  # gradient, SGD
    return flops
