"""The GAT cell's yardstick, frozen here: the least time that the two
kernels of the attention could take, an epoch or a request, counted from
the configuration's shapes at the card's data-sheet rates of
:mod:`benchmark.harness.work`, so that a roofline share reads the same
work whatever kernel implements it.

Shapes are the stacked layout's: P parties, ``V = ceil(n / P)`` rows a
party, the flat axis of ``P V`` rows; the attention's entries are every
directed edge and a self-loop a vertex (``num_edges + num_samples``).
Layer l has H heads of f features: the hidden layers ``heads`` of
``hidden_dim / heads``, the last ``output_heads`` of ``num_labels``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.harness.work import (HBM_BYTES_PER_S, IMAD_PER_S,
                                    MULTIPLIES_PER_MAC, rows_per_party)


def layer_heads(cfg: dict) -> List[Tuple[int, int]]:
    """(H, f) of each layer."""
    hidden = (cfg["heads"], cfg["hidden_dim"] // cfg["heads"])
    return [hidden] * (cfg["num_layers"] - 1) + [(cfg["output_heads"],
                                                  cfg["num_labels"])]


def entries(cfg: dict) -> int:
    return cfg["num_edges"] + cfg["num_samples"]


def wagg_bound_s(cfg: dict, heads: int, f: int) -> float:
    """One weighted ring SpMM over the flat rows: the larger of its
    compulsory bytes (the row pointers; an index and H weights an entry;
    the rows in and the rows out, H f wide) at the memory rate and its
    multiply-adds (an entry times H f) on the IMAD pipe."""
    bits = cfg["ring_bits"]
    n, nnz, e = cfg["parties"] * rows_per_party(cfg), entries(cfg), bits // 8
    nbytes = 4 * (n + 1) + (4 + e * heads) * nnz + e * 2 * n * heads * f
    ops_s = nnz * heads * f * MULTIPLIES_PER_MAC[bits] / IMAD_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops_s)


def sddmm_bound_s(cfg: dict, heads: int, f: int) -> float:
    """One ring multi-head SDDMM: the larger of its compulsory bytes (both
    operands' rows once, two indices an entry, H results an entry) at the
    memory rate and its multiply-adds on the IMAD pipe."""
    bits = cfg["ring_bits"]
    n, nnz, e = cfg["parties"] * rows_per_party(cfg), entries(cfg), bits // 8
    nbytes = e * 2 * n * heads * f + 8 * nnz + e * heads * nnz
    ops_s = nnz * heads * f * MULTIPLIES_PER_MAC[bits] / IMAD_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops_s)


def wagg_bound_per_unit(cfg: dict, unit: str) -> float:
    """A layer's forward aggregation, and in an epoch its transposed one."""
    per = 2 if unit == "epoch" else 1
    return per * sum(wagg_bound_s(cfg, h, f) for h, f in layer_heads(cfg))


def sddmm_bound_per_unit(cfg: dict, unit: str) -> float:
    """A layer's SDDMM an epoch; a request has none."""
    if unit != "epoch":
        return 0.0
    return sum(sddmm_bound_s(cfg, h, f) for h, f in layer_heads(cfg))


def share(bound_s: float, phase_us: Optional[float]) -> Optional[float]:
    """% of a phase's µs that the least time ``bound_s`` is; None where
    the phase was not read."""
    if not phase_us:
        return None
    return 100.0 * bound_s * 1e6 / phase_us
