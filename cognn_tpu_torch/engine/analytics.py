"""Vertex-centric graph analytics over the partitioned plan (port of
``cognn_tpu/engine/analytics.py``).

The reference engine is a general vertex-centric graph-analytics framework,
not GCN-only; this module runs its algorithm family on the same partitioned
plan, parties stacked: pagerank (damped), bfs (hop counts), cc (label
propagation by min) and sssp (min-plus with edge weights). Each iteration
scatters a value along the edges, combines it per destination (ADD or MIN),
applies the program and keeps the old value on padding rows
(``where(vertex_mask, new, h)``).

The JAX package combines per party over the local and remote slots, ships
the mirror rows through the halo and scatters them (``:95-124``). The port
combines over ALL real edges of the plan at once, the halo being part of the
structure:

  * ADD (pagerank): the program's scatter is taken per source vertex (``x =
    h / max(outdeg, 1)``; an ADD program's scatter must not read the edge
    weight), then ``Aᵀ·x`` at D = 1 by the CSR gather-sum kernel
    (:class:`cognn_tpu_torch.ops.spmm.Spmm`) over the flat (P·V)×(P·V)
    edge-count matrix of :func:`cognn_tpu_torch.engine.gas.
    _build_spmm_stacked`; the same function as JAX's slot segment sums, in
    another order of f32 sums;
  * MIN (bfs, sssp, cc): plain PyTorch, ``scatter_reduce_(..., "amin")``
    with identity :data:`INF` over a flat destination-sorted edge list
    ``(src, dst, w)`` (:func:`flat_edges`; not the CSR, which merges
    duplicate edges into counts and would merge their sssp weights). The
    JAX package has no Pallas kernel for it. Minima do not depend on order,
    so these programs equal JAX's exactly.

``tol`` stops early when ``max |h' - h|`` (read on the host) is at most it.

On the card a sweep is one replay of a CUDA graph (the JAX package's
``jax.jit`` of a sweep, ``:75``; :mod:`cognn_tpu_torch.engine.graphs`):
:meth:`AnalyticsEngine.run` writes each sweep into the values in place, the
graph's static input, and with ``tol`` the graph also leaves the sweep's
largest change on the device for the host's read, which stays outside it.
``cuda_graphs=False`` runs the sweeps eager, as the CPU always does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from cognn_tpu_torch.engine.gas import _build_spmm_stacked, _party_edges
from cognn_tpu_torch.engine.graphs import (
    EngineGraphs,
    kernel_counters,
    use_graphs,
)
from cognn_tpu_torch.engine.plan import DevicePlan
from cognn_tpu_torch.utils.device import resolve_device

INF = float(np.float32(3.0e38))


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """GAS hooks for a scalar vertex value (reference
    `vertex_centric_algo_kernel.h:33-80` scatter/gather surface)."""

    name: str
    combine: str  # "add" | "min"
    # scatter(src_val, edge_weight, out_deg_of_src) -> edge update value
    scatter: Callable
    # apply(old_val, combined, has_update_mask, aux) -> new_val
    apply: Callable
    init: Callable  # (plan, aux) -> [P, V] initial values (numpy)
    identity: float  # combine identity for destinations with no update


def global_out_degree(plan: DevicePlan) -> np.ndarray:
    """f32 [P, V]: each vertex's global out-degree, counted over the plan's
    real local and remote slots (``cognn_tpu/engine/analytics.py:84-93``)."""
    out = np.zeros((plan.num_parties, plan.V), np.float32)
    for i in range(plan.num_parties):
        np.add.at(out[i], plan.loc_src[i][plan.loc_valid[i]], 1.0)
        np.add.at(out[i], plan.rem_src[i][plan.rem_valid[i]], 1.0)
    return out


def flat_edges(plan: DevicePlan):
    """Every real edge of the plan over the flat (party, vertex) axis, as
    numpy ``(src int64, dst int64, w f32)`` sorted by destination (stable):
    a vertex (p, i) is ``p·V + i``. Duplicate edges stay separate."""
    V = plan.V
    parts = [_party_edges(plan, p, weights=True)
             for p in range(plan.num_parties)]
    src = np.concatenate([p * V + s for p, (s, _, _) in enumerate(parts)])
    dst = np.concatenate([d for _, d, _ in parts])
    w = np.concatenate([w for _, _, w in parts])
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order], w[order]


class AnalyticsEngine:
    """Runs a :class:`VertexProgram` over a :class:`DevicePlan` (stacked
    parties) on ``device`` ("cuda" by default; raises when there is no
    card). ``spmm``: the ADD combine's CSR structure (None for MIN
    programs), whose ``launches`` count its kernel. ``cuda_graphs``: as the
    GCN engines' (:func:`cognn_tpu_torch.engine.graphs.use_graphs`): by
    default each sweep of :meth:`run` replays one CUDA graph on the card
    and runs eager on the CPU; ``True`` raises on the CPU."""

    def __init__(self, plan: DevicePlan, program: VertexProgram,
                 aux: Optional[dict] = None, device="cuda",
                 cuda_graphs: Optional[bool] = None):
        if program.combine not in ("add", "min"):
            raise ValueError(f"combine {program.combine!r} (add or min)")
        self.device = resolve_device(device)
        self.plan = plan
        self.program = program
        self.aux = aux or {}
        dev = self.device
        self._vertex_mask = torch.as_tensor(plan.vertex_mask, device=dev)
        self._out_deg = torch.as_tensor(global_out_degree(plan), device=dev)
        self.spmm = None
        if program.combine == "add":
            self.spmm = _build_spmm_stacked(plan, dev)
        else:
            src, dst, w = flat_edges(plan)
            self._src = torch.as_tensor(src, device=dev)
            self._dst = torch.as_tensor(dst, device=dev)
            self._w = torch.as_tensor(w, device=dev)
        self._graphs = EngineGraphs(use_graphs(cuda_graphs, dev),
                                    kernel_counters(self.spmm), device=dev)
        # the values run() sweeps in place: the graphs' static input
        self._h = torch.empty((plan.num_parties, plan.V), dtype=torch.float32,
                              device=dev)

    def _combine(self, h: torch.Tensor) -> torch.Tensor:
        """[P, V] values -> [P, V] combined updates (identity where a
        destination has none)."""
        prog = self.program
        P, V = h.shape
        if self.spmm is not None:
            x = prog.scatter(h, None, self._out_deg)  # per source vertex
            return self.spmm(x.reshape(P * V, 1).contiguous()).reshape(P, V)
        hf, od = h.reshape(-1), self._out_deg.reshape(-1)
        vals = prog.scatter(hf[self._src], self._w, od[self._src])
        agg = torch.full((P * V,), prog.identity, dtype=h.dtype,
                         device=h.device)
        return agg.scatter_reduce_(0, self._dst, vals, "amin").reshape(P, V)

    def iteration(self, h: torch.Tensor) -> torch.Tensor:
        """One scatter / combine / apply sweep of the f32 values ``h``
        [P, V]."""
        prog = self.program
        agg = self._combine(h)
        has = agg != 0 if prog.combine == "add" else agg < prog.identity / 2
        new = prog.apply(h, agg, has, self.aux)
        return torch.where(self._vertex_mask, new, h)

    def _sweep(self, tol: float) -> Optional[torch.Tensor]:
        """One sweep of the values in place; with ``tol`` > 0 returns its
        largest change (on the device)."""
        nh = self.iteration(self._h)
        change = (nh - self._h).abs().max() if tol > 0.0 else None
        self._h.copy_(nh)
        return change

    @torch.no_grad()
    def run(self, iters: int, h0=None, tol: float = 0.0) -> torch.Tensor:
        """``iters`` sweeps from the program's initial values (or ``h0``);
        stops after the first whose largest change is at most ``tol``, when
        ``tol`` > 0. Returns the f32 [P, V] values."""
        self._h.copy_(torch.as_tensor(
            self.program.init(self.plan, self.aux) if h0 is None else h0,
            dtype=torch.float32))
        step = "sweep tol" if tol > 0.0 else "sweep"
        for _ in range(iters):
            change = self._graphs.run(step, lambda: self._sweep(tol))
            if change is not None and float(change) <= tol:
                break
        return self._h.clone()


# ---------------------------------------------------------------------------
# Programs (upstream GraphGASLite app semantics)
# ---------------------------------------------------------------------------


def _source_init(source_vid_flat):
    def init(plan, aux):
        h = np.full((plan.num_parties, plan.V), np.float32(INF))
        p, i = source_vid_flat
        h[p, i] = 0.0
        return h
    return init


def pagerank_program(damping: float = 0.85, num_vertices: int = 1):
    """Damped pagerank with x_u / outdeg_u contributions (the upstream
    GraphGASLite pagerank app semantics)."""
    return VertexProgram(
        name="pagerank",
        combine="add",
        scatter=lambda src_val, w, od: src_val / torch.clamp(od, min=1.0),
        apply=lambda old, agg, has, aux: (
            (1.0 - damping) / num_vertices + damping * agg),
        init=lambda plan, aux: np.full((plan.num_parties, plan.V),
                                       1.0 / num_vertices, np.float32),
        identity=0.0,
    )


def bfs_program(source_vid_flat):
    """Hop distance from a source (plan-local flat index (party, idx))."""
    return VertexProgram(
        name="bfs",
        combine="min",
        scatter=lambda src_val, w, out_deg: src_val + 1.0,
        apply=lambda old, agg, has, aux: torch.minimum(old, agg),
        init=_source_init(source_vid_flat),
        identity=INF,
    )


def sssp_program(source_vid_flat):
    """Shortest weighted path length from a source (min-plus)."""
    return VertexProgram(
        name="sssp",
        combine="min",
        scatter=lambda src_val, w, out_deg: src_val + w,
        apply=lambda old, agg, has, aux: torch.minimum(old, agg),
        init=_source_init(source_vid_flat),
        identity=INF,
    )


def cc_program():
    """Connected components by min-label propagation (undirected input)."""

    def init(plan, aux):
        lab = np.tile(np.arange(plan.V, dtype=np.float32),
                      (plan.num_parties, 1))
        # globally unique labels: party-major
        lab = lab + np.arange(plan.num_parties)[:, None] * plan.V
        return lab.astype(np.float32)

    return VertexProgram(
        name="cc",
        combine="min",
        scatter=lambda src_val, w, out_deg: src_val,
        apply=lambda old, agg, has, aux: torch.minimum(old, agg),
        init=init,
        identity=INF,
    )
