"""Secret-shared graph analytics (port of ``cognn_tpu/mpc/analytics.py``):
pagerank, bfs, cc and sssp on additive shares, parties stacked.

The reference routes scalar vertex payloads with ADD and MIN combines through
its HE path (``task/task.h:11-32``, the ss-pagerank / ss-bfs / ss-cc /
ss-sssp builds). Here vertex state is a share pair ``[2, P, V]`` of the
ring's dtype (int64, or int32 under RING32), and

  * ADD (pagerank): ``Protocol.scale_rows`` by the encoded ``1/outdeg``, then
    the ring instantiation of the CSR gather-sum kernel
    (:meth:`cognn_tpu_torch.ops.spmm.Spmm.ring`) on the shares ``[2, P·V,
    1]`` over the flat (P·V)×(P·V) edge-count matrix, both shares in one
    launch; then ``scale_const(damping)`` and the public base;
  * MIN (bfs, sssp, cc): one segmented doubling min over the flat
    destination-sorted edge list
    (:func:`cognn_tpu_torch.engine.analytics.flat_edges`):
    ``ceil(log2(max in-degree))`` rounds of the shared elementwise min
    (``Protocol.less_mask`` / ``select``), each edge taking its successor
    ``2^k`` places on where both lead to the same destination; then each
    destination gathers its first edge, an empty one the identity share
    pair ``(SS_INF, 0)``. The JAX package does this per party over local and
    remote slots and combines the halo with P-way minima (``_MinPlan``,
    ``:71-109``).

Linear data movement never reconstructs. Under exact truncation ring sums
and minima do not depend on order or grouping, so the revealed values equal
the JAX package's bit for bit although the port groups the edges otherwise.
"Infinity" is the exact ring value ``SS_INF = 2^20`` (far above any hop
count, label or path length, below the ring's overflow bound at the
default fractional bits), so unreached vertices reveal to exactly SS_INF.

On the card a sweep is one replay of a CUDA graph (the JAX package's
``jax.jit`` of a sweep, ``:164``; :mod:`cognn_tpu_torch.engine.graphs`) on
the engine's shares in place, its generator registered with the graph;
``share`` and ``reveal`` run outside it. ``cuda_graphs=False`` runs the
sweeps eager, as the CPU always does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from cognn_tpu_torch.core.fixedpoint import fp_encode
from cognn_tpu_torch.core.ring import ring_from_u64
from cognn_tpu_torch.engine.analytics import flat_edges, global_out_degree
from cognn_tpu_torch.engine.gas import _build_spmm_stacked
from cognn_tpu_torch.engine.graphs import (
    EngineGraphs,
    kernel_counters,
    use_graphs,
)
from cognn_tpu_torch.engine.plan import DevicePlan
from cognn_tpu_torch.mpc.protocol import Protocol
from cognn_tpu_torch.utils.device import resolve_device

SS_INF = float(2.0 ** 20)  # share-space "infinity" (exact in fixed point)


class _MinPlan:
    """Static data of the segmented MIN over destination-sorted edges
    ``dst`` into ``num`` destinations."""

    def __init__(self, dst: np.ndarray, num: int, ident: torch.Tensor,
                 device):
        E = len(dst)
        longest = int(np.bincount(dst, minlength=1).max()) if E else 0
        self.rounds = math.ceil(math.log2(longest)) if longest > 1 else 0
        # same[k][i]: edge i + 2^k leads to edge i's destination
        self.same = [torch.as_tensor(
            np.concatenate([dst[1 << k:] == dst[:E - (1 << k)],
                            np.zeros(min(E, 1 << k), bool)]), device=device)
            for k in range(self.rounds)]
        first = np.full(num, E, np.int64)  # E: the appended identity
        np.minimum.at(first, dst, np.arange(E))
        self.first = torch.as_tensor(first, device=device)
        # share 0 carries the public identity, share 1 zero: [2, E + 1]
        self.ident = torch.stack([ident.expand(E + 1),
                                  torch.zeros_like(ident).expand(E + 1)])

    def reduce(self, proto: Protocol, sh: torch.Tensor) -> torch.Tensor:
        """sh [2, E] edge values -> [2, num] minima by destination."""
        cur = sh
        for k, same in enumerate(self.same):
            off = 1 << k
            cand = torch.cat([cur[:, off:], self.ident[:, :off]], dim=1)
            take = proto.less_mask(cand, cur) & same
            cur = proto.select(take, cand, cur)
        cur = torch.cat([cur, self.ident[:, :1]], dim=1)
        return cur[:, self.first]


class SSAnalyticsEngine:
    """Runs pagerank / bfs / cc / sssp on additive shares over a
    :class:`DevicePlan` (stacked parties). ``source``: the (party, index)
    of bfs and sssp; ``damping`` and ``num_vertices`` (default: the plan's
    vertices) of pagerank; ``proto``: the protocol (its fixed-point spec
    picks the ring); ``device`` "cuda" by default, raising when there is no
    card. ``spmm``: pagerank's CSR structure (None otherwise), whose
    ``ring_launches`` / ``ring32_launches`` count its kernel.
    ``cuda_graphs``: as :class:`cognn_tpu_torch.engine.analytics.
    AnalyticsEngine`'s (a sweep of :meth:`run` one CUDA graph replay on the
    card by default, eager on the CPU). The share randomness comes from one
    ``torch.Generator`` the engine owns, registered with the graph and
    re-seeded by every :meth:`run`."""

    def __init__(self, plan: DevicePlan, name: str, *,
                 source: Optional[Tuple[int, int]] = None,
                 damping: float = 0.85,
                 num_vertices: Optional[int] = None,
                 proto: Optional[Protocol] = None, device="cuda",
                 cuda_graphs: Optional[bool] = None):
        if name not in ("pagerank", "bfs", "cc", "sssp"):
            raise ValueError(f"unknown program {name!r}")
        if name in ("bfs", "sssp") and source is None:
            raise ValueError(f"{name} needs a source (party, index)")
        self.device = dev = resolve_device(device)
        self.plan, self.name = plan, name
        self.proto = proto or Protocol()
        self.combine = "add" if name == "pagerank" else "min"
        self.damping = damping
        self.source = source
        self.n_global = num_vertices or int(plan.num_local.sum())
        fp = self.proto.fp

        def encode(x):
            return ring_from_u64(fp_encode(x, fp), fp.ring, device=dev)

        self._vertex_mask = torch.as_tensor(plan.vertex_mask, device=dev)
        self.spmm = None
        if name == "pagerank":
            self.spmm = _build_spmm_stacked(plan, dev)
            od = global_out_degree(plan)
            recip = np.where(od > 0, 1.0 / np.maximum(od, 1.0), 0.0)
            self._recip_fp = encode(recip)  # [P, V]
            self._base_fp = encode((1.0 - damping) / self.n_global)
        else:
            src, dst, w = flat_edges(plan)
            self._src = torch.as_tensor(src, device=dev)
            self._min = _MinPlan(dst, plan.num_parties * plan.V,
                                 encode(SS_INF), dev)
            if name == "bfs":
                self._one_fp = encode(1.0)
            if name == "sssp":
                self._w_fp = encode(w)  # [E]
        self._gen = torch.Generator(device=dev)
        self._graphs = EngineGraphs(use_graphs(cuda_graphs, dev),
                                    kernel_counters(self.spmm), (self._gen,),
                                    dev)
        # the shares run() sweeps in place: the graph's static input
        self._h_sh = torch.empty((2, plan.num_parties, plan.V),
                                 dtype=self.proto.dtype, device=dev)

    # ------------------------------------------------------------------
    def init_values(self) -> np.ndarray:
        """Plaintext [P, V] initial values (as the plaintext programs, with
        SS_INF as the MIN identity)."""
        P, V = self.plan.num_parties, self.plan.V
        if self.name == "pagerank":
            return np.full((P, V), 1.0 / self.n_global, np.float32)
        if self.name == "cc":
            lab = np.tile(np.arange(V, dtype=np.float32), (P, 1))
            return (lab + np.arange(P)[:, None] * V).astype(np.float32)
        h = np.full((P, V), np.float32(SS_INF))
        sp, si = self.source
        h[sp, si] = 0.0
        return h

    def iteration(self, gen: torch.Generator,
                  h_sh: torch.Tensor) -> torch.Tensor:
        """One sweep of the shares ``h_sh`` [2, P, V] (randomness of the
        truncations from ``gen``)."""
        proto = self.proto
        _, P, V = h_sh.shape
        if self.name == "pagerank":
            msg = proto.scale_rows(gen, h_sh, self._recip_fp)
            agg = self.spmm.ring(msg.reshape(2, P * V, 1)).reshape(2, P, V)
            new = proto.scale_const(gen, agg, self.damping)
            new = proto.add_public(new, self._base_fp)
        else:
            msg = (proto.add_public(h_sh, self._one_fp)
                   if self.name == "bfs" else h_sh)
            vals = msg.reshape(2, P * V)[:, self._src]  # [2, E]
            if self.name == "sssp":
                vals = proto.add_public(vals, self._w_fp)
            agg = self._min.reduce(proto, vals).reshape(2, P, V)
            new = proto.minimum(h_sh, agg)
        return proto.select(self._vertex_mask, new, h_sh)

    def _sweep(self) -> None:
        """One sweep of the engine's shares in place."""
        self._h_sh.copy_(self.iteration(self._gen, self._h_sh))

    @torch.no_grad()
    def run(self, iters: int, seed: int = 0) -> torch.Tensor:
        """Share the initial values, run ``iters`` sweeps (share randomness
        from the engine's generator, seeded with ``seed``: the same words as
        a fresh generator's), and return the revealed f32 [P, V] values."""
        self._gen.manual_seed(seed)
        self._h_sh.copy_(self.proto.share(self._gen, torch.as_tensor(
            self.init_values(), device=self.device)))
        for _ in range(iters):
            self._graphs.run("sweep", self._sweep)
        return self.proto.reveal(self._h_sh)
