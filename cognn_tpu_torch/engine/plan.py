"""Device plan: PartyGraph(s) -> static, padded, stacked index arrays
(port of ``cognn_tpu/engine/plan.py``; the arrays are numpy, built exactly as
the JAX package builds them, and :func:`plan_tensors` moves them to a torch
device).

The replacement for the reference's oblivious-mapper preprocessing
(`ss_vertex_centric_algo_kernel.h:279-613`): after partitioning, every
gather/scatter/aggregation route is data-independent, so it becomes a fixed
index plan. Shapes depend only on padded sizes, never on values.

Layout (P parties stacked on a leading axis; every per-party dimension padded
to the max over parties so the stack is rectangular):

  * ``V`` = max local vertex count; rows past a party's ``num_local`` are
    invalid (``vertex_mask`` False) and forced to zero contribution.
  * local aggregation: ``loc_src``/``loc_seg`` [P, E_loc] slots (segment =
    local vertex index), padded slots route to a trash segment V.
  * halo exchange: remote slots are segment-summed into a [P, P, M, D] send
    buffer (dst-party major), exchanged along the party axis, then
    scatter-added via ``recv_target`` [P, P, M] into local order under
    ``recv_mask``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from cognn_tpu_torch.graph.partition import PartyGraph
from cognn_tpu_torch.ops.bcsr import reorder_for_locality


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if n > 0 else m


@dataclasses.dataclass(kw_only=True)
class DevicePlan:
    """Static index plan for P stacked parties (numpy)."""

    num_parties: int
    V: int  # padded local vertex count (same for all parties)
    E_loc: int  # padded local edge-slot count
    M: int  # padded per-peer mirror count
    num_local: np.ndarray  # int32[P] true local vertex counts
    vertex_mask: np.ndarray  # bool[P, V]
    # train/val/test membership masks. The split is POSITIONAL in the
    # ascending-vid local order (gcn.h:561-563); with vertex reordering the
    # split follows the vertices, so masks (not slices) carry it.
    train_mask: np.ndarray = None  # bool[P, V]
    val_mask: np.ndarray = None  # bool[P, V]
    # vertex_order[p, new_idx] = original ascending-vid local index (identity
    # unless reorder=True)
    vertex_order: np.ndarray = None  # int32[P, V]
    in_deg: np.ndarray  # f32[P, V] global in-degree (0 on padding)
    border: np.ndarray  # bool[P, V]
    labels: np.ndarray  # int32[P, V]
    train_n: np.ndarray  # int32[P]
    val_n: np.ndarray  # int32[P]
    # local aggregation slots
    loc_src: np.ndarray  # int32[P, E_loc] source local index
    loc_seg: np.ndarray  # int32[P, E_loc] segment (== V for trash)
    loc_valid: np.ndarray  # bool[P, E_loc] real (non-dummy, non-pad) slot
    loc_weight: np.ndarray = None  # f32[P, E_loc] edge weights (analytics)
    # remote send: slots grouped by destination party
    rem_src: np.ndarray  # int32[P, E_rem]
    rem_seg: np.ndarray  # int32[P, E_rem] -> dst_party * M + mirror_idx
    rem_valid: np.ndarray  # bool[P, E_rem]
    rem_weight: np.ndarray = None  # f32[P, E_rem]
    # remote receive: mirror rows -> local vertex index
    recv_target: np.ndarray  # int32[P, P, M]  [me, from_party, mirror]
    recv_mask: np.ndarray  # bool[P, P, M]
    # gather row masks (isGatherDstVertexDummy inverse), incl. self row i==j
    gather_ok: np.ndarray  # bool[P, P, V]   [me, from_party, vertex]

    features: np.ndarray = None  # f32[P, V, D] (pre-normalized at load)


def build_device_plan(graphs: List[PartyGraph], *, lane: int = 8,
                      reorder: bool = False) -> DevicePlan:
    """``lane`` rounds padded dims up.

    ``reorder``: BFS-reorder each party's local vertices for aggregation
    locality (the reference's reorderedIndex, `graph.h`); semantics are
    unchanged — the train/val/test split and metrics follow the vertices via
    masks."""
    P = len(graphs)
    V = round_up(max(g.num_local for g in graphs), lane)
    E_loc = round_up(max(g.blocks[g.tile_index].num_slots for g in graphs),
                     lane)
    E_rem = round_up(max(
        sum(b.num_slots for b in g.blocks if b.dst_tile != g.tile_index)
        for g in graphs) or 1, lane)
    M = round_up(max([1] + [
        len(b.mirror_vids) for g in graphs for b in g.blocks
        if b.mirror_vids is not None]), lane)

    num_local = np.array([g.num_local for g in graphs], np.int32)
    vertex_mask = np.zeros((P, V), bool)
    in_deg = np.zeros((P, V), np.float32)
    border = np.zeros((P, V), bool)
    labels = np.zeros((P, V), np.int32)
    loc_src = np.zeros((P, E_loc), np.int32)
    loc_seg = np.full((P, E_loc), V, np.int32)
    loc_valid = np.zeros((P, E_loc), bool)
    loc_weight = np.zeros((P, E_loc), np.float32)
    rem_src = np.zeros((P, E_rem), np.int32)
    rem_seg = np.full((P, E_rem), P * M, np.int32)
    rem_valid = np.zeros((P, E_rem), bool)
    rem_weight = np.zeros((P, E_rem), np.float32)
    recv_target = np.zeros((P, P, M), np.int32)
    recv_mask = np.zeros((P, P, M), bool)
    gather_ok = np.zeros((P, P, V), bool)
    feats = None

    for p, g in enumerate(graphs):
        n = g.num_local
        vertex_mask[p, :n] = True
        in_deg[p, :n] = g.in_deg
        border[p, :n] = g.border
        if g.labels is not None:
            labels[p, :n] = g.labels
        if g.features is not None:
            if feats is None:
                D = g.features.shape[1]
                feats = np.zeros((P, V, D), np.float32)
            # load-time normalization (optimize-gcn/gcn.h:823-833)
            feats[p, :n] = (g.features * np.power(
                g.in_deg.astype(np.float64) + 1.0, -0.5)[:, None]
            ).astype(np.float32)

        lb = g.blocks[g.tile_index]
        k = lb.num_slots
        loc_src[p, :k] = lb.src_local
        loc_seg[p, :k] = lb.seg_id
        loc_valid[p, :k] = ~lb.dummy
        loc_weight[p, :k] = lb.weight

        off = 0
        for b in g.blocks:
            if b.dst_tile == g.tile_index:
                continue
            k = b.num_slots
            rem_src[p, off:off + k] = b.src_local
            rem_seg[p, off:off + k] = b.dst_tile * M + b.seg_id
            rem_valid[p, off:off + k] = ~b.dummy
            rem_weight[p, off:off + k] = b.weight
            off += k

        for i in range(P):
            tgt = g.recv_target_local[i]
            m = len(tgt)
            if i == p:
                # self row: always added (base value path handles it)
                gather_ok[p, i, :n] = ~g.gather_dummy[i]
                continue
            recv_target[p, i, :m] = tgt
            recv_mask[p, i, :m] = True
            gather_ok[p, i, :n] = ~g.gather_dummy[i]

    vertex_order = np.tile(np.arange(V, dtype=np.int32), (P, 1))
    if reorder:
        for p, g in enumerate(graphs):
            n = g.num_local
            real = loc_valid[p]
            order = reorder_for_locality(loc_src[p][real],
                                         loc_seg[p][real], n)
            vertex_order[p, :n] = order
            inv = np.empty(n, np.int32)
            inv[order] = np.arange(n, dtype=np.int32)
            # per-vertex arrays follow the permutation
            for a in (in_deg, border, labels):
                a[p, :n] = a[p, :n][order]
            if feats is not None:
                feats[p, :n] = feats[p, :n][order]
            gather_ok[p, :, :n] = gather_ok[p, :, :n][:, order]

            # index plans are remapped old->new
            def remap(vals, limit):
                sel = vals < limit
                vals[sel] = inv[vals[sel]]

            remap(loc_src[p], n)
            remap(loc_seg[p], n)  # real segments are < n; padding stays V
            remap(rem_src[p], n)
            for i in range(P):
                remap(recv_target[p, i], n)
            # keep local slots destination-sorted for the segment sum
            resort = np.argsort(loc_seg[p], kind="stable")
            loc_src[p] = loc_src[p][resort]
            loc_seg[p] = loc_seg[p][resort]
            loc_valid[p] = loc_valid[p][resort]
            loc_weight[p] = loc_weight[p][resort]

    train_n = np.array([g.num_local for g in graphs], np.int32)  # placeholder
    val_n = np.zeros(P, np.int32)
    return DevicePlan(
        num_parties=P, V=V, E_loc=E_loc, M=M,
        num_local=num_local, vertex_mask=vertex_mask, in_deg=in_deg,
        border=border, labels=labels, train_n=train_n, val_n=val_n,
        loc_src=loc_src, loc_seg=loc_seg, loc_valid=loc_valid,
        loc_weight=loc_weight,
        rem_src=rem_src, rem_seg=rem_seg, rem_valid=rem_valid,
        rem_weight=rem_weight,
        recv_target=recv_target, recv_mask=recv_mask, gather_ok=gather_ok,
        features=feats, vertex_order=vertex_order,
    )


def set_split(plan: DevicePlan, train_ratio: float, val_ratio: float) -> None:
    """Split sizes + membership masks per party. The split is positional in
    the ORIGINAL ascending-vid local order (gcn.h:561-563 truncating casts);
    masks translate it through any vertex reordering."""
    plan.train_n = (plan.num_local * train_ratio).astype(np.int32)
    plan.val_n = (plan.num_local * val_ratio).astype(np.int32)
    orig_pos = plan.vertex_order  # [P, V] new_idx -> original position
    plan.train_mask = ((orig_pos < plan.train_n[:, None])
                       & plan.vertex_mask)
    plan.val_mask = ((orig_pos >= plan.train_n[:, None])
                     & (orig_pos < (plan.train_n + plan.val_n)[:, None])
                     & plan.vertex_mask)


def plan_tensors(plan: DevicePlan,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Every array field of ``plan`` as a tensor on ``device``: floats as
    float32, integers as int64 (torch's index type), masks as bool."""
    out = {}
    for f in dataclasses.fields(plan):
        a = getattr(plan, f.name)
        if not isinstance(a, np.ndarray):
            continue
        if a.dtype == np.bool_:
            t = torch.as_tensor(a)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.as_tensor(a, dtype=torch.int64)
        else:
            t = torch.as_tensor(a, dtype=torch.float32)
        out[f.name] = t.to(device)
    return out
