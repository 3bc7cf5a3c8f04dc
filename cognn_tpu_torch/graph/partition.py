"""Partitioned graph container (port of ``cognn_tpu/graph/partition.py``,
pure numpy, copied so the port imports nothing of the JAX package).

The static half of the reference's GraphTile + GraphSummary: the sorted local
vertex order, global degrees, border flags, per-destination source-slot lists
with dummy padding, mirror-vertex (halo) lists per peer tile, and the
gather-dummy masks (reference `include/graph.h`,
`include/ss_vertex_centric_algo_kernel.h:279-534`).

Semantics preserved exactly:
  * vertices live on the tile from the partition file; edges live with their
    SOURCE tile; remote destinations materialize as mirror vertices
    (`graph.h:607-633`)
  * local vertex order = ascending vid (`ss_…h:462-504`); the train/val/test
    split slices this order positionally (`optimize-gcn/gcn.h:561-563`)
  * border vertex = source endpoint of a cross-tile edge
    (`graph_io_util.h:170-176`)
  * degrees are GLOBAL in/out degrees (`graph_io_util.h:185-195`)
  * default mode pads each destination's source list to the next power of two
    with dummy slots (`ss_…h:358-398`); ``no_dummy_edge`` mode instead gives
    only isolated local vertices one dummy slot AND increments their in/out
    degree (`ss_…h:399-436`)
  * dummy slots contribute the aggregation identity (zero); a destination row
    is wholly dummy for peer i iff i has no real edge into it
    (isGatherDstVertexDummy, `ss_…h:487,519-527`)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>=1); matches the external
    get_next_power_of_2 used at `ss_…h:369`."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class EdgeBlock:
    """Edge slots from THIS party's tile into destination tile ``dst_tile``.

    One slot per (real or dummy) incoming edge of each destination owned by
    ``dst_tile``, grouped by destination in ascending-vid order — the
    flattened updateSrcVertexPos / updateDstVertexPos layout of
    `ss_…h:478-503`.
    """

    dst_tile: int
    src_local: np.ndarray  # int32[S] — local index of the slot's source vertex
    seg_id: np.ndarray  # int32[S] — destination segment (see num_segments)
    dummy: np.ndarray  # bool[S] — padding slot (contributes zero)
    weight: np.ndarray  # float64[S] — edge weight (-1 on dummy slots)
    num_segments: int  # local block: V_local; remote: number of mirrors
    mirror_vids: Optional[np.ndarray]  # int64[M], sorted — remote blocks only

    @property
    def num_slots(self) -> int:
        return len(self.src_local)


@dataclasses.dataclass
class PartyGraph:
    """All static per-party graph state (tile + summary)."""

    tile_index: int
    tile_count: int
    local_vids: np.ndarray  # int64[V] ascending
    in_deg: np.ndarray  # int64[V] global in-degree
    out_deg: np.ndarray  # int64[V] global out-degree
    border: np.ndarray  # bool[V]
    blocks: List[EdgeBlock]  # len tile_count; blocks[tile_index] is local
    # Receive side: for peer i, i's mirror list for us maps to these local
    # indices (int32[M_i->me]); [tile_index] entry is arange(V).
    recv_target_local: List[np.ndarray]
    # gather_dummy[i][v]: peer i contributes no real update to local vertex v
    # (the reference's isGatherDstVertexDummy, `ss_…h:487,519-527`).
    gather_dummy: List[np.ndarray]
    # vertex data (filled by the loader, reordered to local_vids order)
    features: Optional[np.ndarray] = None  # f64[V, D]
    labels: Optional[np.ndarray] = None  # int64[V]

    @property
    def num_local(self) -> int:
        return len(self.local_vids)

    def local_index_of(self, vids: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.local_vids, vids)
        if not np.array_equal(self.local_vids[idx], vids):
            raise KeyError("vid not local to this tile")
        return idx.astype(np.int32)

    def set_vertex_data(self, vid: np.ndarray, features: np.ndarray,
                        labels: np.ndarray) -> None:
        """Attach features/labels given in arbitrary vid order
        (reference `harness.cpp:21-48`)."""
        order = {int(v): i for i, v in enumerate(vid)}
        sel = np.array([order[int(v)] for v in self.local_vids])
        self.features = np.asarray(features, np.float64)[sel]
        self.labels = np.asarray(labels, np.int64)[sel]


def build_party_graph(
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray],
    tid_of: Optional[Dict[int, int]],
    tile_index: int,
    tile_count: int,
    *,
    no_dummy_edge: bool = False,
    all_vids: Optional[np.ndarray] = None,
) -> PartyGraph:
    """Build this party's tile from the full edge list (as the reference's
    loader does — every party reads the complete topology,
    `graph_io_util.h:102-164`; privacy applies to vertex *data*).

    ``tid_of`` None => single tile. ``all_vids`` lists vertices with no edges
    (otherwise discovered from the partition map / edge list).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = (np.ones(len(src)) if weight is None
              else np.asarray(weight, np.float64))

    if tid_of is None:
        tid_of = {}
        tile_count = 1
        tile_index = 0

    # Universe of vertices: partition map ∪ edge endpoints ∪ all_vids.
    if tid_of:
        universe = np.array(sorted(tid_of), dtype=np.int64)
    else:
        parts = [src, dst]
        if all_vids is not None:
            parts.append(np.asarray(all_vids, np.int64))
        universe = np.unique(np.concatenate(parts))
    tid_arr_map = {int(v): tid_of.get(int(v), 0) for v in universe}

    vid_tid = np.array([tid_arr_map[int(v)] for v in universe], np.int64)
    local_vids = universe[vid_tid == tile_index]
    V = len(local_vids)
    local_pos = {int(v): i for i, v in enumerate(local_vids)}

    src_tid = np.array([tid_arr_map[int(v)] for v in src], np.int64)
    dst_tid = np.array([tid_arr_map[int(v)] for v in dst], np.int64)

    # Global degrees over the full edge list.
    uni_pos = {int(v): i for i, v in enumerate(universe)}
    src_u = np.array([uni_pos[int(v)] for v in src])
    dst_u = np.array([uni_pos[int(v)] for v in dst])
    g_out = np.bincount(src_u, minlength=len(universe)).astype(np.int64)
    g_in = np.bincount(dst_u, minlength=len(universe)).astype(np.int64)

    sel_local = np.array([uni_pos[int(v)] for v in local_vids], dtype=np.int64)
    in_deg = g_in[sel_local].copy()
    out_deg = g_out[sel_local].copy()

    # Border: local vertices incident to a cross-tile edge as SOURCE
    # (graph_io_util.h:172); undirected datasets mark both endpoints.
    border = np.zeros(V, dtype=bool)
    mine_src = src_tid == tile_index
    cross = mine_src & (dst_tid != tile_index)
    for v in src[cross]:
        border[local_pos[int(v)]] = True

    # --- My edges (src on my tile), grouped by destination tile ---
    blocks: List[EdgeBlock] = []
    for t in range(tile_count):
        emask = mine_src & (dst_tid == t)
        e_src = src[emask]
        e_dst = dst[emask]
        e_w = weight[emask]

        if t == tile_index:
            # Local block: one segment per local vertex (ascending vid).
            seg_of_dst = np.array([local_pos[int(v)] for v in e_dst],
                                  np.int64)
            num_seg = V
            seg_vids = local_vids
            mirror_vids = None
        else:
            mirror_vids = np.unique(e_dst)
            seg_of_dst = np.searchsorted(mirror_vids, e_dst)
            num_seg = len(mirror_vids)
            seg_vids = mirror_vids

        # Group slots by segment, ascending; dummy-pad per reference mode.
        order = np.argsort(seg_of_dst, kind="stable")
        counts = np.bincount(seg_of_dst, minlength=num_seg)
        slot_src: List[int] = []
        slot_seg: List[int] = []
        slot_dummy: List[bool] = []
        slot_w: List[float] = []
        off = 0
        for s in range(num_seg):
            c = int(counts[s])
            idx = order[off:off + c]
            off += c
            srcs = [local_pos[int(v)] for v in e_src[idx]]
            ws = list(e_w[idx])
            if no_dummy_edge:
                n_dummy = 1 if (c == 0 and t == tile_index) else 0
                if n_dummy and t == tile_index:
                    # reference ss_…h:415-418: isolated local vertex gets a
                    # self dummy and degree increments
                    in_deg[s] += 1
                    out_deg[s] += 1
            else:
                n_dummy = next_pow2(c) - c
            if t == tile_index:
                dummy_src = local_pos[int(seg_vids[s])]  # self (ss_…h:370)
            else:
                dummy_src = srcs[0] if srcs else 0  # first src (ss_…h:392)
            slot_src += srcs + [dummy_src] * n_dummy
            slot_seg += [s] * (c + n_dummy)
            slot_dummy += [False] * c + [True] * n_dummy
            slot_w += ws + [-1.0] * n_dummy

        blocks.append(EdgeBlock(
            dst_tile=t,
            src_local=np.array(slot_src, np.int32),
            seg_id=np.array(slot_seg, np.int32),
            dummy=np.array(slot_dummy, bool),
            weight=np.array(slot_w, np.float64),
            num_segments=num_seg,
            mirror_vids=mirror_vids,
        ))

    # --- Receive side: peers' mirror lists into me + gather-dummy masks ---
    recv_target_local: List[np.ndarray] = []
    gather_dummy: List[np.ndarray] = []
    for i in range(tile_count):
        if i == tile_index:
            recv_target_local.append(np.arange(V, dtype=np.int32))
            # local row dummy iff no real LOCAL in-edge (ss_…h:487)
            has_local_in = np.zeros(V, dtype=bool)
            lb = blocks[tile_index]
            has_local_in[lb.seg_id[~lb.dummy]] = True
            gather_dummy.append(~has_local_in)
        else:
            emask = (src_tid == i) & (dst_tid == tile_index)
            mirror = np.unique(dst[emask])
            recv_target_local.append(
                np.array([local_pos[int(v)] for v in mirror], np.int32))
            gd = np.ones(V, dtype=bool)
            gd[recv_target_local[-1]] = False
            gather_dummy.append(gd)

    return PartyGraph(
        tile_index=tile_index,
        tile_count=tile_count,
        local_vids=local_vids,
        in_deg=in_deg,
        out_deg=out_deg,
        border=border,
        blocks=blocks,
        recv_target_local=recv_target_local,
        gather_dummy=gather_dummy,
    )
