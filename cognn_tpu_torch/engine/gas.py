"""The GAS engine on PyTorch (port of ``cognn_tpu/engine/gas.py``):
full-graph GCN inference and training of P parties, in the two schedules of
the reference, with the parties stacked on one device (``mode="stacked"``)
or one process a party (``mode="sharded"``).

CoGNN-Opt (``variant="opt"``, ``"opt_inference"``): per layer l the forward
runs the PreScatter matmul, the source-side ``norm0`` scale (skipped on
layer 0), the aggregation with its destination-side scale, then ReLU, or on
the last layer a softmax and the metrics — the schedule of the reference's
`optimize-gcn/gcn.h` and of :class:`cognn_tpu.models.oracle.GasOracle`,
quirks included. A training epoch (:meth:`GasEngine.run_epoch`) runs those
L phases, then 2L backward phases, each layer's SGD step followed by the
mean of the weight replicas over the parties.

CoGNN (``variant="unopt"``, ``"unopt_inference"``, the reference's
`original-gcn`): per layer the ``norm0`` scale (skipped on layer 0) and the
aggregation come BEFORE the matmul, so layer 0 aggregates the features at
the full input width; an epoch is 2L phases, each layer's backward (relu'
mask, delta·Wᵀ, weight gradient, SGD, weight mean) fused into one, with an
aggregation between backward layers (``cognn_tpu/engine/gas.py:714-737,
809-850``). As in the JAX engine, agg(x0) is recomputed every forward and
epoch here; only the secret-shared engine hoists it.

``norm0`` is computed once per plan on the host (:func:`norm0_host`).

Aggregation backends (``aggregation=``):

  * ``"bcsr"`` — the hand-written CUDA SpMM
    (:class:`cognn_tpu_torch.ops.spmm.Spmm`) over the flat (P·V)×(P·V)
    edge-count matrix; the halo exchange is part of that matrix. The name is
    the JAX package's: there it is a block-sparse Pallas kernel, here the
    structure is destination-sorted CSR. On a CPU tensor it runs the
    kernel's plain version.
  * ``"dense"`` — the same matrix held dense (:func:`flat_dense_adjacency`),
    ``agg = h + Aᵀ·H`` as one ``torch.matmul`` (f32, TF32 off), as the JAX
    package computes it outside any Pallas kernel.
  * ``"sparse"`` — plain torch port of the XLA take + segment-sum path
    (remote slots, halo transpose, local slots, masked gather).
  * ``"auto"`` — :func:`select_backend`, from the card's measured numbers.

Sharded mode (``cognn_tpu/engine/gas.py:54-63, 491-518``): each process runs
one party, rank r of a :class:`cognn_tpu_torch.utils.distributed.PartyGroup`
of P, and keeps only party r's slice of the plan tensors, the features and
the weights (leading axis 1). The halo exchange is one ``all_to_all`` over
the peer axis and the weight mean one ``all_reduce`` (:class:`_ShardedComm`).
Its ``bcsr`` is a CSR of the party's V sources by the P·V global
destinations: one SpMM launch gives the party's update rows for every party,
P chunks of V rows, which the halo ships, and each party adds the P chunks it
receives. Its ``dense`` holds the party's block of ``plan.dense_adj`` as one
[P·V dst, V src] matrix (the plan must be built with ``dense=True``), one
``torch.matmul`` and the same halo. ``sparse`` ships its mirror rows through
the same halo.

On the card on ``bcsr`` or ``dense``, a request and an epoch are each one
replay of a CUDA graph captured from this code at their first call
(:mod:`cognn_tpu_torch.engine.graphs`, the JAX package's ``jit``), and
``run_epochs_scan(n)`` replays the epoch's graph n times (its ``lax.scan``).
Sharded, the step is split at its collectives (:class:`_ShardedComm` calls
them through the graphs): a replay is its segments' graphs with the halo
and the weight mean run between them, as the JAX package's ``shard_map``
runs one program around its collectives. ``cuda_graphs=False`` runs them
eager; ``sparse`` and the CPU always do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.engine.graphs import (
    EngineGraphs,
    kernel_counters,
    use_graphs,
)
from cognn_tpu_torch.engine.plan import (
    DENSE_ADJ_BUDGET,
    DevicePlan,
    plan_tensors,
    set_split,
)
from cognn_tpu_torch.ops.aggregate import segment_sum_rows
from cognn_tpu_torch.ops.spmm import Spmm
from cognn_tpu_torch.utils.device import resolve_device
from cognn_tpu_torch.utils.distributed import PartyGroup
from cognn_tpu_torch.utils.glibc_rand import glorot_init


def norm0_host(deg: np.ndarray) -> np.ndarray:
    """The GCN normalizer of the public degrees of a plan, on the host:
    (deg+1)^-1/2 in float64, rounded once to float32, with the reference's
    zero-degree-is-zero quirk (`optimize-gcn/gcn.h:219-221`). The same on
    every device; ``torch.rsqrt`` on the card and on the CPU, and XLA's
    ``rsqrt``, each differ from it in the last bit for some degrees."""
    deg = np.asarray(deg, np.float64)
    out = np.zeros_like(deg)
    nz = deg != 0
    out[nz] = 1.0 / np.sqrt(deg[nz] + 1.0)
    return out.astype(np.float32)


class _Comm:
    """Stacked-mode collectives (party axis = leading batch axis)."""

    def halo(self, send: torch.Tensor) -> torch.Tensor:
        # send[..., i, j, :, :] = party i's update rows for party j ->
        # recv[..., j, i, :, :] (leading axes, e.g. the share axis, ride along)
        return send.transpose(-4, -3)

    def weight_mean(self, w: torch.Tensor) -> torch.Tensor:
        """The replicas' mean over the party axis, one per party again."""
        return w.mean(dim=0, keepdim=True).expand_as(w)


class _ShardedComm:
    """Sharded-mode collectives: one process a party, its tensors with a
    local party axis of 1 (``cognn_tpu/engine/gas.py:54-63``). Each goes
    through the engine's ``graphs`` (:meth:`EngineGraphs.collective`): eager
    outside a capture, a breakpoint between two graphs in one."""

    def __init__(self, group: PartyGroup, graphs: EngineGraphs):
        self.group = group
        self.graphs = graphs

    def halo(self, send: torch.Tensor) -> torch.Tensor:
        # send[..., 0, j, :, :] = this party's update rows for party j ->
        # recv[..., 0, i, :, :] = party i's rows for this party: the peer
        # axis leads the exchange (contiguous), then goes back in place
        return self.graphs.collective(self.group.all_to_all,
                                      send.movedim(-3, 0)).movedim(0, -3)

    def weight_mean(self, w: torch.Tensor) -> torch.Tensor:
        """The mean of the parties' replicas, on every party."""
        return (self.graphs.collective(self.group.all_reduce_sum, w)
                / self.group.world)


def engine_mode(mode: str, group, device, plan: DevicePlan):
    """(device, rank) of an engine in ``mode``: the resolved ``device`` and
    None when stacked; the ``group``'s device and rank when sharded, which
    needs a :class:`PartyGroup` of the plan's parties on a device of the
    type ``device`` names."""
    if mode == "stacked":
        if group is not None:
            raise ValueError("a party group is for mode='sharded'")
        return resolve_device(device), None
    if mode != "sharded":
        raise ValueError(f"mode {mode!r} (stacked or sharded)")
    if group is None:
        raise ValueError("sharded mode requires a party group "
                         "(cognn_tpu_torch.utils.distributed."
                         "init_party_group)")
    if group.world != plan.num_parties:
        raise ValueError(f"a group of {group.world} processes for "
                         f"{plan.num_parties} parties")
    if torch.device(device).type != group.device.type:
        raise ValueError(f"device {device!r}, the party group on "
                         f"{group.device}")
    return group.device, group.rank


@dataclasses.dataclass
class _PlanArrays:
    """Device-resident plan tensors (leading party axis)."""

    vertex_mask: torch.Tensor
    in_deg: torch.Tensor
    n0: torch.Tensor  # [P, V] f32, norm0_host(in_deg)
    border: torch.Tensor
    labels: torch.Tensor
    num_local: torch.Tensor
    train_n: torch.Tensor
    val_n: torch.Tensor
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    loc_src: torch.Tensor
    loc_seg: torch.Tensor
    loc_valid: torch.Tensor
    rem_src: torch.Tensor
    rem_seg: torch.Tensor
    rem_valid: torch.Tensor
    recv_target: torch.Tensor
    recv_mask: torch.Tensor
    gather_ok_self: torch.Tensor  # [P, V]
    gather_ok_from: torch.Tensor  # [P, P, V], diagonal False


def _plan_arrays(plan: DevicePlan, t: Dict[str, torch.Tensor],
                 rank: Optional[int] = None) -> _PlanArrays:
    """The engine's view of :func:`plan_tensors`' output ``t`` for
    ``plan`` (with ``rank``: party ``rank``'s slice, as ``t`` holds it)."""
    ok = t["gather_ok"]  # [P or 1, P, V]
    P = ok.shape[1]
    parties = (torch.arange(P) if rank is None
               else torch.tensor([rank])).to(ok.device)
    peers = torch.arange(P, device=ok.device)
    in_deg = plan.in_deg if rank is None else plan.in_deg[rank:rank + 1]
    derived = ("n0", "gather_ok_self", "gather_ok_from")
    return _PlanArrays(**{f.name: t[f.name]
                          for f in dataclasses.fields(_PlanArrays)
                          if f.name not in derived},
                       n0=torch.from_numpy(norm0_host(in_deg)).to(
                           ok.device),
                       gather_ok_self=ok[torch.arange(len(parties)), parties],
                       gather_ok_from=ok & (peers[None] != parties[:, None])
                       [..., None])


def gcn_metrics(arr: _PlanArrays,
                prob: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-party loss, accuracies and border count of ``prob [P, V, C]``:
    the plaintext metric definitions, which the secret-shared engine uses on
    its revealed prediction too."""
    valid = arr.vertex_mask
    train = arr.train_mask
    test = valid & ~arr.train_mask & ~arr.val_mask
    border = arr.border

    y_hot = torch.nn.functional.one_hot(arr.labels, prob.shape[-1]).to(
        prob.dtype)
    clamped = torch.where(prob == 0.0, 0.001, prob)
    loss_rows = -(y_hot * torch.log(clamped)).sum(-1)
    # summed in float64 and rounded once: a CUDA float32 row sum splits a
    # row by how many rows there are, so a party's loss would change in its
    # last bit between the stacked [P, V] and the sharded [1, V] engine
    loss = (torch.where(valid, loss_rows, 0.0).to(torch.float64).sum(-1)
            / arr.num_local).to(prob.dtype)

    hit = prob.argmax(-1) == arr.labels

    def acc(mask):
        n = mask.sum(-1)
        return torch.where(n > 0, (hit & mask).sum(-1) / n.clamp(min=1), 0.0)

    return {
        "loss": loss,
        "full_acc": acc(valid),
        "train_acc": acc(train),
        "border_train_acc": acc(train & border),
        "test_acc": acc(test),
        "border_test_acc": acc(test & border),
        "num_border": (valid & border).sum(-1),
    }


def stack_epochs(run_epoch: Callable[[], Dict[str, torch.Tensor]],
                 n: int) -> Dict[str, torch.Tensor]:
    """``n`` calls of ``run_epoch`` (one epoch, its metrics [P] each) ->
    one dict of [P, n] tensors, each epoch's metrics written into stacks
    allocated at the first."""
    stack = None
    for i in range(n):
        metrics = run_epoch()
        if stack is None:
            stack = {k: v.new_empty((*v.shape, n))
                     for k, v in metrics.items()}
        for k, v in metrics.items():
            stack[k][..., i] = v
    return stack


def _take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [..., P, V, D], idx [P, E] -> [..., P, E, D] with [..., p, e] =
    h[..., p, idx[p, e]] (leading axes, e.g. the share axis, ride along)."""
    p = torch.arange(h.shape[-3], device=h.device)[:, None]
    return h[..., p, idx, :]


def _party_edges(plan: DevicePlan, p: int, weights: bool = False):
    """Party p's real edge endpoints as (local src, GLOBAL flat dst), and
    with ``weights`` their f32 edge weights third."""
    V, M = plan.V, plan.M
    real = plan.loc_valid[p]
    srcs = [plan.loc_src[p][real].astype(np.int64)]
    dsts = [p * V + plan.loc_seg[p][real].astype(np.int64)]
    rr = plan.rem_valid[p]
    seg = plan.rem_seg[p][rr].astype(np.int64)
    j = seg // M
    mir = seg % M
    tgt = plan.recv_target[j, p, mir].astype(np.int64)
    srcs.append(plan.rem_src[p][rr].astype(np.int64))
    dsts.append(j * V + tgt)
    out = np.concatenate(srcs), np.concatenate(dsts)
    if not weights:
        return out
    return (*out, np.concatenate([plan.loc_weight[p][real],
                                  plan.rem_weight[p][rr]]).astype(np.float32))


def _build_spmm_stacked(plan: DevicePlan, device: torch.device) -> Spmm:
    """All parties' real edges as ONE (P·V)×(P·V) edge-count matrix over the
    flat (party, vertex) axis: the halo exchange is part of the structure,
    and dummy/mask semantics are baked in (only real edges are entries)."""
    P, V = plan.num_parties, plan.V
    srcs, dsts = [], []
    for p in range(P):
        s, d = _party_edges(plan, p)
        srcs.append(p * V + s)
        dsts.append(d)
    return Spmm(np.concatenate(srcs), np.concatenate(dsts), P * V, P * V,
                device)


def _build_spmm_sharded(plan: DevicePlan, p: int,
                        device: torch.device) -> Spmm:
    """Party p's real edges as a (V local src)×(P·V global dst) edge-count
    matrix (``cognn_tpu/engine/gas.py:328-408``): its product gives party
    p's update rows for every party, which the halo ships."""
    P, V = plan.num_parties, plan.V
    return Spmm(*_party_edges(plan, p), V, P * V, device)


def party_dense_block(plan: DevicePlan, p: int) -> np.ndarray:
    """Party p's rows of the dense adjacency ``plan.dense_adj`` as one
    [(P·V)dst, V src] matrix, the operand of the sharded dense product."""
    if plan.dense_adj is None:
        raise ValueError("sharded dense aggregation needs a dense=True plan")
    P, V = plan.num_parties, plan.V
    return np.ascontiguousarray(
        plan.dense_adj[p].transpose(0, 2, 1).reshape(P * V, V))


def _aggregation_operands(plan: DevicePlan, aggregation: str,
                          rank: Optional[int], device: torch.device):
    """(Spmm or None, dense matrix or None) of the ``bcsr`` and ``dense``
    backends: the flat (P·V)×(P·V) structure stacked, party ``rank``'s V
    src × P·V dst block sharded. The dense matrix is held transposed,
    [dst, src]."""
    if aggregation == "bcsr":
        return (_build_spmm_stacked(plan, device) if rank is None
                else _build_spmm_sharded(plan, rank, device)), None
    if aggregation == "dense":
        adj_t = (flat_dense_adjacency(plan).T.copy() if rank is None
                 else party_dense_block(plan, rank))
        return None, torch.from_numpy(adj_t).to(device)
    return None, None


def flat_dense_adjacency(plan: DevicePlan) -> np.ndarray:
    """[(P·V)src, (P·V)dst] edge-count matrix, built from the index plan
    (equals ``plan.dense_adj`` flattened when that was precomputed)."""
    P, V = plan.num_parties, plan.V
    if plan.dense_adj is not None:
        return plan.dense_adj.transpose(0, 2, 1, 3).reshape(P * V, P * V)
    flat = np.zeros((P * V, P * V), np.float32)
    for p in range(P):
        s, d = _party_edges(plan, p)
        np.add.at(flat, (p * V + s, d), 1.0)
    return flat


# The card's numbers behind "auto" (chip_smoke.py launch_floor and
# dense_phase on cora_2p, n = P·V = 2720, nnz = 10,556; NVIDIA H100 80GB
# HBM3, 700 W). Dense moves the n×n matrix; the CSR kernel moves its n + 1
# row pointers, nnz (index, count) pairs and the rows.
AUTO_LAUNCH_FLOOR_S = 1.95e-6  # a one-element zero_: 1.95 µs
# The rates below are keyed by the element: 0 f32, 64 and 32 the ring
# shares' bits (int64, int32). The int32 ones from chip_smoke.py
# ring32_phase on cora_2p (same card), K3 mod 2^32 with the int32 Aᵀ.
# rate achieved on the dense product's compulsory bytes (matrix, rows in
# and out) at the narrowest width: f32 torch.matmul at D = 7, 29.7 MB in
# 27.9 µs; K3 at 2·7 = 14 columns, 59.8 MB in 108.7 µs; int32 29.9 MB in
# 14.8 µs
AUTO_DENSE_BYTES_PER_S = {0: 1.068e12, 64: 5.50e11, 32: 2.02e12}
# ... and on its operations at the widest: f32 D = 1433, 2.12e10 flop in
# 0.451 ms; K3 at 2·1433 columns, 4.24e10 in 2.73 ms; int32 in 1.23 ms
AUTO_DENSE_OPS_PER_S = {0: 4.71e13, 64: 1.55e13, 32: 3.45e13}
# rate achieved by the CSR kernel on its compulsory bytes at the widest
# width, D = 1433: f32 31.3 MB in 29.8 µs; ring, 2 shares, 124.9 MB in
# 63.5 µs; int32 62.5 MB in 40.4 µs
AUTO_CSR_BYTES_PER_S = {0: 1.049e12, 64: 1.965e12, 32: 1.55e12}


def _element(ring) -> int:
    """The key of the rates above: ``ring`` False (f32) 0, True or 64 for
    int64 shares 64, 32 for int32 shares 32."""
    if not ring:
        return 0
    return 32 if ring == 32 else 64


def aggregation_seconds(backend: str, n: int, nnz: int, width: int,
                        ring, n_src: Optional[int] = None) -> float:
    """Predicted device time of one aggregation of ``width`` columns (both
    shares when ``ring``: True or 64 for int64 shares, 32 for int32) over
    an ``n_src``×``n`` matrix (``n_src`` None: the flat n×n one) with
    ``nnz`` entries: the larger of the launch floor, the compulsory bytes at
    the backend's achieved rate and, for dense, its operations at their
    achieved rate."""
    n_src = n if n_src is None else n_src
    key = _element(ring)
    e = 8 if key == 64 else 4  # bytes of an element
    rows = (n_src + n) * width * (2 if key else 1) * e  # H in, update out
    if backend == "dense":
        return max(AUTO_LAUNCH_FLOOR_S,
                   (n_src * n * e + rows) / AUTO_DENSE_BYTES_PER_S[key],
                   2 * n_src * n * width * (2 if key else 1)
                   / AUTO_DENSE_OPS_PER_S[key])
    return max(AUTO_LAUNCH_FLOOR_S,
               (4 * (n + 1) + (4 + e) * nnz + rows)
               / AUTO_CSR_BYTES_PER_S[key])


def select_backend(plan: DevicePlan, device: torch.device,
                   widths, ring=False, sharded: bool = False) -> str:
    """``aggregation="auto"``: the backend with the smaller predicted device
    time (:func:`aggregation_seconds`) summed over a forward's aggregation
    ``widths``, dense only while the plan's dense operator fits
    DENSE_ADJ_BUDGET; ties go to the CSR kernel. One rule for both engines
    (``ring``: the secret-shared one, True or 64 on int64 shares, 32 on
    int32), on the H100 numbers above.

    Measured on cora_2p (chip_smoke.py dense_phase; NVIDIA H100 80GB HBM3,
    700 W), µs an aggregation, dense against the CSR kernel: f32 at D = 16,
    7, 1433: 32.5 / 27.9 / 451 against 3.37 / 3.12 / 29.8; secret-shared
    (K3 at 2·D columns against the ring kernel on both shares): 119 / 109 /
    2730 against 3.68 / 3.25 / 63.5. So "auto" takes the CSR kernel on
    cora_2p, and on pubmed_4p, whose (4·4936)² = 3.9e8 elements exceed the
    budget. On CPU tensors "auto" is the CSR kernel's plain version.

    ``sharded``: each party multiplies its own V src × P·V dst block, and
    the halo ships the same P·V rows whichever backend made them, so the
    rule compares the two products at that shape (``cognn_tpu/engine/
    gas.py:171-215`` takes the per-party block SpMM there). Dense needs the
    plan's ``dense_adj``. The parties must agree (their halos differ in
    size between backends): the rule reads only the plan, which every
    party holds whole, and takes the busiest party's entries."""
    if device.type != "cuda":
        return "bcsr"
    P, V = plan.num_parties, plan.V
    if sharded:
        if plan.dense_adj is None:
            return "bcsr"
        n_src, n = V, P * V
        nnz = int((plan.loc_valid.sum(1) + plan.rem_valid.sum(1)).max())
    else:
        if P * P * V * V > DENSE_ADJ_BUDGET:
            return "bcsr"
        n_src = n = P * V
        nnz = int(plan.loc_valid.sum() + plan.rem_valid.sum())
    t = {b: sum(aggregation_seconds(b, n, nnz, w, ring, n_src)
                for w in widths)
         for b in ("bcsr", "dense")}
    return "dense" if t["dense"] < t["bcsr"] else "bcsr"


def forward_widths(param: GNNParam, variant: str,
                   hoisted: bool = False) -> List[int]:
    """Widths of a forward's aggregations: each layer's output width (opt)
    or input width (unopt), less layer 0's where agg(x0) is ``hoisted``."""
    dims = param.layer_dims
    if variant.startswith("unopt"):
        return list(dims[1 if hoisted else 0:-1])
    return list(dims[1:])


class GasEngine:
    """GAS schedules over a :class:`DevicePlan`, parties stacked on one
    device (``mode="stacked"``) or one process a party (``mode="sharded"``,
    with ``group``, this process's :class:`PartyGroup`).

    ``variant``: "opt" or "opt_inference" (CoGNN-Opt), "unopt" or
    "unopt_inference" (CoGNN); the two of a schedule run the same forward
    and epoch, as in the JAX package. ``aggregation``: "bcsr" (the CUDA
    SpMM kernel), "dense" (one matmul with the dense flat matrix), "sparse"
    (plain torch) or "auto" (:func:`select_backend`). ``device`` defaults to
    "cuda" and raises when there is no card; sharded, it names the type of
    the group's device. Sharded, every tensor has a local party axis of 1:
    the weights ``[1, d_in, d_out]``, the logits ``[1, V, C]``, each
    metric ``[1]``.

    ``cuda_graphs`` (:mod:`cognn_tpu_torch.engine.graphs`): by default an
    engine on the card on ``bcsr`` or ``dense`` runs each request and each
    epoch as a replay of CUDA graphs captured from its eager code at the
    first call (sharded: split at the collectives, which run between the
    graphs); ``False`` runs it eager, ``True`` raises where it cannot
    capture (the CPU, ``sparse``). The weights are
    updated in place, the graphs' static inputs; ``weights`` hands out
    copies, and assigning it replaces them and drops the graphs.
    """

    def __init__(self, plan: DevicePlan, param: GNNParam,
                 variant: str = "opt", mode: str = "stacked", seed: int = 42,
                 aggregation: str = "auto", device="cuda",
                 group: Optional[PartyGroup] = None,
                 cuda_graphs: Optional[bool] = None):
        if variant not in ("opt", "opt_inference", "unopt",
                           "unopt_inference"):
            raise ValueError(variant)
        if aggregation not in ("auto", "bcsr", "dense", "sparse"):
            raise ValueError(aggregation)
        self.device, self.rank = engine_mode(mode, group, device, plan)
        self.mode = mode
        set_split(plan, param.train_ratio, param.val_ratio)
        self.plan = plan
        self.param = param
        self.variant = variant
        self.unopt = variant.startswith("unopt")
        self.L = param.num_layers
        # phases an epoch: L forward, then 2L (opt) or L (unopt) backward
        self.epoch_layers = (2 if self.unopt else 3) * self.L
        self.P = plan.num_parties
        self.Pl = self.P if self.rank is None else 1  # parties held here
        tensors = plan_tensors(plan, self.device, self.rank)
        self.arr = _plan_arrays(plan, tensors, self.rank)
        if aggregation == "auto":
            aggregation = select_backend(plan, self.device,
                                         forward_widths(param, variant),
                                         sharded=self.rank is not None)
        self.aggregation = aggregation
        self.spmm, self.adj_t = _aggregation_operands(plan, aggregation,
                                                      self.rank, self.device)
        self._graphs = EngineGraphs(
            use_graphs(cuda_graphs, self.device, aggregation),
            kernel_counters(self.spmm), device=self.device)
        self.comm = (_Comm() if group is None
                     else _ShardedComm(group, self._graphs))
        self.x0 = tensors["features"]
        dims = param.layer_dims
        # per-party weight replicas (reference keeps one per party and
        # averages after each layer update, gcn.h:747-802)
        self.weights = [
            torch.as_tensor(glorot_init(dims[i], dims[i + 1], seed),
                            dtype=torch.float32)
            .expand(self.Pl, dims[i], dims[i + 1]).contiguous()
            .to(self.device)
            for i in range(self.L)
        ]

    @property
    def weights(self) -> List[torch.Tensor]:
        """The weight replicas, one ``[P, d_in, d_out]`` a layer: copies,
        which no later epoch changes."""
        return [w.clone() for w in self._weights]

    @weights.setter
    def weights(self, weights) -> None:
        """Replace the weights by copies of ``weights`` (any party count)
        and drop the captured graphs, which read the old ones."""
        self._weights = [w.clone(memory_format=torch.contiguous_format)
                         for w in weights]
        self._graphs.clear()

    # ------------------------------------------------------------------
    # aggregation (scatter -> premerge/OGA -> halo exchange -> gather)
    # ------------------------------------------------------------------
    def _aggregate(self, comm: _Comm, arr: _PlanArrays, h: torch.Tensor,
                   dest_scale: bool) -> torch.Tensor:
        plan = self.plan
        V, M, P = plan.V, plan.M, plan.num_parties
        D = h.shape[-1]

        if (self.spmm is not None or self.adj_t is not None) \
                and self.rank is not None:
            # this party's update rows for every party, P chunks of V rows
            # (one kernel, or one matmul with its dense block), shipped by
            # the halo; the P chunks received add up to the update
            hl = h.reshape(V, D).contiguous()
            upd = self.spmm(hl) if self.spmm is not None else self.adj_t @ hl
            recv = comm.halo(upd.reshape(1, P, V, D))  # [:, i] = from i
            agg = h + recv.sum(dim=1)
            return agg * arr.n0[..., None] if dest_scale else agg

        if self.spmm is not None or self.adj_t is not None:
            # gather/OGA/halo/gather in one kernel over the flat edge matrix,
            # or one matmul U = A^T H with it held dense
            hf = h.reshape(P * V, D)
            upd = self.spmm(hf) if self.spmm is not None else self.adj_t @ hf
            agg = h + upd.reshape(h.shape)
            return agg * arr.n0[..., None] if dest_scale else agg

        # remote slots: segment-sum into per-destination-party mirror rows,
        # then the halo exchange (the reference's mirror-update shipping,
        # ss_…h:1089-1100)
        rvals = _take_rows(h, arr.rem_src)
        rvals = torch.where(arr.rem_valid[..., None], rvals, 0.0)
        send = segment_sum_rows(rvals, arr.rem_seg, P * M + 1)[:, :P * M]
        recv = comm.halo(send.reshape(-1, P, M, D))  # [:, i] = from party i

        # local slots: gather rows, mask dummies, segment-sum by destination
        lvals = _take_rows(h, arr.loc_src)
        lvals = torch.where(arr.loc_valid[..., None], lvals, 0.0)
        loc_upd = segment_sum_rows(lvals, arr.loc_seg, V + 1)[:, :V]

        # scatter received mirror rows into local vertex order
        tgt = torch.where(arr.recv_mask, arr.recv_target, V)
        rows = torch.where(arr.recv_mask[..., None], recv, 0.0)
        rem_upd = segment_sum_rows(rows, tgt, V + 1)[..., :V, :]

        # gather: base vertex value + masked per-peer updates
        # (twoPartyGCNCondVectorAddition, gcn.h:456-463)
        agg = h + torch.where(arr.gather_ok_self[..., None], loc_upd, 0.0)
        agg = agg + torch.where(arr.gather_ok_from[..., None], rem_upd,
                                0.0).sum(dim=1)

        # deferred destination-side scale (gcn.h:470-484)
        return agg * arr.n0[..., None] if dest_scale else agg

    # ------------------------------------------------------------------
    def _forward_body(self, comm: _Comm, arr: _PlanArrays,
                      weights: List[torch.Tensor], x0: torch.Tensor):
        """Inference: L forward phases; returns (logits, prob, metrics)."""
        h = x0
        for l in range(self.L):
            if self.unopt:
                z = self._unopt_layer(comm, arr, l, h, weights[l])[1]
            else:
                h = torch.bmm(h, weights[l])  # PreScatter matmul, pvd,pde->pve
                if l != 0:
                    h = h * arr.n0[..., None]  # source-side scale, not on 0
                z = self._aggregate(comm, arr, h, dest_scale=True)
            h = torch.relu(z) if l != self.L - 1 else z
        prob = torch.softmax(h, dim=-1)
        return h, prob, gcn_metrics(arr, prob)

    def _unopt_layer(self, comm: _Comm, arr: _PlanArrays, l: int,
                     h: torch.Tensor, w: torch.Tensor):
        """Layer l of the unopt forward (cognn_tpu/engine/gas.py:722-726):
        the source-side scale (not on layer 0) and the aggregation at the
        layer's input width, then the matmul; returns (agg, z)."""
        if l != 0:
            h = h * arr.n0[..., None]
        agg = self._aggregate(comm, arr, h, dest_scale=True)
        return agg, torch.bmm(agg, w)

    def _predict_apply(self, arr: _PlanArrays, h: torch.Tensor):
        """Prediction-layer Apply: softmax, metrics, p - y masked to the
        local train split (gcn.h:557-643)."""
        prob = torch.softmax(h, dim=-1)
        y_hot = torch.nn.functional.one_hot(arr.labels, h.shape[-1]).to(
            h.dtype)
        pm = torch.where(arr.train_mask[..., None], prob - y_hot, 0.0)
        return pm, gcn_metrics(arr, prob)

    def _epoch_opt(self, comm: _Comm, arr: _PlanArrays,
                   weights: List[torch.Tensor], x0: torch.Tensor):
        """One CoGNN-Opt training epoch, 3L phases (cognn_tpu/engine/gas.py
        :745-792); returns (new weights, the forward's metrics)."""
        L = self.L
        lr = float(np.float32(self.param.learning_rate))
        n0 = arr.n0[..., None]
        inv_train = (1.0 / arr.train_n.to(torch.float32))[:, None, None]
        weights = list(weights)
        h = x0
        h_in: List[torch.Tensor] = [None] * L
        z: List[torch.Tensor] = [None] * L
        metrics = None

        # forward phases 0..L-1 (PreScatter matmul + deferred scaling)
        for l in range(L):
            h_in[l] = h
            h = torch.bmm(h, weights[l])
            if l != 0:
                h = h * n0  # source-side scale skipped on phase 0
            h = self._aggregate(comm, arr, h, dest_scale=True)
            z[l] = h
            if l != L - 1:
                h = torch.relu(h)
            else:
                h, metrics = self._predict_apply(arr, h)

        # backward phases L..3L-1 as the reference runs them: aggregation on
        # every phase except phase % L == 0 (Apply-only, ss_…h:709-732), no
        # destination scale on the epoch's last phase; Apply alternates
        # first-of-two (delta @ W^T) and second-of-two (weight gradient, SGD,
        # weight mean) per layer
        g = None
        for phase in range(L, 3 * L):
            l = L - 1 - (phase - L) // 2
            first = (phase - L) % 2 == 0
            if phase % L != 0:
                h = self._aggregate(comm, arr, h * n0,
                                    dest_scale=phase + 1 != 3 * L)
            if first:
                if l != L - 1:
                    h = h * (z[l] > 0)  # BackwardNNWithoutAH relu' mask
                # layer 0's delta @ W0^T (cognn_tpu/engine/gas.py:786) is
                # never read: the epoch ends after its weight gradient
                if l != 0:
                    g = torch.bmm(h, weights[l].transpose(1, 2))
            else:
                d = torch.bmm(h_in[l].transpose(1, 2), h) * inv_train
                weights[l] = comm.weight_mean(weights[l] - lr * d)
                h = g
        return weights, metrics

    def _epoch_unopt(self, comm: _Comm, arr: _PlanArrays,
                     weights: List[torch.Tensor], x0: torch.Tensor):
        """One CoGNN (unopt) training epoch, 2L phases (cognn_tpu/engine/
        gas.py:809-850); returns (new weights, the forward's metrics)."""
        L = self.L
        lr = float(np.float32(self.param.learning_rate))
        inv_train = (1.0 / arr.train_n.to(torch.float32))[:, None, None]
        weights = list(weights)
        h = x0
        ah: List[torch.Tensor] = [None] * L  # each layer's aggregated input
        z: List[torch.Tensor] = [None] * L
        metrics = None

        for l in range(L):
            ah[l], z[l] = self._unopt_layer(comm, arr, l, h, weights[l])
            if l != L - 1:
                h = torch.relu(z[l])
            else:
                h, metrics = self._predict_apply(arr, z[l])

        # one backward phase a layer, the aggregation of delta @ W^T between
        # layers; no destination scale on the epoch's last phase
        for k, l in enumerate(reversed(range(L))):
            if l != L - 1:
                h = h * (z[l] > 0)  # relu' mask
            # layer 0's delta @ W0^T (cognn_tpu/engine/gas.py:837) is never
            # read: the epoch ends after its weight gradient
            if l != 0:
                g = torch.bmm(h, weights[l].transpose(1, 2))
            d = torch.bmm(ah[l].transpose(1, 2), h) * inv_train
            weights[l] = comm.weight_mean(weights[l] - lr * d)
            if l != 0:
                h = self._aggregate(comm, arr, g * arr.n0[..., None],
                                    dest_scale=L + k + 2 != 2 * L)
        return weights, metrics

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _epoch_step(self) -> Dict[str, torch.Tensor]:
        """One epoch, the new weights written into the weight tensors in
        place after all reads (a graph's static inputs); returns its
        forward's metrics."""
        epoch = self._epoch_unopt if self.unopt else self._epoch_opt
        weights, metrics = epoch(self.comm, self.arr, self._weights, self.x0)
        for w, new in zip(self._weights, weights):
            w.copy_(new)
        return metrics

    def _epoch(self) -> Dict[str, torch.Tensor]:
        """One epoch through the graphs: a replay's metrics are the graph's
        own, valid until the next epoch."""
        return self._graphs.run("epoch", self._epoch_step)

    @torch.no_grad()
    def run_epoch(self) -> Dict[str, torch.Tensor]:
        """One training epoch; returns its forward's per-party metrics."""
        return self._graphs.call("epoch", self._epoch_step)

    @torch.no_grad()
    def run_epochs(self, n: int) -> Dict[str, torch.Tensor]:
        """``n`` epochs; returns the last one's metrics."""
        for _ in range(n - 1):
            self._epoch()
        return self.run_epoch() if n > 0 else None

    @torch.no_grad()
    def run_epochs_scan(self, n: int) -> Dict[str, torch.Tensor]:
        """``n`` epochs; returns every epoch's metrics, each shaped [P, n]
        (sharded [1, n]) as the JAX package's scan returns them."""
        return stack_epochs(self._epoch, n)

    @staticmethod
    def metrics_host(metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
        """Fetch a metrics dict to host numpy."""
        return {k: v.detach().cpu().numpy() for k, v in metrics.items()}

    # this process's parties' metrics (cognn_tpu/engine/gas.py:889-900):
    # every tensor of an engine is local, so it is metrics_host; sharded,
    # each metric holds this party's entry only
    metrics_local = metrics_host

    @torch.no_grad()
    def forward(self):
        """Full-graph inference: (logits [P, V, C], prob, metrics)."""
        return self._graphs.call("forward", lambda: self._forward_body(
            self.comm, self.arr, self._weights, self.x0))
