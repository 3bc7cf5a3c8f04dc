"""The GAS engine on PyTorch (port of ``cognn_tpu/engine/gas.py``):
CoGNN-Opt full-graph inference with all P parties stacked on one device.

Per layer l the forward runs the PreScatter matmul, the source-side ``norm0``
scale (skipped on layer 0), the aggregation with its destination-side scale,
then ReLU, or on the last layer a softmax and the metrics — the schedule of
the reference's `optimize-gcn/gcn.h` and of :class:`cognn_tpu.models.oracle.
GasOracle`, quirks included.

Aggregation backends (``aggregation=``):

  * ``"bcsr"`` (and ``"auto"``) — the hand-written CUDA SpMM
    (:class:`cognn_tpu_torch.ops.spmm.Spmm`) over the flat (P·V)×(P·V)
    edge-count matrix; the halo exchange is part of that matrix. The name is
    the JAX package's: there it is a block-sparse Pallas kernel, here the
    structure is destination-sorted CSR. On a CPU tensor it runs the
    kernel's plain version.
  * ``"sparse"`` — plain torch port of the XLA take + segment-sum path
    (remote slots, halo transpose, local slots, masked gather).

Training (``run_epoch``), the unopt variants, the dense backend and the
sharded mode come with later slices of the port and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.engine.plan import DevicePlan, plan_tensors, set_split
from cognn_tpu_torch.ops.aggregate import segment_sum_rows
from cognn_tpu_torch.ops.spmm import Spmm
from cognn_tpu_torch.utils.device import resolve_device
from cognn_tpu_torch.utils.glibc_rand import glorot_init


def norm0(deg: torch.Tensor) -> torch.Tensor:
    """(deg+1)^-1/2 with the reference's zero-degree-is-zero quirk
    (`optimize-gcn/gcn.h:219-221`)."""
    return torch.where(deg == 0, torch.zeros_like(deg), torch.rsqrt(deg + 1.0))


class _Comm:
    """Stacked-mode collectives (party axis = leading batch axis)."""

    def halo(self, send: torch.Tensor) -> torch.Tensor:
        # send[i, j] = party i's update rows for party j -> recv[j, i]
        return send.transpose(0, 1)


@dataclasses.dataclass
class _PlanArrays:
    """Device-resident plan tensors (leading party axis)."""

    vertex_mask: torch.Tensor
    in_deg: torch.Tensor
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


def _plan_arrays(t: Dict[str, torch.Tensor]) -> _PlanArrays:
    """The engine's view of :func:`plan_tensors`' output."""
    ok = t["gather_ok"]  # [P, P, V]
    P = ok.shape[0]
    eye = torch.eye(P, dtype=torch.bool, device=ok.device)
    derived = ("gather_ok_self", "gather_ok_from")
    return _PlanArrays(**{f.name: t[f.name]
                          for f in dataclasses.fields(_PlanArrays)
                          if f.name not in derived},
                       gather_ok_self=ok[torch.arange(P), torch.arange(P)],
                       gather_ok_from=ok & ~eye[..., None])


def _take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [P, V, D], idx [P, E] -> [P, E, D] with [p, e] = h[p, idx[p, e]]."""
    return h[torch.arange(h.shape[0], device=h.device)[:, None], idx]


def _party_edges(plan: DevicePlan, p: int):
    """Party p's real edge endpoints as (local src, GLOBAL flat dst)."""
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
    return np.concatenate(srcs), np.concatenate(dsts)


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


class GasEngine:
    """GAS schedules over a :class:`DevicePlan`, parties stacked on one
    device.

    ``variant``: "opt" or "opt_inference" (same forward; "opt" training
    comes with the training slice). ``aggregation``: "auto"/"bcsr" (the CUDA
    SpMM kernel) or "sparse" (plain torch). ``device`` defaults to "cuda" and
    raises when there is no card.
    """

    def __init__(self, plan: DevicePlan, param: GNNParam,
                 variant: str = "opt", mode: str = "stacked", seed: int = 42,
                 aggregation: str = "auto", device="cuda"):
        if variant in ("unopt", "unopt_inference"):
            raise NotImplementedError(
                f"variant {variant!r} comes with the unopt slice of the port")
        if variant not in ("opt", "opt_inference"):
            raise ValueError(variant)
        if mode != "stacked":
            raise NotImplementedError(
                f"mode {mode!r} comes with the sharded slice of the port "
                "(torch.distributed)")
        if aggregation == "dense":
            raise NotImplementedError(
                "aggregation 'dense' comes with the dense-backend slice of "
                "the port")
        if aggregation not in ("auto", "bcsr", "sparse"):
            raise ValueError(aggregation)
        self.device = resolve_device(device)
        set_split(plan, param.train_ratio, param.val_ratio)
        self.plan = plan
        self.param = param
        self.variant = variant
        self.L = param.num_layers
        self.P = plan.num_parties
        tensors = plan_tensors(plan, self.device)
        self.arr = _plan_arrays(tensors)
        self.aggregation = "sparse" if aggregation == "sparse" else "bcsr"
        self.spmm = (_build_spmm_stacked(plan, self.device)
                     if self.aggregation == "bcsr" else None)
        self.x0 = tensors["features"]
        dims = param.layer_dims
        # per-party weight replicas (reference keeps one per party and
        # averages after each layer update, gcn.h:747-802)
        self.weights: List[torch.Tensor] = [
            torch.as_tensor(glorot_init(dims[i], dims[i + 1], seed),
                            dtype=torch.float32)
            .expand(self.P, dims[i], dims[i + 1]).contiguous().to(self.device)
            for i in range(self.L)
        ]

    # ------------------------------------------------------------------
    # aggregation (scatter -> premerge/OGA -> halo exchange -> gather)
    # ------------------------------------------------------------------
    def _aggregate(self, comm: _Comm, arr: _PlanArrays, h: torch.Tensor,
                   dest_scale: bool) -> torch.Tensor:
        plan = self.plan
        V, M, P = plan.V, plan.M, plan.num_parties
        D = h.shape[-1]

        if self.spmm is not None:
            # gather/OGA/halo/gather in one kernel over the flat edge matrix
            upd = self.spmm(h.reshape(P * V, D))
            agg = h + upd.reshape(h.shape)
            return agg * norm0(arr.in_deg)[..., None] if dest_scale else agg

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
        return agg * norm0(arr.in_deg)[..., None] if dest_scale else agg

    # ------------------------------------------------------------------
    def _metrics(self, arr: _PlanArrays,
                 prob: torch.Tensor) -> Dict[str, torch.Tensor]:
        valid = arr.vertex_mask
        train = arr.train_mask
        test = valid & ~arr.train_mask & ~arr.val_mask
        border = arr.border

        y_hot = torch.nn.functional.one_hot(arr.labels, prob.shape[-1]).to(
            prob.dtype)
        clamped = torch.where(prob == 0.0, 0.001, prob)
        loss_rows = -(y_hot * torch.log(clamped)).sum(-1)
        loss = torch.where(valid, loss_rows, 0.0).sum(-1) / arr.num_local

        hit = prob.argmax(-1) == arr.labels

        def acc(mask):
            n = mask.sum(-1)
            return torch.where(n > 0, (hit & mask).sum(-1) / n.clamp(min=1),
                               0.0)

        return {
            "loss": loss,
            "full_acc": acc(valid),
            "train_acc": acc(train),
            "border_train_acc": acc(train & border),
            "test_acc": acc(test),
            "border_test_acc": acc(test & border),
            "num_border": (valid & border).sum(-1),
        }

    # ------------------------------------------------------------------
    def _forward_body(self, comm: _Comm, arr: _PlanArrays,
                      weights: List[torch.Tensor], x0: torch.Tensor):
        """Inference: L forward phases; returns (logits, prob, metrics)."""
        h = x0
        n0 = norm0(arr.in_deg)[..., None]
        for l in range(self.L):
            h = torch.bmm(h, weights[l])  # PreScatter matmul, pvd,pde->pve
            if l != 0:
                h = h * n0  # source-side scale skipped on phase 0
            z = self._aggregate(comm, arr, h, dest_scale=True)
            h = torch.relu(z) if l != self.L - 1 else z
        prob = torch.softmax(h, dim=-1)
        return h, prob, self._metrics(arr, prob)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def run_epoch(self):
        raise NotImplementedError(
            "training epochs (_epoch_opt) come with the training slice of "
            "the port")

    @staticmethod
    def metrics_host(metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
        """Fetch a metrics dict to host numpy."""
        return {k: v.detach().cpu().numpy() for k, v in metrics.items()}

    @torch.no_grad()
    def forward(self):
        """Full-graph inference: (logits [P, V, C], prob, metrics)."""
        return self._forward_body(_Comm(), self.arr, self.weights, self.x0)
