"""The GAS engine on PyTorch (port of ``cognn_tpu/engine/gas.py``):
full-graph GCN inference and training with all P parties stacked on one
device, in the two schedules of the reference.

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

  * ``"bcsr"`` (and ``"auto"``) — the hand-written CUDA SpMM
    (:class:`cognn_tpu_torch.ops.spmm.Spmm`) over the flat (P·V)×(P·V)
    edge-count matrix; the halo exchange is part of that matrix. The name is
    the JAX package's: there it is a block-sparse Pallas kernel, here the
    structure is destination-sorted CSR. On a CPU tensor it runs the
    kernel's plain version.
  * ``"sparse"`` — plain torch port of the XLA take + segment-sum path
    (remote slots, halo transpose, local slots, masked gather).

The dense backend and the sharded mode come with later slices of the port
and raise ``NotImplementedError`` here.
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


def _plan_arrays(plan: DevicePlan,
                 t: Dict[str, torch.Tensor]) -> _PlanArrays:
    """The engine's view of :func:`plan_tensors`' output ``t`` for
    ``plan``."""
    ok = t["gather_ok"]  # [P, P, V]
    P = ok.shape[0]
    eye = torch.eye(P, dtype=torch.bool, device=ok.device)
    derived = ("n0", "gather_ok_self", "gather_ok_from")
    return _PlanArrays(**{f.name: t[f.name]
                          for f in dataclasses.fields(_PlanArrays)
                          if f.name not in derived},
                       n0=torch.from_numpy(norm0_host(plan.in_deg)).to(
                           ok.device),
                       gather_ok_self=ok[torch.arange(P), torch.arange(P)],
                       gather_ok_from=ok & ~eye[..., None])


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
    loss = torch.where(valid, loss_rows, 0.0).sum(-1) / arr.num_local

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


def stack_epochs(per_epoch: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """Per-epoch metric dicts ([P] each) -> one dict of [P, n] tensors."""
    return {k: torch.stack([m[k] for m in per_epoch], dim=1)
            for k in per_epoch[0]}


def _take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [..., P, V, D], idx [P, E] -> [..., P, E, D] with [..., p, e] =
    h[..., p, idx[p, e]] (leading axes, e.g. the share axis, ride along)."""
    p = torch.arange(h.shape[-3], device=h.device)[:, None]
    return h[..., p, idx, :]


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

    ``variant``: "opt" or "opt_inference" (CoGNN-Opt), "unopt" or
    "unopt_inference" (CoGNN); the two of a schedule run the same forward
    and epoch, as in the JAX package. ``aggregation``: "auto"/"bcsr" (the CUDA
    SpMM kernel) or "sparse" (plain torch). ``device`` defaults to "cuda" and
    raises when there is no card.
    """

    def __init__(self, plan: DevicePlan, param: GNNParam,
                 variant: str = "opt", mode: str = "stacked", seed: int = 42,
                 aggregation: str = "auto", device="cuda"):
        if variant not in ("opt", "opt_inference", "unopt",
                           "unopt_inference"):
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
        self.unopt = variant.startswith("unopt")
        self.L = param.num_layers
        # phases an epoch: L forward, then 2L (opt) or L (unopt) backward
        self.epoch_layers = (2 if self.unopt else 3) * self.L
        self.P = plan.num_parties
        tensors = plan_tensors(plan, self.device)
        self.arr = _plan_arrays(plan, tensors)
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
    @torch.no_grad()
    def run_epoch(self) -> Dict[str, torch.Tensor]:
        """One training epoch; returns its forward's per-party metrics."""
        epoch = self._epoch_unopt if self.unopt else self._epoch_opt
        self.weights, metrics = epoch(_Comm(), self.arr, self.weights,
                                      self.x0)
        return metrics

    def run_epochs(self, n: int) -> Dict[str, torch.Tensor]:
        """``n`` epochs; returns the last one's metrics."""
        metrics = None
        for _ in range(n):
            metrics = self.run_epoch()
        return metrics

    def run_epochs_scan(self, n: int) -> Dict[str, torch.Tensor]:
        """``n`` epochs; returns every epoch's metrics, each shaped [P, n]
        as the JAX package's scan returns them."""
        return stack_epochs([self.run_epoch() for _ in range(n)])

    @staticmethod
    def metrics_host(metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
        """Fetch a metrics dict to host numpy."""
        return {k: v.detach().cpu().numpy() for k, v in metrics.items()}

    @torch.no_grad()
    def forward(self):
        """Full-graph inference: (logits [P, V, C], prob, metrics)."""
        return self._forward_body(_Comm(), self.arr, self.weights, self.x0)
