"""Secret-shared GAS engine on PyTorch (port of ``cognn_tpu/mpc/engine.py``):
full-graph GCN inference and training on additive shares in Z_2^64, CoGNN-Opt
and CoGNN (unopt), all P parties stacked on one device.

Every vertex embedding and weight is a share pair ``int64[2, P, ...]``
(:mod:`cognn_tpu_torch.mpc.protocol`). Per layer l the forward runs, as
``cognn_tpu/mpc/engine.py:1127-1165`` does for the opt variants:

  * PreScatter: the shared matmul H·W, one launch of the exact mod-2^64
    kernel for all parties (layer 0 takes the hoisted reconstruct of x0);
  * the source-side ``norm0`` scale with truncation, skipped on layer 0;
  * aggregation, linear on the shares (never reconstructs), then the
    destination-side scale;
  * ReLU by sign mask, or on the last layer the reveal, softmax and metrics.

A training epoch (:meth:`MpcGasEngine.run_epoch`) runs
the schedule of the plaintext epoch (``cognn_tpu_torch/engine/gas.py``
``_epoch_opt``) on shares, as ``cognn_tpu/mpc/engine.py:1176-1232`` does: the
prediction Apply re-shares p - y, the backward matmuls and the weight
gradients go through the same exact mod-2^64 kernel (layer 0's gradient on
the hoisted reconstruct of x0ᵀ), each gradient is scaled by the public
1/train_n and the learning rate with truncation, and the weight replicas are
averaged by a wrapping share sum over the parties and a public 1/P scale.

The unopt variants (CoGNN, `original-gcn`) run the plaintext engine's unopt
schedule on shares (``cognn_tpu/mpc/engine.py:1127-1165, 1234-1290``): the
scale and the aggregation before each layer's matmul, a 2L-phase epoch. Their
layer-0 aggregation agg(x0), at the full input width, is loop-invariant: with
``hoist_agg`` (the default) it is computed once when the state is installed
and reconstructed once as the A side of layer 0's matmul and weight gradient
(``cognn_tpu/mpc/engine.py:598-633``); ``hoist_agg=False`` aggregates the
shared features in every forward and epoch, as the reference does. Under
exact truncation both give the same revealed values.

Aggregation backends (``aggregation=``):

  * ``"bcsr"`` (and ``"auto"``) — the ring instantiation of the CUDA SpMM
    (:meth:`cognn_tpu_torch.ops.spmm.Spmm.ring`) over the flat (P·V)×(P·V)
    edge-count matrix, both shares in one launch. On CPU tensors it runs the
    kernel's plain version.
  * ``"sparse"`` — plain torch port of the share OGA: masked gathers of the
    local and remote slots, int64 ``index_add_`` segment sums (they wrap mod
    2^64, so the JAX package's 16-bit planes and its 2^15 segment cap have
    no counterpart), the halo transpose on the party axis, the scatter of
    mirror rows and the masked gather adds.

The dense backend and the sharded mode come with later slices of the port
and raise ``NotImplementedError``. The JAX package's TPU workarounds (uint32
limbs, byte planes and their exactness guards, ``compile_mode="phase"`` and
the unopt phase programs, ``prng_impl``, the fusion barrier, the VMEM veto
of wide aggregations) are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
from cognn_tpu_torch.engine.gas import (
    GasEngine,
    _build_spmm_stacked,
    _Comm,
    _plan_arrays,
    _PlanArrays,
    _take_rows,
    gcn_metrics,
    stack_epochs,
)
from cognn_tpu_torch.engine.plan import DevicePlan, plan_tensors, set_split
from cognn_tpu_torch.mpc.protocol import Protocol
from cognn_tpu_torch.ops.aggregate import segment_sum_rows
from cognn_tpu_torch.utils.device import resolve_device
from cognn_tpu_torch.utils.glibc_rand import glorot_init


class MpcGasEngine:
    """Secret-shared GAS engine over a :class:`DevicePlan`, parties stacked
    on one device; ``variant``: "opt" or "opt_inference" (CoGNN-Opt),
    "unopt" or "unopt_inference" (CoGNN); the two of a schedule run the
    same forward and epoch, as in the JAX package.

    ``fp``: fixed-point spec (64-bit ring, 16 fractional bits by default).
    ``truncation``: "exact" or "probabilistic". ``seed``: the Glorot
    weights' seed; ``prng_seed``: the share randomness' seed (one
    ``torch.Generator`` the engine owns). ``aggregation``: "auto"/"bcsr"
    (the ring SpMM kernel) or "sparse" (plain torch). ``nonlinear``: the
    sign extraction, "reconstruct" or "bitdecomp". ``hoist_agg`` (unopt
    only): compute the layer-0 aggregation agg(x0) once, not in every
    forward and epoch. ``device`` defaults to "cuda" and raises when there
    is no card.
    """

    def __init__(self, plan: DevicePlan, param: GNNParam,
                 variant: str = "opt_inference",
                 fp: FixedPointSpec | None = None,
                 truncation: str = "exact", seed: int = 42,
                 prng_seed: int = 0, mode: str = "stacked",
                 aggregation: str = "auto", nonlinear: str = "reconstruct",
                 hoist_agg: bool = True, device="cuda"):
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
        self.proto = Protocol(fp or FixedPointSpec(), truncation,
                              nonlinear=nonlinear)
        self.variant = variant
        self.unopt = variant.startswith("unopt")
        self.hoist_agg = hoist_agg
        self.L = param.num_layers
        # phases an epoch: L forward, then 2L (opt) or L (unopt) backward
        self.epoch_layers = (2 if self.unopt else 3) * self.L
        self.P = plan.num_parties
        tensors = plan_tensors(plan, self.device)
        self.arr: _PlanArrays = _plan_arrays(plan, tensors)
        self.aggregation = "sparse" if aggregation == "sparse" else "bcsr"
        self.spmm = (_build_spmm_stacked(plan, self.device)
                     if self.aggregation == "bcsr" else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(prng_seed)

        # share the pre-normalized features and the Glorot weights (one
        # replica per party, as the reference keeps them)
        x0_sh = self.proto.share(self._gen, tensors["features"])
        dims = param.layer_dims
        weights_sh = [
            self.proto.share(self._gen, torch.as_tensor(
                glorot_init(dims[i], dims[i + 1], seed), dtype=torch.float32,
                device=self.device).expand(self.P, dims[i], dims[i + 1]))
            for i in range(self.L)
        ]
        # public fixed-point normalizers (norm0 quirk preserved), from the
        # host's float64 rsqrt: bit for bit the same on the card and the CPU
        n0_fp = self.proto.encode_public(self.arr.n0)
        # per-party gradient scale 1/train_n (gcn.h:667-676), [P]
        self.inv_train_fp = self.proto.encode_public(torch.from_numpy(
            np.float32(1.0) / plan.train_n.astype(np.float32)).to(
                self.device))
        self.install_state(x0_sh, weights_sh, n0_fp)

    def install_state(self, x0_sh: torch.Tensor,
                      weights_sh: Sequence[torch.Tensor],
                      n0_fp: torch.Tensor) -> None:
        """Set the shared features ``[2, P, V, F]``, the shared weights
        (``[2, P, d_in, d_out]`` per layer) and the encoded normalizers
        ``[P, V]`` (all int64 on this engine's device), e.g. from
        :func:`cognn_tpu_torch.convert.mpc_state_from_jax`, and redo the
        layer-0 hoist (for unopt with ``hoist_agg``, agg(x0) with it)."""
        P, V = self.P, self.plan.V
        dims = self.param.layer_dims
        want = [("x0_sh", x0_sh, (2, P, V, dims[0])),
                ("n0_fp", n0_fp, (P, V))]
        if len(weights_sh) != self.L:
            raise ValueError(f"{len(weights_sh)} weight layers for "
                             f"{self.L} layers")
        want += [(f"weights_sh[{l}]", w, (2, P, dims[l], dims[l + 1]))
                 for l, w in enumerate(weights_sh)]
        for name, t, shape in want:
            if tuple(t.shape) != shape or t.dtype != torch.int64 \
                    or t.device.type != self.device.type:
                raise ValueError(f"{name}: expected int64 {shape} on "
                                 f"{self.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        self.x0_sh = x0_sh
        self.weights_sh: List[torch.Tensor] = list(weights_sh)
        self.n0_fp = n0_fp
        # the layer-0 A side is loop-invariant: x0 (opt) or, hoisted,
        # agg(x0) (unopt; its randomness from the engine's generator, not
        # JAX's fixed key: exact truncation reveals the same values).
        # Reconstruct it once, and for the training variants keep its
        # transpose contiguous for the layer-0 weight gradient
        # (cognn_tpu/mpc/engine.py:587-633)
        self.x0_prep = self.x0_prep_bwd = None
        if self.unopt and not self.hoist_agg:
            return
        a0 = (self._aggregate(self.arr, x0_sh, dest_scale=True)
              if self.unopt else x0_sh)
        self.x0_prep = self.proto.prep_matmul_a(a0)
        self.x0_prep_bwd = self.x0_prep.transpose(1, 2)
        if self.variant in ("opt", "unopt"):
            self.x0_prep_bwd = self.x0_prep_bwd.contiguous()

    # ------------------------------------------------------------------
    def _scale_rows(self, sh: torch.Tensor,
                    scalars_fp: torch.Tensor) -> torch.Tensor:
        """sh [2, P, V, D] * public fp scalars [P, V] (broadcast over D)."""
        return self.proto.scale_rows(self._gen, sh, scalars_fp[..., None])

    def _aggregate(self, arr: _PlanArrays, sh: torch.Tensor,
                   dest_scale: bool) -> torch.Tensor:
        """Share-space Â application (scatter -> OGA -> halo -> gather)."""
        plan = self.plan
        V, M, P = plan.V, plan.M, plan.num_parties
        D = sh.shape[-1]
        proto = self.proto

        if self.spmm is not None:
            # gather/OGA/halo/gather in one kernel over the flat edge matrix
            upd = self.spmm.ring(sh.reshape(2, P * V, D))
            agg = proto.add(sh, upd.reshape(sh.shape))
            return self._scale_rows(agg, self.n0_fp) if dest_scale else agg

        # local slots: gather rows, mask dummies, segment-sum by destination
        lvals = proto.mask_mul(_take_rows(sh, arr.loc_src),
                               arr.loc_valid[..., None])
        loc_upd = segment_sum_rows(lvals, arr.loc_seg.expand(2, -1, -1),
                                   V + 1)[:, :, :V]

        # remote slots -> per-destination-party mirror rows
        rvals = proto.mask_mul(_take_rows(sh, arr.rem_src),
                               arr.rem_valid[..., None])
        send = segment_sum_rows(rvals, arr.rem_seg.expand(2, -1, -1),
                                P * M + 1)[:, :, :P * M]
        # halo exchange: recv[:, me, i] = send[:, i, me]
        # (mirror-update shipping, ss_…h:1089-1100)
        recv = _Comm().halo(send.reshape(2, P, P, M, D))

        # scatter mirror rows into local order (unique targets per pair)
        tgt = torch.where(arr.recv_mask, arr.recv_target, V)
        rows = proto.mask_mul(recv, arr.recv_mask[..., None])
        rem_upd = segment_sum_rows(rows, tgt.expand(2, -1, -1, -1),
                                   V + 1)[..., :V, :]  # [2, P, Pfrom, V, D]

        # gather: base + masked adds (cond-vector-addition on shares)
        agg = proto.add(sh, proto.mask_mul(loc_upd,
                                           arr.gather_ok_self[..., None]))
        agg = proto.add(agg, proto.mask_mul(
            rem_upd, arr.gather_ok_from[..., None]).sum(dim=2))
        return self._scale_rows(agg, self.n0_fp) if dest_scale else agg

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self):
        """Full-graph inference in share space: (revealed logits f32
        [P, V, C], prob, metrics)."""
        proto, gen = self.proto, self._gen
        h = self.x0_sh
        for l in range(self.L):
            if self.unopt:
                h = self._unopt_layer(l, h, self.weights_sh[l])[1]
            else:
                if l == 0:
                    h = proto.matmul_prepped(gen, self.x0_prep,
                                             self.weights_sh[0])
                else:
                    h = proto.matmul(gen, h, self.weights_sh[l])
                    h = self._scale_rows(h, self.n0_fp)
                h = self._aggregate(self.arr, h, dest_scale=True)
            if l != self.L - 1:
                h = proto.relu(h)
        z = proto.reveal(h)
        prob = torch.softmax(z, dim=-1)
        return z, prob, gcn_metrics(self.arr, prob)

    def _unopt_layer(self, l: int, h: torch.Tensor, w: torch.Tensor):
        """Layer l of the unopt forward on shares (cognn_tpu/mpc/engine.py
        :1137-1147): the source-side scale (not on layer 0), the aggregation
        at the layer's input width, then the matmul; layer 0 hoisted takes
        the prepped agg(x0) instead. Returns (agg or None, z)."""
        if l == 0 and self.x0_prep is not None:
            return None, self.proto.matmul_prepped(self._gen, self.x0_prep, w)
        if l != 0:
            h = self._scale_rows(h, self.n0_fp)
        agg = self._aggregate(self.arr, h, dest_scale=True)
        return agg, self.proto.matmul(self._gen, agg, w)

    def _predict_apply(self, arr: _PlanArrays, z_sh: torch.Tensor):
        """Prediction Apply (cognn_tpu/mpc/engine.py:1115-1125): reveal,
        softmax and the plaintext metrics; shares of p - y zeroed outside
        the local train split (gcn.h:636-641)."""
        y_hot = torch.nn.functional.one_hot(arr.labels,
                                            self.param.num_labels)
        prob, pm_sh = self.proto.softmax_pred(self._gen, z_sh, y_hot)
        pm_sh = self.proto.mask_mul(pm_sh, arr.train_mask[..., None])
        return pm_sh, gcn_metrics(arr, prob)

    def _weight_mean(self, w_sh: torch.Tensor) -> torch.Tensor:
        """Cross-party share sum (wrapping int64) and a public 1/P scale,
        one replica per party again (gcn.h:747-802)."""
        if self.P == 1:
            return w_sh
        total = w_sh.sum(dim=1, keepdim=True)
        return self.proto.scale_const(self._gen, total,
                                      1.0 / self.P).expand_as(w_sh)

    def _epoch_opt(self) -> Dict[str, torch.Tensor]:
        """One CoGNN-Opt training epoch on shares, 3L phases
        (cognn_tpu/mpc/engine.py:1176-1232); updates ``weights_sh`` and
        returns the forward's metrics."""
        L, proto, gen, arr = self.L, self.proto, self._gen, self.arr
        weights = list(self.weights_sh)
        h = None
        h_in: List[torch.Tensor] = [None] * L
        z_mask: List[torch.Tensor] = [None] * L
        metrics = None

        for l in range(L):
            h_in[l] = h  # layer 0's is x0, prepped as x0_prep_bwd
            if l == 0:
                h = proto.matmul_prepped(gen, self.x0_prep, weights[0])
            else:
                h = proto.matmul(gen, h, weights[l])
                h = self._scale_rows(h, self.n0_fp)
            h = self._aggregate(arr, h, dest_scale=True)
            if l != L - 1:
                z_mask[l] = proto.sign_mask(h)
                h = proto.mask_mul(h, z_mask[l])
            else:
                h, metrics = self._predict_apply(arr, h)

        # backward phases: the plaintext epoch's schedule on shares
        g = None
        for phase in range(L, 3 * L):
            l = L - 1 - (phase - L) // 2
            first = (phase - L) % 2 == 0
            if phase % L != 0:
                h = self._aggregate(arr, self._scale_rows(h, self.n0_fp),
                                    dest_scale=phase + 1 != 3 * L)
            if first:
                if l != L - 1:
                    h = proto.mask_mul(h, z_mask[l])
                # layer 0's delta @ W0^T (cognn_tpu/mpc/engine.py:1217-1218)
                # is never read: the epoch ends after its weight gradient.
                # Under exact truncation no value depends on the random
                # words it would have drawn.
                if l != 0:
                    g = proto.matmul(gen, h, weights[l].transpose(-1, -2))
            else:
                if l == 0:
                    d = proto.matmul_prepped(gen, self.x0_prep_bwd, h)
                else:
                    d = proto.matmul(gen, h_in[l].transpose(-1, -2), h)
                weights[l] = self._sgd_step(weights[l], d)
                h = g
        self.weights_sh = weights
        return metrics

    def _sgd_step(self, w_sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """SGD on a layer's weight shares with the weight gradient ``d``:
        the per-party scale 1/train_n and the learning rate, each with
        truncation (gcn.h:667-678), then the weight mean."""
        proto, gen = self.proto, self._gen
        d = proto.scale_rows(gen, d, self.inv_train_fp[:, None, None])
        step = proto.scale_const(gen, d, float(self.param.learning_rate))
        return self._weight_mean(proto.sub(w_sh, step))

    def _epoch_unopt(self) -> Dict[str, torch.Tensor]:
        """One CoGNN (unopt) training epoch on shares, 2L phases
        (cognn_tpu/mpc/engine.py:1234-1290); updates ``weights_sh`` and
        returns the forward's metrics."""
        L, proto, gen = self.L, self.proto, self._gen
        weights = list(self.weights_sh)
        h = self.x0_sh
        ah: List[torch.Tensor] = [None] * L  # None for layer 0 hoisted
        z_mask: List[torch.Tensor] = [None] * L
        metrics = None

        for l in range(L):
            ah[l], z = self._unopt_layer(l, h, weights[l])
            if l != L - 1:
                z_mask[l] = proto.sign_mask(z)
                h = proto.mask_mul(z, z_mask[l])
            else:
                h, metrics = self._predict_apply(self.arr, z)

        for k, l in enumerate(reversed(range(L))):
            if l != L - 1:
                h = proto.mask_mul(h, z_mask[l])
            # layer 0's delta @ W0^T (cognn_tpu/mpc/engine.py:1274) is never
            # read. Under exact truncation no value depends on the random
            # words it would have drawn.
            if l != 0:
                g = proto.matmul(gen, h, weights[l].transpose(-1, -2))
            if ah[l] is None:
                d = proto.matmul_prepped(gen, self.x0_prep_bwd, h)
            else:
                d = proto.matmul(gen, ah[l].transpose(-1, -2), h)
            weights[l] = self._sgd_step(weights[l], d)
            if l != 0:
                h = self._aggregate(self.arr, self._scale_rows(g, self.n0_fp),
                                    dest_scale=L + k + 2 != 2 * L)
        self.weights_sh = weights
        return metrics

    @torch.no_grad()
    def run_epoch(self) -> Dict[str, torch.Tensor]:
        """One secret-shared training epoch; returns its forward's
        per-party metrics (from the revealed prediction)."""
        return self._epoch_unopt() if self.unopt else self._epoch_opt()

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

    @torch.no_grad()
    def reveal_weights(self) -> List[torch.Tensor]:
        return [self.proto.reveal(w) for w in self.weights_sh]

    metrics_host = staticmethod(GasEngine.metrics_host)
