"""Secret-shared GAS engine on PyTorch (port of ``cognn_tpu/mpc/engine.py``):
full-graph GCN inference and training on additive shares in Z_2^64 (or
Z_2^32 with ``fp=FixedPointSpec(RING32, f)``), CoGNN-Opt and CoGNN (unopt),
the P parties stacked on one device or one process a party
(``mode="sharded"``).

Every vertex embedding and weight is a share pair ``int64[2, P, ...]``
(``int32`` under RING32: every share, public count, normalizer, the hoisted
agg(x0), the weight mean and the sharded ``all_reduce`` take the ring's
dtype; :mod:`cognn_tpu_torch.mpc.protocol`). Per layer l the forward runs, as
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

  * ``"bcsr"`` — the ring instantiation of the CUDA SpMM
    (:meth:`cognn_tpu_torch.ops.spmm.Spmm.ring`) over the flat (P·V)×(P·V)
    edge-count matrix, both shares in one launch. On CPU tensors it runs the
    kernel's plain version.
  * ``"dense"`` — the same matrix held dense and transposed as public ring
    counts ``Aᵀ [1, P·V, P·V]`` (built once, kept on the device), times both
    shares side by side ``[1, P·V, 2·D]``: one exact mod-2^64 product of
    :func:`cognn_tpu_torch.ops.intmatmul.ring_matmul` (K3) an aggregation,
    both shares from one read of Aᵀ (int32 and K3's 32-bit instantiation
    under RING32). The JAX package computes it on byte
    planes of the shares (``_dense_agg_shares``/``_dense_agg_shares_i8``,
    ``cognn_tpu/mpc/engine.py:195-266``) and refuses graphs whose edge
    multiplicity exceeds 256 or whose in-edge counts break its 2^24 / 2^31
    accumulation guards; K3 is exact for any 64-bit operands, so the port
    computes those graphs exactly.
  * ``"auto"`` — :func:`cognn_tpu_torch.engine.gas.select_backend`, the
    plaintext engine's rule at the share width.
  * ``"sparse"`` — plain torch port of the share OGA: masked gathers of the
    local and remote slots, ``index_add_`` segment sums of the ring's dtype
    (they wrap mod 2^bits, so the JAX package's 16-bit planes and its 2^15 segment cap have
    no counterpart), the halo transpose on the party axis, the scatter of
    mirror rows and the masked gather adds.

Sharded mode (``cognn_tpu/mpc/engine.py:310-350, 848-890``): each process
runs one party, as the plaintext engine's sharded mode does, with every share
tensor ``[2, 1, ...]``. The halo exchanges the shares with the peer axis
leading (:class:`_MpcShardedComm`); the weight mean's share sum is one
``all_reduce`` of the ring's dtype, which wraps (the JAX package's 16-bit
planes, ``_ring_psum_shares``, are a TPU workaround). ``bcsr`` is the ring SpMM on
the party's V src × P·V dst CSR, then the halo and the wrapping sum of the P
chunks received; ``dense`` is one K3 launch ``[1, P·V, V] @ [1, V, 2·D]``
with both shares side by side, then the same halo. Each process owns its own
``torch.Generator``: its shares differ from a stacked engine's, and under
exact truncation its revealed values do not.

On the card on ``bcsr`` or ``dense``, requests and epochs replay CUDA graphs
as the plaintext engine's do (:mod:`cognn_tpu_torch.engine.graphs`; sharded,
split at the halo and the weight total), with the engine's generator
registered with every graph: each replay draws fresh share randomness, as
an eager call does.

The JAX package's TPU workarounds (uint32 limbs, byte planes and their
exactness guards, ``compile_mode="phase"`` and the unopt phase programs,
``prng_impl``, the fusion barrier, the VMEM veto of wide aggregations) are
not ported. Nor is JAX's RING32 training defect (its first backward share
matmul gets a party axis of 1 against 2, ``cognn_tpu/mpc/engine.py:1218`` →
``:898``): with no limb axis, the port trains at 32 bits as at 64.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
from cognn_tpu_torch.core.ring import ring_sum
from cognn_tpu_torch.engine.gas import (
    GasEngine,
    _aggregation_operands,
    _Comm,
    _plan_arrays,
    _PlanArrays,
    _ShardedComm,
    _take_rows,
    engine_mode,
    forward_widths,
    gcn_metrics,
    select_backend,
)
from cognn_tpu_torch.engine.graphs import (
    EngineGraphs,
    kernel_counters,
    use_graphs,
)
from cognn_tpu_torch.engine.plan import DevicePlan, plan_tensors, set_split
from cognn_tpu_torch.mpc.protocol import Protocol
from cognn_tpu_torch.ops.aggregate import segment_sum_rows
from cognn_tpu_torch.ops.intmatmul import ring_matmul
from cognn_tpu_torch.utils.distributed import PartyGroup
from cognn_tpu_torch.utils.glibc_rand import glorot_init


class _MpcComm(_Comm):
    """Stacked-mode exchange of share tensors ``[2, P, ...]``."""

    def weight_total(self, w_sh: torch.Tensor) -> torch.Tensor:
        """The parties' share sum (wrapping), ``[2, 1, ...]``."""
        return ring_sum(w_sh, 1, keepdim=True)


class _MpcShardedComm(_ShardedComm):
    """Sharded-mode exchange of share tensors ``[2, 1, ...]``
    (``cognn_tpu/mpc/engine.py:341-350``): the halo of
    :class:`_ShardedComm`, the peer axis leading the exchange; both
    collectives through the engine's graphs."""

    def weight_total(self, w_sh: torch.Tensor) -> torch.Tensor:
        """The parties' share sum: one all_reduce of the ring's dtype, which
        wraps."""
        return self.graphs.collective(self.group.all_reduce_sum, w_sh)


def _party_seed(prng_seed: int, rank: int) -> int:
    """The generator seed of party ``rank``'s process: its own stream."""
    return int(np.random.SeedSequence([prng_seed, rank]).generate_state(
        1, np.uint64)[0])


class MpcGasEngine:
    """Secret-shared GAS engine over a :class:`DevicePlan`, parties stacked
    on one device; ``variant``: "opt" or "opt_inference" (CoGNN-Opt),
    "unopt" or "unopt_inference" (CoGNN); the two of a schedule run the
    same forward and epoch, as in the JAX package.

    ``fp``: fixed-point spec (64-bit ring, 16 fractional bits by default;
    ``FixedPointSpec(RING32, f)`` for int32 shares).
    ``truncation``: "exact" or "probabilistic". ``seed``: the Glorot
    weights' seed; ``prng_seed``: the share randomness' seed (one
    ``torch.Generator`` the engine owns). ``aggregation``: "bcsr" (the
    ring SpMM kernel), "dense" (K3 with the dense flat matrix), "sparse"
    (plain torch) or "auto" (the plaintext engine's ``select_backend``).
    ``nonlinear``: the sign extraction, "reconstruct" or "bitdecomp".
    ``hoist_agg`` (unopt only): compute the layer-0 aggregation agg(x0)
    once, not in every forward and epoch. ``device`` defaults to "cuda" and
    raises when there is no card. ``mode``: "stacked", or "sharded" with
    ``group``, this process's :class:`PartyGroup` (every share tensor
    ``[2, 1, ...]``, the generator seeded from ``prng_seed`` and the
    rank).

    ``cuda_graphs``: as :class:`cognn_tpu_torch.engine.gas.GasEngine`'s
    (requests and epochs replayed as CUDA graphs on the card on ``bcsr`` or
    ``dense``, sharded split at the collectives), the generator registered
    with every graph. The
    weight shares are updated in place; ``weights_sh`` hands out copies,
    and assigning it, or :meth:`install_state`, drops the graphs.
    """

    def __init__(self, plan: DevicePlan, param: GNNParam,
                 variant: str = "opt_inference",
                 fp: FixedPointSpec | None = None,
                 truncation: str = "exact", seed: int = 42,
                 prng_seed: int = 0, mode: str = "stacked",
                 aggregation: str = "auto", nonlinear: str = "reconstruct",
                 hoist_agg: bool = True, device="cuda",
                 group: PartyGroup | None = None,
                 cuda_graphs: bool | None = None):
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
        self.proto = Protocol(fp or FixedPointSpec(), truncation,
                              nonlinear=nonlinear)
        self.variant = variant
        self.unopt = variant.startswith("unopt")
        self.hoist_agg = hoist_agg
        self.L = param.num_layers
        # phases an epoch: L forward, then 2L (opt) or L (unopt) backward
        self.epoch_layers = (2 if self.unopt else 3) * self.L
        self.P = plan.num_parties
        self.Pl = self.P if self.rank is None else 1  # parties held here
        tensors = plan_tensors(plan, self.device, self.rank)
        self.arr: _PlanArrays = _plan_arrays(plan, tensors, self.rank)
        if aggregation == "auto":
            aggregation = select_backend(
                plan, self.device,
                forward_widths(param, variant, self.unopt and hoist_agg),
                ring=self.proto.ring.bits, sharded=self.rank is not None)
        self.aggregation = aggregation
        self.spmm, adj_t = _aggregation_operands(plan, aggregation,
                                                 self.rank, self.device)
        # public edge counts, transposed: [1, (P V)dst, (P V or V)src] in
        # the ring's dtype
        self.adj_t = (None if adj_t is None
                      else adj_t.to(self.proto.dtype)[None])
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(prng_seed if self.rank is None
                              else _party_seed(prng_seed, self.rank))
        self._graphs = EngineGraphs(
            use_graphs(cuda_graphs, self.device, aggregation),
            kernel_counters(self.spmm), (self._gen,), self.device)
        self.comm = (_MpcComm() if group is None
                     else _MpcShardedComm(group, self._graphs))

        # share the pre-normalized features and the Glorot weights (one
        # replica per party, as the reference keeps them)
        x0_sh = self.proto.share(self._gen, tensors["features"])
        dims = param.layer_dims
        weights_sh = [
            self.proto.share(self._gen, torch.as_tensor(
                glorot_init(dims[i], dims[i + 1], seed), dtype=torch.float32,
                device=self.device).expand(self.Pl, dims[i], dims[i + 1]))
            for i in range(self.L)
        ]
        # public fixed-point normalizers (norm0 quirk preserved), from the
        # host's float64 rsqrt: bit for bit the same on the card and the CPU
        n0_fp = self.proto.encode_public(self.arr.n0)
        # per-party gradient scale 1/train_n (gcn.h:667-676), [P] or [1]
        train_n = (plan.train_n if self.rank is None
                   else plan.train_n[self.rank:self.rank + 1])
        self.inv_train_fp = self.proto.encode_public(torch.from_numpy(
            np.float32(1.0) / train_n.astype(np.float32)).to(self.device))
        self.install_state(x0_sh, weights_sh, n0_fp)

    def install_state(self, x0_sh: torch.Tensor,
                      weights_sh: Sequence[torch.Tensor],
                      n0_fp: torch.Tensor) -> None:
        """Set the shared features ``[2, P, V, F]``, the shared weights
        (``[2, P, d_in, d_out]`` per layer) and the encoded normalizers
        ``[P, V]`` (all of the ring's dtype on this engine's device;
        sharded, this
        party's slice, P = 1), e.g. from
        :func:`cognn_tpu_torch.convert.mpc_state_from_jax`, and redo the
        layer-0 hoist (for unopt with ``hoist_agg``, agg(x0) with it; in
        sharded mode every party installs at once, since the hoist runs the
        halo). The engine keeps copies of the weights and drops its captured
        graphs."""
        P, V = self.Pl, self.plan.V
        dims = self.param.layer_dims
        want = [("x0_sh", x0_sh, (2, P, V, dims[0])),
                ("n0_fp", n0_fp, (P, V))]
        if len(weights_sh) != self.L:
            raise ValueError(f"{len(weights_sh)} weight layers for "
                             f"{self.L} layers")
        want += [(f"weights_sh[{l}]", w, (2, P, dims[l], dims[l + 1]))
                 for l, w in enumerate(weights_sh)]
        dtype = self.proto.dtype
        for name, t, shape in want:
            if tuple(t.shape) != shape or t.dtype != dtype \
                    or t.device.type != self.device.type:
                raise ValueError(f"{name}: expected "
                                 f"{str(dtype).removeprefix('torch.')} "
                                 f"{shape} on {self.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        self.x0_sh = x0_sh
        self.weights_sh = weights_sh
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

    @property
    def weights_sh(self) -> List[torch.Tensor]:
        """The weight shares, ``[2, P, d_in, d_out]`` a layer: copies, which
        no later epoch changes."""
        return [w.clone() for w in self._weights_sh]

    @weights_sh.setter
    def weights_sh(self, weights_sh) -> None:
        """Replace the weight shares by copies of ``weights_sh`` and drop
        the captured graphs, which read the old ones."""
        self._weights_sh = [w.clone(memory_format=torch.contiguous_format)
                            for w in weights_sh]
        self._graphs.clear()

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

        if self.rank is not None and (self.spmm is not None
                                      or self.adj_t is not None):
            # this party's update rows for every party, P chunks of V rows
            # (one ring SpMM, or one K3 launch on both shares side by side),
            # shipped by the halo; the P chunks received add up (wrapping)
            if self.spmm is not None:
                upd = self.spmm.ring(sh.reshape(2, V, D).contiguous())
            else:
                side = sh.reshape(2, V, D).transpose(0, 1).reshape(1, V,
                                                                   2 * D)
                upd = ring_matmul(self.adj_t, side).reshape(
                    P * V, 2, D).transpose(0, 1)
            recv = self.comm.halo(upd.reshape(2, 1, P, V, D))
            agg = proto.add(sh, ring_sum(recv, 2))
            return self._scale_rows(agg, self.n0_fp) if dest_scale else agg

        if self.spmm is not None:
            # gather/OGA/halo/gather in one kernel over the flat edge matrix
            upd = self.spmm.ring(sh.reshape(2, P * V, D))
            agg = proto.add(sh, upd.reshape(sh.shape))
            return self._scale_rows(agg, self.n0_fp) if dest_scale else agg

        if self.adj_t is not None:
            # U = A^T [sh_0 | sh_1] mod 2^bits: one K3 launch, both shares
            side = sh.reshape(2, P * V, D).transpose(0, 1).reshape(
                1, P * V, 2 * D)
            upd = ring_matmul(self.adj_t, side).reshape(P * V, 2, D)
            agg = proto.add(sh, upd.transpose(0, 1).reshape(sh.shape))
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
        recv = self.comm.halo(send.reshape(2, self.Pl, P, M, D))

        # scatter mirror rows into local order (unique targets per pair)
        tgt = torch.where(arr.recv_mask, arr.recv_target, V)
        rows = proto.mask_mul(recv, arr.recv_mask[..., None])
        rem_upd = segment_sum_rows(rows, tgt.expand(2, -1, -1, -1),
                                   V + 1)[..., :V, :]  # [2, P, Pfrom, V, D]

        # gather: base + masked adds (cond-vector-addition on shares)
        agg = proto.add(sh, proto.mask_mul(loc_upd,
                                           arr.gather_ok_self[..., None]))
        agg = proto.add(agg, ring_sum(proto.mask_mul(
            rem_upd, arr.gather_ok_from[..., None]), 2))
        return self._scale_rows(agg, self.n0_fp) if dest_scale else agg

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self):
        """Full-graph inference in share space: (revealed logits f32
        [P, V, C], prob, metrics)."""
        return self._graphs.call("forward", self._forward_body)

    def _forward_body(self):
        proto, gen = self.proto, self._gen
        h = self.x0_sh
        for l in range(self.L):
            if self.unopt:
                h = self._unopt_layer(l, h, self._weights_sh[l])[1]
            else:
                if l == 0:
                    h = proto.matmul_prepped(gen, self.x0_prep,
                                             self._weights_sh[0])
                else:
                    h = proto.matmul(gen, h, self._weights_sh[l])
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
        """Cross-party share sum (wrapping) and a public 1/P scale,
        one replica per party again (gcn.h:747-802)."""
        if self.P == 1:
            return w_sh
        total = self.comm.weight_total(w_sh)
        return self.proto.scale_const(self._gen, total,
                                      1.0 / self.P).expand_as(w_sh)

    def _epoch_opt(self):
        """One CoGNN-Opt training epoch on shares, 3L phases
        (cognn_tpu/mpc/engine.py:1176-1232); returns the new weight shares
        and the forward's metrics."""
        L, proto, gen, arr = self.L, self.proto, self._gen, self.arr
        weights = list(self._weights_sh)
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
        return weights, metrics

    def _sgd_step(self, w_sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """SGD on a layer's weight shares with the weight gradient ``d``:
        the per-party scale 1/train_n and the learning rate, each with
        truncation (gcn.h:667-678), then the weight mean."""
        proto, gen = self.proto, self._gen
        d = proto.scale_rows(gen, d, self.inv_train_fp[:, None, None])
        step = proto.scale_const(gen, d, float(self.param.learning_rate))
        return self._weight_mean(proto.sub(w_sh, step))

    def _epoch_unopt(self):
        """One CoGNN (unopt) training epoch on shares, 2L phases
        (cognn_tpu/mpc/engine.py:1234-1290); returns the new weight shares
        and the forward's metrics."""
        L, proto, gen = self.L, self.proto, self._gen
        weights = list(self._weights_sh)
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
        return weights, metrics

    def _epoch_step(self) -> Dict[str, torch.Tensor]:
        """One epoch, the new weight shares written into the weight tensors
        in place after all reads (a graph's static inputs); returns its
        forward's metrics."""
        weights, metrics = (self._epoch_unopt() if self.unopt
                            else self._epoch_opt())
        for w, new in zip(self._weights_sh, weights):
            w.copy_(new)
        return metrics

    # one epoch, n epochs, n epochs stacked: the plaintext engine's, on
    # this engine's _epoch_step (metrics from the revealed prediction)
    _epoch = GasEngine._epoch
    run_epoch = GasEngine.run_epoch
    run_epochs = GasEngine.run_epochs
    run_epochs_scan = GasEngine.run_epochs_scan

    @torch.no_grad()
    def reveal_weights(self) -> List[torch.Tensor]:
        return [self.proto.reveal(w) for w in self._weights_sh]

    metrics_host = staticmethod(GasEngine.metrics_host)
    metrics_local = staticmethod(GasEngine.metrics_local)
