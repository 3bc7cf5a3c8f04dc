"""Secret-shared GAT on PyTorch: the graph attention network of Veličković
et al. ("Graph Attention Networks", ICLR 2018, arXiv:1710.10903) trained
and served on additive shares in Z_2^64 (or Z_2^32), the P parties stacked
on one device, under the training recipe of the secret-shared GCN engine
(:mod:`cognn_tpu_torch.mpc.engine`): its prediction Apply, per-party
1/train_n scale, SGD and cross-party weight mean, its CUDA graphs and
tracer.

The attention runs over every edge of the plan (a repeated edge twice) and a
self-loop a real vertex, on the flat (party, vertex) axis of P·V rows: one
CSR by destination for the aggregation, its transpose for the backward, the
edge list for the SDDMM (:class:`_Edges`). Layer l has H heads of f
features (the hidden layers ``heads`` of ``hidden_dim / heads``,
concatenated; the last ``out_heads`` of ``num_labels``, averaged). From the
reconstructed input ``hr [P, V, d_in]``:

  * z = h·W (K3), ``[P, V, H·f]``;
  * the attention scalars ``el[v, k] = Σ_j z[v, k, j]·a_l[k, j]`` and
    ``er`` with ``a_r``, one K3 launch: z times the block-diagonal
    ``[H·f, 2H]`` of a_l and a_r;
  * the edge logits ``el[src] + er[dst]``, sharewise gathers and adds;
  * LeakyReLU and the softmax over each destination's entries;
  * ``y[v, k, :] = Σ_e α[e, k]·z[src_e, k, :]``, the ring kernel
    :class:`~cognn_tpu_torch.ops.spmm.WeightedSpmm` on the reconstructed α
    and z, truncated and re-shared;
  * ELU between layers; on the last, the mean of the heads (a public 1/H),
    then the GCN engine's prediction Apply (reveal, softmax, metrics, the
    shares of p - y on the training rows).

The backward is written by hand on shares, a layer from the top: the head
mean's (1/H to every head); ``dz`` by the transposed weighted SpMM (the
same kernel on the transposed CSR, α in its order); ``dα[e, k] =
Σ_j dy[dst_e, k, j]·z[src_e, k, j]`` by the ring SDDMM
(:meth:`~cognn_tpu_torch.ops.sddmm.Sddmm.ring`); the softmax Jacobian
``α ⊙ (dα − Σ_dst α·dα)``; LeakyReLU's public mask; the segment sums of
the logits' gradient by source (``del``) and by destination (``der``); the
attention vectors' gradients ``zᵀ·[del | der]`` and their share of ``dz``
(K3); ``dW = hᵀ·dz`` and ``dh = dz·Wᵀ`` (K3); ELU's derivative. The leaves
are W, a_l and a_r of each layer, one replica a party, each stepped as the
GCN's weights are.

Products follow :mod:`cognn_tpu_torch.mpc.protocol`: each reconstructs its
operands, computes exactly in the ring (K3, the weighted SpMM, the SDDMM,
an elementwise product), truncates and re-shares. The nonlinear ops
(LeakyReLU's sign, the edge softmax, ELU and its derivative) reconstruct,
compute in float64 on the decoded values, encode (``trunc(x·2^f)``) and
re-share with fresh randomness, as the ReLU sign and the prediction softmax
are revealed: the values of a 2PC evaluation. The softmax's denominators
are summed as integers at 2^-40 (:data:`SUM_BITS`), so that they are exact
in any order and the card's atomics give the CPU's values. Under exact
truncation every revealed value is then that of plain fixed-point
arithmetic, which ``benchmark/reference/gat_fixed.py`` computes bit for bit.

Device phases of the tracer: ``attention`` (the edge logits, LeakyReLU, the
edge softmax, their backward and the segment sums), ``wagg`` (the weighted
SpMM's launches alone, forward and transposed), ``sddmm`` (the ring
SDDMM's launches alone), and the protocol's own (``matmul``,
``trunc-reshare``, ``prng``, ``reconstruct``, ``nonlinear``, ``apply``,
``metrics``); counters ``gat.wagg.kernel`` and ``gat.sddmm.kernel`` (a
launch, once at a capture); the span ``engine.forward``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
from cognn_tpu_torch.core.ring import ring_mul, ring_sum
from cognn_tpu_torch.engine.gas import (
    _party_edges,
    _plan_arrays,
    engine_mode,
    gcn_metrics,
)
from cognn_tpu_torch.engine.graphs import (
    EngineGraphs,
    kernel_counters,
    use_graphs,
)
from cognn_tpu_torch.engine.plan import DevicePlan, plan_tensors, set_split
from cognn_tpu_torch.mpc.engine import MpcEngineBase, _MpcComm
from cognn_tpu_torch.mpc.protocol import Protocol
from cognn_tpu_torch.ops.sddmm import Sddmm
from cognn_tpu_torch.ops.spmm import WeightedSpmm
from cognn_tpu_torch.utils.glibc_rand import RAND_MAX, GlibcRand
from cognn_tpu_torch.utils.logging_utils import phase

SUM_BITS = 40  # the softmax denominators' integer resolution, 2^-40


def gat_glorot(d_in: int, heads: int, f: int, seed: int) -> tuple:
    """A layer's initial leaves, float64: ``W [d_in, heads·f]``, ``a_l``
    and ``a_r [heads, f]``, from one glibc ``rand()`` stream after
    ``srand(seed)`` (re-seeded each layer, as the GCN's ``initWeight``,
    ``optimize-gcn/gcn.h:838-852``): W's draws first, row-major, at
    Glorot's limit sqrt(6 / (d_in + heads·f)), then a_l's and a_r's at
    sqrt(6 / (f + 1)), the limit of a head's [f, 1] attention kernel;
    each draw ``rand()/RAND_MAX·2·limit − limit``."""
    rng = GlibcRand(seed)

    def draws(shape, limit):
        x = rng.rand_array(int(np.prod(shape))).astype(np.float64)
        return (x / RAND_MAX * 2.0 * limit - limit).reshape(shape)

    w = draws((d_in, heads * f), np.sqrt(6.0 / (d_in + heads * f)))
    limit = np.sqrt(6.0 / (f + 1.0))
    return w, draws((heads, f), limit), draws((heads, f), limit)


def _decode(v: torch.Tensor, f: int) -> torch.Tensor:
    """Ring values -> float64 at f fractional bits."""
    return v.to(torch.float64) / 2.0 ** f


def _encode(x: torch.Tensor, f: int, dtype: torch.dtype) -> torch.Tensor:
    """float64 -> ring values of ``dtype``: ``trunc(x·2^f)``, its low bits."""
    return torch.trunc(x * 2.0 ** f).to(torch.int64).to(dtype)


class _Edges:
    """The edges a GAT layer attends over, on the flat axis of P·V rows:
    every real edge of ``plan`` as often as it is listed, and a self-loop a
    real vertex, sorted by destination, then source. ``agg``: their CSR by
    destination; ``agg_t``: the transpose's (by source, then destination),
    whose entry i is edge ``t_order[i]``; ``sddmm``: the edge list."""

    def __init__(self, plan: DevicePlan, device: torch.device):
        P, V = plan.num_parties, plan.V
        srcs, dsts = [], []
        for p in range(P):
            s, d = _party_edges(plan, p)
            srcs.append(p * V + s)
            dsts.append(d)
        loops = np.flatnonzero(plan.vertex_mask.reshape(-1))
        src = np.concatenate(srcs + [loops])
        dst = np.concatenate(dsts + [loops])
        order = np.lexsort((src, dst))
        src, dst = src[order], dst[order]
        n = P * V
        self.n, self.count = n, len(src)
        self.src = torch.from_numpy(src).to(device)
        self.dst = torch.from_numpy(dst).to(device)
        self.agg = WeightedSpmm(src, dst, n, n, device)
        t = np.lexsort((dst, src))
        self.t_order = torch.from_numpy(t).to(device)
        self.agg_t = WeightedSpmm(dst[t], src[t], n, n, device)
        self.sddmm = Sddmm(src, dst, n, n, device)

    def counters(self) -> list:
        """The launch counters of the weighted SpMMs and the SDDMM."""
        return [(k, name) for k in (self.agg, self.agg_t, self.sddmm)
                for name in ("ring_launches", "ring32_launches")]

    def segment_sum(self, sh: torch.Tensor, index: torch.Tensor
                    ) -> torch.Tensor:
        """Shares ``[2, E, H]`` summed by ``index`` (the edges' sources or
        destinations) into ``[2, n, H]``, wrapping."""
        return sh.new_zeros(2, self.n, sh.shape[-1]).index_add_(1, index, sh)


class MpcGatEngine(MpcEngineBase):
    """Secret-shared GAT over a :class:`DevicePlan` whose features are not
    degree-scaled (``build_device_plan(..., degree_scale=False)``), the
    parties stacked on one device. ``param``: ``num_layers``, ``input_dim``,
    ``hidden_dim`` (``heads`` × f), ``num_labels``, the learning rate and
    split. ``heads`` and ``out_heads``: the hidden layers' heads
    (concatenated) and the last layer's (averaged); ``negative_slope``:
    LeakyReLU's. ``fp``, ``truncation``, ``seed`` (the Glorot leaves',
    :func:`gat_glorot`), ``prng_seed``, ``device`` and ``cuda_graphs`` as
    :class:`~cognn_tpu_torch.mpc.engine.MpcGasEngine`'s. ``mode`` other
    than "stacked" and ``aggregation`` other than "bcsr" or "auto" (the
    ring CSR kernels, which "auto" names here) raise ``ValueError``.

    ``weights_sh``: the leaves ``[W, a_l, a_r]`` a layer, in layer order,
    each ``[2, P, ...]`` (copies; assigning it drops the graphs). The
    leaves' handling, the request through the graphs, the prediction Apply,
    SGD, the weight mean and the epoch loops are :class:`MpcEngineBase`'s,
    which the GCN engine shares."""

    def __init__(self, plan: DevicePlan, param: GNNParam,
                 fp: FixedPointSpec | None = None,
                 truncation: str = "exact", seed: int = 42,
                 prng_seed: int = 0, mode: str = "stacked",
                 aggregation: str = "auto", device="cuda",
                 cuda_graphs: bool | None = None, heads: int = 8,
                 out_heads: int = 8, negative_slope: float = 0.2):
        if mode != "stacked":
            raise ValueError(f"mode {mode!r}: the GAT engine stacks the "
                             "parties on one device")
        if aggregation not in ("auto", "bcsr"):
            raise ValueError(f"aggregation {aggregation!r}: the GAT engine "
                             "aggregates with the ring CSR kernels ('bcsr' "
                             "or 'auto')")
        if param.hidden_dim % heads:
            raise ValueError(f"hidden_dim {param.hidden_dim} is not "
                             f"{heads} heads")
        self.device, _ = engine_mode(mode, None, device, plan)
        self.mode, self.aggregation = mode, "bcsr"
        set_split(plan, param.train_ratio, param.val_ratio)
        self.plan, self.param = plan, param
        self.proto = Protocol(fp or FixedPointSpec(), truncation)
        self.L = L = param.num_layers
        self.P = plan.num_parties
        self.heads = [heads] * (L - 1) + [out_heads]
        self.head_dim = ([param.hidden_dim // heads] * (L - 1)
                         + [param.num_labels])
        self.slope = float(negative_slope)
        self._slope_fp = int(np.int64(np.trunc(
            self.slope * self.proto.fp.scale)))
        tensors = plan_tensors(plan, self.device)
        self.arr = _plan_arrays(plan, tensors)
        self.edges = _Edges(plan, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(prng_seed)
        self._graphs = EngineGraphs(
            use_graphs(cuda_graphs, self.device, self.aggregation),
            kernel_counters(None) + self.edges.counters(), (self._gen,),
            self.device)
        self.comm = _MpcComm()
        dtype = self.proto.dtype
        # [H, H] identities: a layer's a_l, a_r -> its block-diagonal
        self._eye = [torch.eye(h, dtype=dtype, device=self.device)
                     for h in self.heads]

        x0_sh = self.proto.share(self._gen, tensors["features"])
        dims = param.layer_dims
        leaves = []
        for l in range(L):
            for a in gat_glorot(dims[l], self.heads[l], self.head_dim[l],
                                seed):
                leaves.append(self.proto.share(self._gen, torch.as_tensor(
                    a, dtype=torch.float32, device=self.device).expand(
                        self.P, *a.shape)))
        self.inv_train_fp = self.proto.encode_public(torch.from_numpy(
            np.float32(1.0) / plan.train_n.astype(np.float32)).to(
                self.device))
        self.install_state(x0_sh, leaves)

    def leaf_shapes(self) -> List[tuple]:
        """``(W, a_l, a_r)`` of each layer, without the share and party
        axes."""
        dims = self.param.layer_dims
        out = []
        for l in range(self.L):
            H, f = self.heads[l], self.head_dim[l]
            out += [(dims[l], H * f), (H, f), (H, f)]
        return out

    def install_state(self, x0_sh: torch.Tensor,
                      leaves: Sequence[torch.Tensor]) -> None:
        """Set the shared features ``[2, P, V, F]`` and leaves (of
        :meth:`leaf_shapes`, ``[2, P, ...]``), of the ring's dtype on this
        engine's device; reconstruct the features once (the layer-0 A
        side, and its transpose for W's gradient) and drop the graphs."""
        P, V = self.P, self.plan.V
        want = [("x0_sh", x0_sh, (2, P, V, self.param.layer_dims[0]))]
        if len(leaves) != 3 * self.L:
            raise ValueError(f"{len(leaves)} leaves for {self.L} layers")
        want += [(f"leaves[{i}]", t, (2, P, *s))
                 for i, (t, s) in enumerate(zip(leaves, self.leaf_shapes()))]
        dtype = self.proto.dtype
        for name, t, shape in want:
            if tuple(t.shape) != shape or t.dtype != dtype \
                    or t.device.type != self.device.type:
                raise ValueError(f"{name}: expected "
                                 f"{str(dtype).removeprefix('torch.')} "
                                 f"{shape} on {self.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        self.x0_sh = x0_sh
        self.weights_sh = leaves
        self.x0_prep = self.proto.prep_matmul_a(x0_sh)
        self.x0_prep_bwd = self.x0_prep.transpose(1, 2).contiguous()

    # ------------------------------------------------------------------
    def _mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Shares of the product of two reconstructed tensors, elementwise
        (broadcasting): exact in the ring, truncated and re-shared."""
        return self.proto.trunc_product(self._gen, ring_mul(a, b))

    def _attention_matrix(self, l: int, a_l: torch.Tensor,
                          a_r: torch.Tensor) -> torch.Tensor:
        """Shares ``[2, P, H·f, 2H]``: a_l's and a_r's heads on the block
        diagonals, so that z times it is ``[el | er]`` (public 0/1 entries
        times shares: linear)."""
        eye = self._eye[l][:, None, :]  # [H, 1, H]
        H, f = self.heads[l], self.head_dim[l]
        blocks = [(a[..., None] * eye).reshape(2, self.P, H * f, H)
                  for a in (a_l, a_r)]
        return torch.cat(blocks, -1)

    def _edge_softmax(self, t: torch.Tensor):
        """LeakyReLU and the softmax over each destination's entries of the
        shared logits ``t [2, E, H]``: (shares of α, the public mask of
        LeakyReLU's positive side)."""
        proto, e = self.proto, self.edges
        x = _decode(proto.reconstruct_ring(t), proto.f)
        pos = x > 0
        x = torch.where(pos, x, self.slope * x)
        index = e.dst[:, None].expand_as(x)
        top = x.new_full((e.n, x.shape[1]), -np.inf).scatter_reduce_(
            0, index, x, "amax")
        ex = torch.exp(x - top[e.dst])
        # the denominators as integers at 2^-SUM_BITS: exact in any order
        q = torch.trunc(ex * 2.0 ** SUM_BITS).to(torch.int64)
        den = q.new_zeros(e.n, x.shape[1]).index_add_(0, e.dst, q)
        alpha = ex / (den.to(torch.float64) / 2.0 ** SUM_BITS)[e.dst]
        return proto.reshare(self._gen, _encode(alpha, proto.f,
                                                proto.dtype)), pos

    def _elu(self, y: torch.Tensor):
        """ELU of the shares ``y`` and its derivative (1, or e^x below 0),
        both re-shared."""
        proto = self.proto
        with phase("nonlinear"):
            x = _decode(proto.reconstruct_ring(y), proto.f)
            up = x > 0
            out = torch.where(up, x, torch.expm1(x))
            der = torch.where(up, 1.0, torch.exp(x))
            return tuple(proto.reshare(self._gen, _encode(
                v, proto.f, proto.dtype)) for v in (out, der))

    def _layer(self, l: int, hr: torch.Tensor, leaves: Sequence):
        """Layer l's forward from the reconstructed input ``hr [P, V,
        d_in]``: the shares ``[2, P·V, H·f]`` before the activation, and
        what its backward reads."""
        proto, gen, e = self.proto, self._gen, self.edges
        W, a_l, a_r = leaves
        H = self.heads[l]
        zr = proto.reconstruct_ring(proto.matmul_prepped(gen, hr, W))
        att = self._attention_matrix(l, a_l, a_r)
        s = proto.matmul_prepped(gen, zr, att).reshape(2, e.n, 2 * H)
        with phase("attention"):
            t = s[:, e.src, :H] + s[:, e.dst, H:]
            alpha, pos = self._edge_softmax(t)
        alpha_r = proto.reconstruct_ring(alpha)
        zr = zr.reshape(e.n, -1)
        with phase("wagg"):
            y = e.agg(alpha_r, zr)
        return proto.trunc_product(gen, y), (hr, zr, att, alpha_r, pos)

    def _forward_layers(self, leaves: Sequence):
        """The forward: the last layer's head mean ``[2, P, V, C]`` and
        each layer's saved values with the shares of its ELU's derivative
        (None on the last)."""
        proto, gen, P, V = self.proto, self._gen, self.P, self.plan.V
        hr, saved = self.x0_prep, []
        for l in range(self.L):
            y, keep = self._layer(l, hr, leaves[3 * l:3 * l + 3])
            if l == self.L - 1:
                saved.append((*keep, None))
                H = self.heads[l]
                total = ring_sum(y.reshape(2, P, V, H, -1), 3)
                return proto.scale_const(gen, total, 1.0 / H), saved
            h, der = self._elu(y)
            saved.append((*keep, der))
            hr = proto.prep_matmul_a(h.reshape(2, P, V, -1))

    def _forward_body(self):
        proto = self.proto
        z, _ = self._forward_layers(self._weights_sh)
        with phase("apply"):
            z = proto.reveal(z)
            prob = torch.softmax(z, dim=-1)
            return z, prob, gcn_metrics(self.arr, prob)

    def _layer_backward(self, l: int, dy: torch.Tensor, saved, W):
        """Layer l's backward from the shares ``dy [2, P·V, H·f]`` of its
        pre-activation output's gradient: the gradients of its leaves and
        the shares of its input's gradient (None on layer 0)."""
        proto, gen, e, P, V = (self.proto, self._gen, self.edges, self.P,
                               self.plan.V)
        hr, zr, att, alpha_r, pos, _ = saved
        H = self.heads[l]
        dyr = proto.reconstruct_ring(dy)
        with phase("sddmm"):
            da = e.sddmm.ring(zr, dyr, H)
        da = proto.trunc_product(gen, da)
        with phase("attention"):
            alpha_t = alpha_r[e.t_order]  # in the transposed CSR's order
            # the softmax's Jacobian, then LeakyReLU's (public mask)
            q = self._mul(alpha_r, proto.reconstruct_ring(da))
            r = proto.sub(da, e.segment_sum(q, e.dst)[:, e.dst])
            d1 = self._mul(alpha_r, proto.reconstruct_ring(r))
            d0 = proto.trunc(gen, ring_mul(d1, self._slope_fp))
            dt = proto.select(pos, d1, d0)
            ds = torch.cat([e.segment_sum(dt, e.src),
                            e.segment_sum(dt, e.dst)], -1)
        with phase("wagg"):
            dz = e.agg_t(alpha_t, dyr)
        dz = proto.trunc_product(gen, dz)
        ds = ds.reshape(2, P, V, 2 * H)
        dz = proto.add(dz.reshape(2, P, V, -1),
                       proto.matmul(gen, ds, att.transpose(-1, -2)))
        datt = proto.matmul_prepped(
            gen, zr.reshape(P, V, -1).transpose(1, 2), ds)
        datt = datt.reshape(2, P, H, -1, 2 * H)
        d_al, d_ar = (torch.diagonal(datt[..., k * H:(k + 1) * H], dim1=2,
                                     dim2=4).transpose(-1, -2)
                      for k in (0, 1))
        hT = self.x0_prep_bwd if l == 0 else hr.transpose(1, 2)
        dW = proto.matmul_prepped(gen, hT, dz)
        dh = (None if l == 0 else
              proto.matmul(gen, dz, W.transpose(-1, -2)).reshape(2, e.n, -1))
        return (dW, d_al, d_ar), dh

    def _epoch_gat(self):
        """One training epoch on shares; returns the new leaves and the
        forward's metrics."""
        proto, gen, P, V = self.proto, self._gen, self.P, self.plan.V
        leaves = list(self._weights_sh)
        z, saved = self._forward_layers(leaves)
        pm_sh, metrics = self._predict_apply(self.arr, z)
        H = self.heads[-1]
        g = proto.scale_const(gen, pm_sh, 1.0 / H)  # the head mean's
        dy = g[:, :, :, None, :].expand(2, P, V, H, -1).reshape(
            2, self.edges.n, -1)
        new = list(leaves)
        for l in reversed(range(self.L)):
            der = saved[l][-1]
            if der is not None:
                dy = self._mul(proto.reconstruct_ring(dy),
                               proto.reconstruct_ring(der))
            grads, dy = self._layer_backward(l, dy, saved[l], leaves[3 * l])
            for i, d in enumerate(grads):
                new[3 * l + i] = self._sgd_step(leaves[3 * l + i], d)
        return new, metrics

    def _epoch_step(self) -> Dict[str, torch.Tensor]:
        """One epoch, the new leaves written into the leaf tensors in place
        after all reads (a graph's static inputs); returns its forward's
        metrics."""
        leaves, metrics = self._epoch_gat()
        with phase("apply"):
            for w, new in zip(self._weights_sh, leaves):
                w.copy_(new)
        return metrics
