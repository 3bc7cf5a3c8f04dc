"""The plain reference of the secret-shared GAT cell: the graph attention
network of Veličković et al. (ICLR 2018, arXiv:1710.10903) under CoGNN's
training recipe, computed on plain fixed-point integers in plain PyTorch,
with no shares.

Under exact truncation a secret-shared value, once reconstructed, is the
fixed-point value this module computes: every product (a matrix product,
the attention-weighted aggregation, the per-edge dot products, an
elementwise product) is exact in the ring and followed by an arithmetic
shift by the fractional bits; a sum of ring values wraps; the nonlinear ops
(LeakyReLU, the softmax over each destination's entries, ELU and its
derivative) are computed in float64 on the decoded values and encoded as
``trunc(x * 2^f)``, the softmax's denominators summed as integers at
2^-40 so that the order of the sums does not matter; and the last layer's
logits are revealed to float32 for the softmax, whose ``p - y`` is encoded
again. The partition, split, labels, loss and each party's step and weight
mean are those of :mod:`benchmark.reference.gcn_fixed`, whose helpers this
module reuses.

The model, a layer of H heads of f features: ``z = h W``; ``el = Σ_j
z[·, k, j] a_l[k, j]``, ``er`` with ``a_r``; over every drawn edge and a
self-loop a vertex, ``α = softmax_dst(LeakyReLU_0.2(el[src] + er[dst]))``;
``y[v, k] = Σ_e α[e, k] z[src_e, k]``; ELU between layers, the mean of the
heads on the last. The backward is the chain rule in the same fixed point,
with the truncations where the program truncates. Leaves: W, a_l, a_r a
layer, one replica a party, from one glibc ``rand()`` stream after
``srand(seed)`` a layer (:func:`glorot_leaves`). No dropout; the features
as drawn (row-normalised), no degree scale.

``fault`` plants a fault: ``"half_batch"`` (each party's gradient over the
first half of its training rows, the mean over that half), as
``gcn_fixed``'s; ``"softmax_sign"`` (the softmax Jacobian's sum added, not
subtracted) and ``"del_by_dst"`` (the attention vectors' gradients read the
logits' gradient summed by destination for a_l too; every other leaf's is
sound), which the tests use to show that the gradient check sees a wrong
backward.

:func:`for_config` is what the loops call.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from benchmark.harness.data import Graph, Seeds
from benchmark.reference.gcn_fixed import FixedGcn, Spec
from benchmark.reference.glibc_rand import RAND_MAX, glibc_rand

SUM_BITS = 40  # the softmax denominators' integer resolution, 2^-40
FAULTS = ("half_batch", "softmax_sign", "del_by_dst")


@dataclasses.dataclass(frozen=True)
class GatSpec:
    """What the reference needs of a GAT configuration: the GCN's
    (``dims`` input, heads x f, labels), the hidden layers' heads, the last
    layer's averaged heads, LeakyReLU's slope."""

    base: Spec
    heads: int
    out_heads: int
    slope: float

    @classmethod
    def of(cls, cfg: dict) -> "GatSpec":
        return cls(Spec.of(cfg), cfg["heads"], cfg["output_heads"],
                   cfg["negative_slope"])


def glorot_leaves(d_in: int, heads: int, f: int, seed: int) -> tuple:
    """float64 ``W [d_in, heads f]``, ``a_l``, ``a_r [heads, f]``: W's
    draws first at sqrt(6 / (d_in + heads f)), then a_l's and a_r's at
    sqrt(6 / (f + 1)), each ``rand()/RAND_MAX * 2 limit - limit``."""
    n, m = d_in * heads * f, heads * f
    x = glibc_rand(seed, n + 2 * m).astype(np.float64)
    lw = np.sqrt(6.0 / (d_in + heads * f))
    la = np.sqrt(6.0 / (f + 1.0))
    w = (x[:n] / RAND_MAX * 2.0 * lw - lw).reshape(d_in, heads * f)
    al = (x[n:n + m] / RAND_MAX * 2.0 * la - la).reshape(heads, f)
    ar = (x[n + m:] / RAND_MAX * 2.0 * la - la).reshape(heads, f)
    return w, al, ar


class GatFixed(FixedGcn):
    """The reference GAT of one graph: :meth:`epoch` runs an epoch,
    :meth:`forward` one inference, :meth:`gradients` the leaves' gradients
    of the weights it holds (the partition, split and fixed-point helpers
    of :class:`FixedGcn`)."""

    def __init__(self, graph: Graph, spec: GatSpec, glorot_seed: int,
                 device="cpu", fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        super().__init__(graph, spec.base, glorot_seed, device,
                         fault if fault == "half_batch" else None)
        self.fault = fault
        dims = spec.base.dims
        L = len(dims) - 1
        self.heads = [spec.heads] * (L - 1) + [spec.out_heads]
        self.head_dim = [dims[1] // spec.heads] * (L - 1) + [dims[-1]]
        self.slope = float(spec.slope)
        self.slope_fp = self._const(spec.slope)
        # the features as drawn: no degree scale (FixedGcn's x0 has it)
        self.x0 = self._enc(self._stack(graph.features.astype(np.float32)))
        # every drawn edge and a self-loop a vertex, by destination, source
        loops = self.pos
        src = np.concatenate([self.pos[graph.src], loops])
        dst = np.concatenate([self.pos[graph.dst], loops])
        order = np.lexsort((src, dst))
        self.N = self.P * self.Vr
        self.esrc = torch.from_numpy(src[order]).to(self.dev)
        self.edst = torch.from_numpy(dst[order]).to(self.dev)
        self.weights = []
        for l in range(L):
            for a in glorot_leaves(dims[l], self.heads[l], self.head_dim[l],
                                   glorot_seed):
                self.weights.append(self._enc(torch.from_numpy(
                    a.astype(np.float32))).expand(self.P, *a.shape)
                    .contiguous())

    # -- fixed point in float64 -------------------------------------------
    def _dec(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(torch.float64) / 2.0 ** self.f

    def _enc64(self, x: torch.Tensor) -> torch.Tensor:
        return self._wrap(torch.trunc(x * 2.0 ** self.f).to(torch.int64))

    def _segment(self, x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """Rows [E, ...] summed by ``index`` into [N, ...], wrapping."""
        out = x.new_zeros(self.N, *x.shape[1:])
        return self._wrap(out.index_add_(0, index, x))

    # -- the GAT ------------------------------------------------------------
    def _softmax(self, t: torch.Tensor):
        """LeakyReLU and the softmax by destination of the logits t [E, H]:
        (α encoded, LeakyReLU's positive side)."""
        x = self._dec(t)
        pos = x > 0
        x = torch.where(pos, x, self.slope * x)
        index = self.edst[:, None].expand_as(x)
        top = x.new_full((self.N, x.shape[1]), -np.inf).scatter_reduce_(
            0, index, x, "amax")
        ex = torch.exp(x - top[self.edst])
        q = torch.trunc(ex * 2.0 ** SUM_BITS).to(torch.int64)
        den = q.new_zeros(self.N, x.shape[1]).index_add_(0, self.edst, q)
        alpha = ex / (den.to(torch.float64) / 2.0 ** SUM_BITS)[self.edst]
        return self._enc64(alpha), pos

    def _layer(self, l: int, h: torch.Tensor, leaves: Sequence):
        W, al, ar = leaves
        H, f = self.heads[l], self.head_dim[l]
        eye = torch.eye(H, dtype=torch.int64, device=self.dev)[:, None, :]
        att = torch.cat([(a[..., None] * eye).reshape(self.P, H * f, H)
                         for a in (al, ar)], -1)
        z = self._mm(h, W)
        s = self._mm(z, att).reshape(self.N, 2 * H)
        alpha, pos = self._softmax(self._wrap(s[self.esrc, :H]
                                              + s[self.edst, H:]))
        zf = z.reshape(self.N, H, f)
        y = self._segment((zf[self.esrc] * alpha[..., None]).reshape(
            -1, H * f), self.edst)
        return self._trunc(y), (h, z, att, alpha, pos)

    def _layers(self, W: Sequence):
        """The forward: (the last layer's head mean [P, Vr, C], each
        layer's saved values and ELU's derivative, None on the last)."""
        h, saved = self.x0, []
        L = len(self.heads)
        for l in range(L):
            y, keep = self._layer(l, h, W[3 * l:3 * l + 3])
            if l == L - 1:
                saved.append((*keep, None))
                H = self.heads[l]
                total = self._wrap(y.reshape(self.P, self.Vr, H, -1).sum(2))
                return self._scale(total, self._const(1.0 / H)), saved
            x = self._dec(y)
            up = x > 0
            der = self._enc64(torch.where(up, 1.0, torch.exp(x)))
            saved.append((*keep, der))
            h = self._enc64(torch.where(up, x, torch.expm1(x))).reshape(
                self.P, self.Vr, -1)

    def _backward(self, W: Sequence, saved: list,
                  pm: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's gradient (fixed point, before the step's scales)
        from the encoded ``p - y`` on the training rows."""
        P, Vr, N = self.P, self.Vr, self.N
        H = self.heads[-1]
        g = self._scale(pm, self._const(1.0 / H))
        dy = g[:, :, None, :].expand(P, Vr, H, -1).reshape(N, -1)
        grads: List[torch.Tensor] = [None] * len(W)
        for l in reversed(range(len(self.heads))):
            h, z, att, alpha, pos, der = saved[l]
            H, f = self.heads[l], self.head_dim[l]
            if der is not None:
                dy = self._trunc(dy * der)
            dyh = dy.reshape(N, H, f)[self.edst]
            zh = z.reshape(N, H, f)[self.esrc]
            dz = self._trunc(self._segment(
                (dyh * alpha[..., None]).reshape(-1, H * f), self.esrc))
            da = self._trunc(self._wrap((dyh * zh).sum(-1)))
            q = self._trunc(alpha * da)
            s = self._segment(q, self.edst)[self.edst]
            r = self._wrap(da + s if self.fault == "softmax_sign" else da - s)
            d1 = self._trunc(alpha * r)
            dt = torch.where(pos, d1, self._trunc(d1 * self.slope_fp))
            ds = torch.cat([self._segment(dt, self.esrc),
                            self._segment(dt, self.edst)], -1).reshape(
                                P, Vr, 2 * H)
            dz = self._wrap(dz.reshape(P, Vr, -1)
                            + self._mm(ds, att.transpose(1, 2).contiguous()))
            if self.fault == "del_by_dst":  # only the attention vectors'
                ds = torch.cat([ds[..., H:], ds[..., H:]], -1)
            datt = self._mm(z.transpose(1, 2).contiguous(), ds).reshape(
                P, H, f, 2 * H)
            d_al, d_ar = (torch.diagonal(datt[..., k * H:(k + 1) * H],
                                         dim1=1, dim2=3).transpose(1, 2)
                          for k in (0, 1))
            dW = self._mm(h.transpose(1, 2).contiguous(), dz)
            grads[3 * l:3 * l + 3] = [dW, d_al.contiguous(),
                                      d_ar.contiguous()]
            if l != 0:
                dy = self._mm(dz, W[3 * l].transpose(1, 2).contiguous()
                              ).reshape(N, -1)
        return grads

    def _pass(self):
        """Forward and backward on the weights held: (loss [P], grads)."""
        W = list(self.weights)
        out, saved = self._layers(W)
        prob = torch.softmax(self._reveal(out), dim=-1)
        pm = self._enc(prob - self.y_hot) * self.train_mask[..., None]
        return self._loss(prob), self._backward(W, saved, pm)

    @torch.no_grad()
    def forward(self) -> torch.Tensor:
        """The revealed logits, float32 [P, Vr, C]."""
        return self._reveal(self._layers(self.weights)[0])

    @torch.no_grad()
    def gradients(self) -> List[np.ndarray]:
        """Each leaf's gradient of the summed cross-entropy of the training
        rows, float64 [P, ...], on the weights held (no step)."""
        return [g.cpu().to(torch.float64).numpy() / 2.0 ** self.f
                for g in self._pass()[1]]

    @torch.no_grad()
    def epoch(self) -> torch.Tensor:
        """One epoch: updates the leaves and returns each party's loss of
        its forward, float32 [P]."""
        loss, grads = self._pass()
        self.weights = [self._sgd(w, d) for w, d in zip(self.weights, grads)]
        return loss


def for_config(cfg: dict, graph: Graph, seeds: Seeds, device="cpu",
               fault: Optional[str] = None) -> GatFixed:
    """The reference of GAT configuration ``cfg`` on the benchmark's
    inputs; it sets TF32 off, as every float32 product of the reference must
    be float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return GatFixed(graph, GatSpec.of(cfg), seeds.glorot, device, fault)
