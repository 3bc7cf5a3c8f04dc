"""The plain reference of the secret-shared GCN cells: the GCN of the
CoGNN reference (``optimize-gcn/gcn.h``), CoGNN-Opt's schedule, computed on
plain fixed-point integers in plain PyTorch, with no shares.

Under exact truncation a secret-shared value, once reconstructed, is the
fixed-point value this module computes: every product is exact in the ring
(Z_2^64, or Z_2^32) and is followed by an arithmetic shift by the
fractional bits, a sum of ring values wraps, a ReLU is a sign mask, and the
last layer's logits are revealed to float32 for the softmax, whose
``p - y`` is encoded again. So the reference works from the benchmark's
inputs alone: the degrees and normalisers from the edges, the features'
load-time scale, the Glorot weights from glibc ``rand()``, the partition
(vertex v to party v mod P, ascending ids), the positional
train/validation split, and each party's gradient, step and the mean of the
weight replicas, with their truncations in the reference's order. It
imports nothing of the program.

Values are held stacked, ``[P, Vr, D]`` with ``Vr`` the largest party's
vertex count, rows past a party's count zero. Matrix products run in
float64, exact while every partial sum stays below 2^52 (checked on each
product; above it they run in int64 on the CPU, which wraps as the ring
does).

``fault`` plants a fault that a training cell must catch, in the
reference put in the program's place: ``"half_batch"`` (each party's
gradient over the first half of its training rows, the mean taken over
that half).

:func:`for_config` is what the loops call: the reference of a
configuration, on the benchmark's inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness.data import Graph, Seeds, party_of
from benchmark.reference.glibc_rand import glorot_init

EXACT_BELOW = 2.0 ** 52  # float64 sums of integers below this are exact
FAULTS = ("half_batch",)


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference needs of a configuration."""

    parties: int
    dims: Sequence[int]  # input, hidden..., labels
    learning_rate: float
    train_ratio: float
    val_ratio: float
    frac_bits: int = 16
    ring_bits: int = 64

    @classmethod
    def of(cls, cfg: dict) -> "Spec":
        dims = ([cfg["input_dim"]] + [cfg["hidden_dim"]]
                * (cfg["num_layers"] - 1) + [cfg["num_labels"]])
        return cls(cfg["parties"], tuple(dims), cfg["learning_rate"],
                   cfg["train_ratio"], cfg["val_ratio"], cfg["frac_bits"],
                   cfg["ring_bits"])


class FixedGcn:
    """The reference GCN of one graph: :meth:`epoch` runs an epoch,
    :meth:`forward` one inference, on the weights it holds."""

    def __init__(self, graph: Graph, spec: Spec, glorot_seed: int,
                 device="cpu", fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        if spec.ring_bits not in (32, 64):
            raise ValueError(f"a ring of {spec.ring_bits} bits")
        self.spec, self.dev = spec, torch.device(device)
        self.bits, self.f = spec.ring_bits, spec.frac_bits
        P, n = spec.parties, graph.n
        parts = party_of(n, P)
        members = [np.flatnonzero(parts == p) for p in range(P)]  # ascending
        self.num_local = np.array([len(m) for m in members], np.int64)
        Vr = int(self.num_local.max())
        self.P, self.Vr = P, Vr
        pos = np.empty(n, np.int64)  # vertex -> flat stacked row p * Vr + i
        for p, m in enumerate(members):
            pos[m] = p * Vr + np.arange(len(m))
        self.pos = pos
        local = np.zeros(P * Vr, bool)
        local[pos] = True
        self.valid = torch.from_numpy(local.reshape(P, Vr)).to(self.dev)

        # public degrees: global in-degree, edges counted with multiplicity
        deg = np.bincount(graph.dst, minlength=n).astype(np.float64)
        # normaliser (deg+1)^-1/2, zero where the degree is zero (gcn.h:219)
        n0 = np.zeros(n, np.float64)
        n0[deg != 0] = 1.0 / np.sqrt(deg[deg != 0] + 1.0)
        # load-time feature scale (deg+1)^-1/2 (gcn.h:823-833)
        x0 = graph.features * np.power(deg + 1.0, -0.5)[:, None]
        self.n0 = self._enc(self._stack(n0.astype(np.float32)))[..., None]
        self.x0 = self._enc(self._stack(x0.astype(np.float32)))
        labels = self._stack(graph.labels)
        self.y_hot = torch.nn.functional.one_hot(
            labels, spec.dims[-1]).to(torch.float32)
        self.labels = labels

        # positional split in each party's ascending order (gcn.h:561-563)
        train_n = (self.num_local * spec.train_ratio).astype(np.int64)
        if fault == "half_batch":
            train_n = train_n // 2
        idx = np.arange(Vr)[None, :]
        self.train_mask = torch.from_numpy(
            idx < train_n[:, None]).to(self.dev) & self.valid
        self.inv_train = self._enc(torch.from_numpy(
            np.float32(1.0) / train_n.astype(np.float32)))[:, None, None]

        self.src = torch.from_numpy(pos[graph.src]).to(self.dev)
        self.dst = torch.from_numpy(pos[graph.dst]).to(self.dev)

        self.weights: List[torch.Tensor] = [
            self._enc(torch.from_numpy(glorot_init(
                spec.dims[l], spec.dims[l + 1], glorot_seed).astype(
                    np.float32))).expand(P, -1, -1).contiguous()
            for l in range(len(spec.dims) - 1)]

    # -- fixed point ------------------------------------------------------
    def _stack(self, a: np.ndarray) -> torch.Tensor:
        """Per-vertex array [n, ...] -> stacked [P, Vr, ...], zero rows past
        each party's vertices."""
        out = np.zeros((self.P * self.Vr, *a.shape[1:]), a.dtype)
        out[self.pos] = a
        return torch.from_numpy(out.reshape(self.P, self.Vr,
                                            *a.shape[1:])).to(self.dev)

    def _wrap(self, x: torch.Tensor) -> torch.Tensor:
        """int64 values as ring elements: two's complement of ``bits``."""
        if self.bits == 64:
            return x
        return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)

    def _wrap_int(self, v: int) -> int:
        half = 1 << (self.bits - 1)
        return ((v + half) & ((1 << self.bits) - 1)) - half

    def _enc(self, x: torch.Tensor) -> torch.Tensor:
        """float32 -> fixed point: ``x * 2^f`` in float32, truncated toward
        zero (C's cast)."""
        x = x.to(self.dev, torch.float32)
        return self._wrap(torch.trunc(x * 2.0 ** self.f).to(torch.int64))

    def _const(self, c: float) -> int:
        """A public constant's encoding, ``(int64)(c * 2^f)`` in double."""
        return self._wrap_int(int(np.int64(np.trunc(c * (1 << self.f)))))

    def _trunc(self, x: torch.Tensor) -> torch.Tensor:
        return self._wrap(self._wrap(x) >> self.f)

    def _scale(self, x: torch.Tensor, s) -> torch.Tensor:
        return self._trunc(x * s)

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact a @ b in the ring, then truncated."""
        af, bf = a.to(torch.float64), b.to(torch.float64)
        if float(torch.bmm(af.abs(), bf.abs()).max()) < EXACT_BELOW:
            prod = torch.bmm(af, bf).to(torch.int64)
        else:
            prod = torch.bmm(a.cpu(), b.cpu()).to(self.dev)
        return self._trunc(prod)

    def _reveal(self, x: torch.Tensor) -> torch.Tensor:
        """Fixed point -> float32 by the reference's formula: at 64 bits
        ``(hi * 2^32 + lo) / 2^f`` in float32 from the signed words."""
        if self.bits == 32:
            return x.to(torch.float32) / 2.0 ** self.f
        lo = x & 0xFFFFFFFF
        neg_lo = lo >> 31
        lo_signed = lo - (neg_lo << 32)
        hi = (x >> 32) + neg_lo
        hi = ((hi + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        return (hi.to(torch.float32) * 2.0 ** 32
                + lo_signed.to(torch.float32)) / 2.0 ** self.f

    def _agg(self, h: torch.Tensor) -> torch.Tensor:
        """h + the sum of h over each vertex's in-edges."""
        flat = h.reshape(self.P * self.Vr, -1)
        out = flat.clone()
        out.index_add_(0, self.dst, flat[self.src])
        return self._wrap(out).reshape(h.shape)

    # -- the GCN -------------------------------------------------------------
    def _loss(self, prob: torch.Tensor) -> torch.Tensor:
        """Each party's cross-entropy over its vertices, float32 [P]."""
        clamped = torch.where(prob == 0.0, 0.001, prob)
        rows = -(self.y_hot * torch.log(clamped)).sum(-1)
        total = torch.where(self.valid, rows, 0.0).to(torch.float64).sum(-1)
        n = torch.from_numpy(self.num_local).to(self.dev)
        return (total / n).to(torch.float32)

    def _layers(self, W):
        """The forward phases: (inputs of each layer, sign masks, the last
        layer's fixed-point output)."""
        L = len(W)
        h, h_in, mask = None, [None] * L, [None] * L
        for l in range(L):
            h_in[l] = h
            if l == 0:
                h = self._mm(self.x0, W[0])
            else:
                h = self._scale(self._mm(h, W[l]), self.n0)
            h = self._scale(self._agg(h), self.n0)
            if l != L - 1:
                mask[l] = h > 0
                h = h * mask[l]
        return h_in, mask, h

    @torch.no_grad()
    def forward(self) -> torch.Tensor:
        """The revealed logits, float32 [P, Vr, C]."""
        return self._reveal(self._layers(self.weights)[2])

    def _sgd(self, w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """A party's step (1/train_n, then the learning rate, each
        truncated), then the mean of the replicas (a wrapping sum, 1/P)."""
        d = self._scale(d, self.inv_train)
        w = self._wrap(w - self._scale(d, self._const(
            self.spec.learning_rate)))
        if self.P == 1:
            return w
        total = self._wrap(w.sum(0, keepdim=True))
        return self._scale(total, self._const(1.0 / self.P)).expand_as(
            w).contiguous()

    @torch.no_grad()
    def epoch(self) -> torch.Tensor:
        """One CoGNN-Opt epoch (3L phases); updates the weights and returns
        each party's loss of its forward, float32 [P]."""
        W = list(self.weights)
        L = len(W)
        h_in, mask, h = self._layers(W)
        prob = torch.softmax(self._reveal(h), dim=-1)
        loss = self._loss(prob)
        h = self._enc(prob - self.y_hot) * self.train_mask[..., None]
        g = None
        for phase in range(L, 3 * L):
            l = L - 1 - (phase - L) // 2
            if phase % L != 0:
                h = self._agg(self._scale(h, self.n0))
                if phase + 1 != 3 * L:
                    h = self._scale(h, self.n0)
            if (phase - L) % 2 == 0:
                if l != L - 1:
                    h = h * mask[l]
                if l != 0:
                    g = self._mm(h, W[l].transpose(1, 2))
            else:
                a = self.x0 if l == 0 else h_in[l]
                W[l] = self._sgd(W[l], self._mm(a.transpose(1, 2).contiguous(),
                                                h))
                h = g
        self.weights = W
        return loss

    def real_weights(self) -> List[np.ndarray]:
        """The weights as float64 [P, d_in, d_out] a layer."""
        return [w.cpu().to(torch.float64).numpy() / 2.0 ** self.f
                for w in self.weights]


    def readings(self, steps: int) -> Dict[str, object]:
        """What a training cell compares: each party's loss of the first
        ``steps`` epochs [P, steps], and the weights before the first,
        after the first and after ``steps`` epochs."""
        w0 = self.real_weights()
        losses = [self.epoch()]
        w1 = self.real_weights()
        losses += [self.epoch() for _ in range(steps - 1)]
        return {"loss": torch.stack(losses, 1).cpu().numpy(), "w0": w0,
                "w1": w1, "wn": self.real_weights()}

    def served(self, epochs: int) -> Tuple[np.ndarray, np.ndarray]:
        """What a serving cell compares: the logits [P, Vr, C] after
        ``epochs`` epochs, and the mask [P, Vr] of real vertices."""
        for _ in range(epochs):
            self.epoch()
        return self.forward().cpu().numpy(), self.valid.cpu().numpy()


def for_config(cfg: dict, graph: Graph, seeds: Seeds, device="cpu",
               fault: Optional[str] = None) -> FixedGcn:
    """The reference of configuration ``cfg`` on the benchmark's inputs."""
    return FixedGcn(graph, Spec.of(cfg), seeds.glorot, device, fault)
