"""NumPy oracle: the exact CoGNN GAS iteration schedules in float64 (port of
``cognn_tpu/models/oracle.py``, the same float64 numpy operations in the same
order, so both packages' oracles agree bit for bit).

This is the framework's ground truth — the behavioral contract extracted from
the reference's model kernels, reproduced in plain numpy so every other
execution mode (jitted plaintext, sharded multi-host, secret-shared) can be
checked against it with allclose. It simulates all parties in one process.
It takes no device and imports no torch: a test reference, on the host.

Schedules (SURVEY.md §3.3, §7.1):

  * ``opt`` — CoGNN-Opt (`algo_kernels/vertex_centric/optimize-gcn/gcn.h`):
    epoch = 3L iterations (L fwd, 2L bwd). Weight matmul BEFORE scatter
    (message passing in hidden space), degree normalization deferred to
    gather; backward layers take two iterations (Apply-only "init" +
    aggregate/apply).
  * ``opt_inference`` — same forward, no backward
    (`optimize-gcn-inference/gcn.h`; run with max_iters = L).
  * ``unopt`` — CoGNN (`original-gcn/gcn.h`): epoch = 2L; matmul inside
    Apply, scaling inside Scatter (full-width message passing).

Faithfully preserved quirks (each cited):
  * normalizer is 0 (not 1) for degree-0 vertices in PreScatter/Gather
    (`optimize-gcn/gcn.h:219-221,535-538`), while the load-time feature
    normalization has no zero special case (`gcn.h:823-833`).
  * both the source-side and destination-side normalizations use the
    IN-degree (PreScatterComp is passed localVertexInDeg, `ss_…h:741`).
  * the final backward aggregation of an epoch skips the destination-side
    scale ((iter+1) % epochLayers == 0, `gcn.h:470-484`).
  * backward propagates g = delta @ W^T computed from the UN-aggregated
    delta, and applies the adjacency AFTER the ReLU' mask — an approximation
    of exact autodiff the reference makes (`gcn.h:651-745`, two-iteration
    backward split).
  * gradient scale 1/trainSetSize with trainSetSize = floor(V_local *
    train_ratio) of the LOCAL tile (`gcn.h:667-676`); SGD step W -= lr*d;
    then cross-party weight mean (hub at parties 0/1, `gcn.h:747-802`).
  * p - y rows are zeroed outside the train slice (first trainSetSize rows
    of the ascending-vid local order, `gcn.h:636-641`).
  * softmax p entries equal to 0 are clamped to 0.001 for the loss print
    (`gcn.h:612-617`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.graph.partition import PartyGraph
from cognn_tpu_torch.utils.glibc_rand import glorot_init


def norm0(deg: np.ndarray) -> np.ndarray:
    """(deg+1)^-1/2, but 0 for deg == 0 (`optimize-gcn/gcn.h:219-221`)."""
    deg = np.asarray(deg, np.float64)
    return np.where(deg == 0, 0.0, np.power(deg + 1.0, -0.5))


def softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def accuracy(y: np.ndarray, p: np.ndarray,
             mask: Optional[np.ndarray] = None) -> float:
    """Fraction of argmax matches, optionally over mask-true rows
    (external sci::accuracy surface, `gcn.h:620-632`)."""
    hit = np.argmax(y, axis=1) == np.argmax(p, axis=1)
    if mask is not None:
        if mask.sum() == 0:
            return 0.0
        hit = hit[mask]
    return float(hit.mean()) if len(hit) else 0.0


def cross_entropy_loss(y: np.ndarray, p: np.ndarray) -> float:
    """Mean over vertices of -sum_j y log p (p pre-clamped by caller)."""
    return float(-(y * np.log(p)).sum(axis=1).mean())


@dataclasses.dataclass
class Metrics:
    iteration: int
    loss: float
    full_acc: float
    train_acc: float
    border_train_acc: float
    test_acc: float
    border_test_acc: float
    num_vertices: int
    num_border: int

    def print_reference_format(self) -> None:
        print("--------")
        print(f"cross-entropy-loss = {self.loss:.6f}")
        print(f"full set accuracy = {self.full_acc:.6f}")
        print(f"training set accuracy = {self.train_acc:.6f}")
        print(f"border training set accuracy = {self.border_train_acc:.6f}")
        print(f"test set accuracy = {self.test_acc:.6f}")
        print(f"border test set accuracy = {self.border_test_acc:.6f}")
        print(f"the number of vertices is {self.num_vertices}, the number of "
              f"border vertices is {self.num_border}")


class _PartyState:
    def __init__(self, graph: PartyGraph, param: GNNParam, dims):
        assert graph.features is not None, "call set_vertex_data first"
        # load-time feature normalization: x *= (inDeg+1)^-1/2 (gcn.h:823-833)
        self.x0 = graph.features * np.power(
            graph.in_deg.astype(np.float64) + 1.0, -0.5)[:, None]
        self.h = self.x0.copy()
        self.weights = [glorot_init(dims[i], dims[i + 1])
                        for i in range(len(dims) - 1)]
        self.h_in: Dict[int, np.ndarray] = {}  # layer -> forward input H_l
        self.z: Dict[int, np.ndarray] = {}  # layer -> pre-activation
        self.g: Optional[np.ndarray] = None  # stored delta @ W^T
        self.y = np.zeros((graph.num_local, dims[-1]))
        self.y[np.arange(graph.num_local), graph.labels] = 1.0
        v = graph.num_local
        self.train_n = int(v * param.train_ratio)
        self.val_n = int(v * param.val_ratio)


class GasOracle:
    """All-parties-in-one-process float64 oracle for the GAS schedules."""

    def __init__(self, graphs: List[PartyGraph], param: GNNParam,
                 variant: str = "opt", verbose: bool = False):
        if variant not in ("opt", "opt_inference", "unopt",
                           "unopt_inference"):
            raise ValueError(f"unknown variant {variant}")
        self.graphs = graphs
        self.param = param
        self.variant = variant
        self.verbose = verbose
        self.n = len(graphs)
        self.L = param.num_layers
        if variant.startswith("opt"):
            self.epoch_layers = 3 * self.L
        else:
            self.epoch_layers = 2 * self.L
        dims = param.layer_dims
        self.parties = [_PartyState(g, param, dims) for g in graphs]
        self.metrics: List[Metrics] = []
        self.it = 0

    # ------------------------------------------------------------------
    # aggregation: Â-application across all parties (scatter/premerge/gather)
    # ------------------------------------------------------------------
    def _aggregate(self, dest_scale: bool) -> None:
        n = self.n
        H = [p.h for p in self.parties]
        updates: Dict[tuple, np.ndarray] = {}
        for i in range(n):
            gi = self.graphs[i]
            for j in range(n):
                blk = gi.blocks[j]
                contrib = np.zeros((blk.num_segments, H[i].shape[1]))
                real = ~blk.dummy
                # OGA prefix-network ADD == segment-sum; dummy slots are the
                # aggregation identity (ss_…h:358-398 padding semantics)
                np.add.at(contrib, blk.seg_id[real], H[i][blk.src_local[real]])
                updates[(i, j)] = contrib
        for j in range(n):
            gj = self.graphs[j]
            agg = H[j].copy()  # base value carries the self (A+I) term
            for i in range(n):
                rows = np.zeros_like(agg)
                rows[gj.recv_target_local[i]] = updates[(i, j)]
                mask = ~gj.gather_dummy[i]
                agg[mask] += rows[mask]
            if dest_scale:
                agg *= norm0(gj.in_deg)[:, None]
            self.parties[j].h = agg

    # ------------------------------------------------------------------
    def _apply_opt(self, j: int, phase: int) -> None:
        """ApplyComp of optimize-gcn (`gcn.h:515-811`)."""
        p = self.parties[j]
        g = self.graphs[j]
        L, fwd = self.L, self.L
        is_forward = phase < fwd
        if is_forward:
            layer = phase
            if phase != fwd - 1:
                p.z[layer] = p.h.copy()
                p.h = np.maximum(p.h, 0.0)
            else:
                p.z[layer] = p.h.copy()
                prob = softmax(p.h)
                self._record_metrics(j, prob)
                pm = prob - p.y
                pm[p.train_n:] = 0.0  # train rows only (gcn.h:636-641)
                p.h = pm
        else:
            layer = fwd - 1 - ((phase - fwd) // 2)
            first_of_two = ((phase - fwd) % 2) == 0
            if first_of_two:
                if layer == fwd - 1:
                    # BACKWARD_NN_INIT first: g = delta @ W^T; H unchanged
                    p.g = p.h @ p.weights[layer].T
                else:
                    # BACKWARD_NN first (WithoutAH): delta = g_in*relu'(z);
                    # g = delta @ W^T
                    delta = p.h * (p.z[layer] > 0.0)
                    p.g = delta @ p.weights[layer].T
                    p.h = delta
                return
            # second of two: weight gradient from the aggregated delta
            d = p.h_in[layer].T @ p.h
            d = d / p.train_n
            p.weights[layer] = p.weights[layer] - self.param.learning_rate * d
            p.h = p.g

    def _average_weights(self, layer: int) -> None:
        """Cross-party weight mean via the 0/1 hub (`gcn.h:747-802`)."""
        mean = np.mean([p.weights[layer] for p in self.parties], axis=0)
        for p in self.parties:
            p.weights[layer] = mean.copy()

    # ------------------------------------------------------------------
    def _record_metrics(self, j: int, prob: np.ndarray) -> None:
        p = self.parties[j]
        g = self.graphs[j]
        clamped = np.where(prob == 0.0, 0.001, prob)
        tn, vn = p.train_n, p.val_n
        border = g.border
        m = Metrics(
            iteration=self.it,
            loss=cross_entropy_loss(p.y, clamped),
            full_acc=accuracy(p.y, prob),
            train_acc=accuracy(p.y[:tn], prob[:tn]),
            border_train_acc=accuracy(p.y[:tn], prob[:tn], border[:tn]),
            test_acc=accuracy(p.y[tn + vn:], prob[tn + vn:]),
            border_test_acc=accuracy(p.y[tn + vn:], prob[tn + vn:],
                                     border[tn + vn:]),
            num_vertices=g.num_local,
            num_border=int(border.sum()),
        )
        if j == 0:
            self.metrics.append(m)
        if self.verbose:
            m.print_reference_format()

    # ------------------------------------------------------------------
    def iteration(self) -> None:
        if self.variant.startswith("opt"):
            self._iteration_opt()
        else:
            self._iteration_unopt()
        self.it += 1

    def _iteration_opt(self) -> None:
        it = self.it
        el, L, fwd = self.epoch_layers, self.L, self.L
        phase = it % el
        if phase == 0:
            for p in self.parties:
                p.h = p.x0.copy()  # epoch reset (ss_…h:695)
        if phase != 0 and phase % fwd == 0:
            # Apply-only iteration (backward; ss_…h:709-732). The weight
            # averaging lives inside ApplyComp (gcn.h:747-802), so a
            # second-of-two landing here (possible only for L > 2) still
            # averages.
            for j in range(self.n):
                self._apply_opt(j, phase)
            if ((phase - fwd) % 2) == 1 and self.n > 1:
                self._average_weights(fwd - 1 - ((phase - fwd) // 2))
            return
        is_forward = phase < fwd
        # PreScatter (gcn.h:198-255)
        for j in range(self.n):
            p = self.parties[j]
            if is_forward:
                p.h_in[phase] = p.h.copy()
                p.h = p.h @ p.weights[phase]
            if phase != 0:
                p.h = p.h * norm0(self.graphs[j].in_deg)[:, None]
        # Scatter / PreMerge / Gather (+ conditional dest scale)
        self._aggregate(dest_scale=((it + 1) % el != 0))
        # Apply
        for j in range(self.n):
            self._apply_opt(j, phase)
        # weight averaging after a completed backward layer update
        if not is_forward and ((phase - fwd) % 2) == 1 and self.n > 1:
            layer = fwd - 1 - ((phase - fwd) // 2)
            self._average_weights(layer)

    # ------------------------------------------------------------------
    # unopt (original-gcn) schedule: epoch = 2L (L fwd + L bwd);
    # matmul + fused NN ops inside Apply, message passing in full width
    # (original-gcn `gcn.h:198-300,440-631,832-845`).
    #
    # Note on normalization: original-gcn's ScatterComp scales each edge slot
    # via an external two-normalizer 2PC op whose exact semantics are not
    # recoverable in-repo (`gcn.h:243-251`; the second normalizer is zero for
    # mirror slots). We use the same mathematically consistent symmetric
    # normalization as the opt variant (source n_in pre-scale + destination
    # n_in post-scale), which preserves the documented accuracy contract
    # (CoGNN ≈ CoGNN-Opt ≈ plaintext).
    # ------------------------------------------------------------------
    def _iteration_unopt(self) -> None:
        it = self.it
        el, L = self.epoch_layers, self.L
        phase = it % el
        if phase == 0:
            for p in self.parties:
                p.h = p.x0.copy()
        is_forward = phase < L
        layer = phase if is_forward else (L - 1 - (phase - L))
        apply_only = phase != 0 and phase % L == 0  # ss_…h:709-732
        if not apply_only:
            for j in range(self.n):
                p = self.parties[j]
                if phase != 0:
                    p.h = p.h * norm0(self.graphs[j].in_deg)[:, None]
            self._aggregate(dest_scale=((it + 1) % el != 0))
        # Apply: fused forward/backward NN (original-gcn `gcn.h:440-631`)
        for j in range(self.n):
            p = self.parties[j]
            if is_forward:
                p.h_in[layer] = p.h.copy()  # "ah_t": aggregated layer input
                z = p.h @ p.weights[layer]
                p.z[layer] = z
                if layer != L - 1:
                    p.h = np.maximum(z, 0.0)
                else:
                    prob = softmax(z)
                    self._record_metrics(j, prob)
                    pm = prob - p.y
                    pm[p.train_n:] = 0.0
                    p.h = pm
            else:
                delta = p.h
                if layer != L - 1:
                    # BACKWARD_NN: delta = (aggregated g) * relu'(z_layer)
                    delta = delta * (p.z[layer] > 0.0)
                d = p.h_in[layer].T @ delta / p.train_n
                g = delta @ p.weights[layer].T
                p.weights[layer] = (p.weights[layer]
                                    - self.param.learning_rate * d)
                p.h = g
        if not is_forward and self.n > 1:
            self._average_weights(layer)

    # ------------------------------------------------------------------
    def run(self, iters: int) -> None:
        for _ in range(iters):
            self.iteration()

    def run_epochs(self, epochs: int) -> None:
        self.run(epochs * self.epoch_layers)
