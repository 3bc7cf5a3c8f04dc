"""The secret-shared GAT (``cognn_tpu_torch/mpc/gat.py``) on the CPU, on the
tiny graphs of ``tests/test_oracle.py``:

  * the engine against ``GatFixed``, the plain fixed-point reference: the
    forward's revealed logits, three epochs' losses and every leaf after
    each, bit for bit (exact truncation: the revealed values do not depend
    on the share randomness);
  * ``GatFixed``'s gradients against the float64 GAT differentiated by
    autograd (the independent check of the hand-written backward), within
    the fixed point's rounding at 28 fractional bits; with one sign of the
    softmax Jacobian flipped, or a_l's gradient read from the wrong segment
    sum, they are not;
  * the weighted ring SpMM's and the ring multi-head SDDMM's plain versions
    against dense products, wrapping at 64 and 32 bits;
  * the tracer's phases of an epoch; the setups the engine refuses.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness.data import Graph, seeds_of
from benchmark.reference.gat_fixed import GatFixed, GatSpec
from benchmark.systems.mpc_gat import build_engine
from cognn_tpu_torch.models.gat_reference import gat_float, train_loss
from cognn_tpu_torch.mpc.gat import MpcGatEngine
from cognn_tpu_torch.ops.sddmm import Sddmm, heads_plain, heads_shape
from cognn_tpu_torch.ops.spmm import WeightedSpmm, wsum_plain
from cognn_tpu_torch.utils import logging_utils as trace
from test_oracle import make_dataset

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                     / "configs" / "gat2_pubmed_4p_ss.json").read_text())
GRAD_FRAC = 28  # GatFixed's fractional bits in the gradient check


def tiny(parties: int, homophily: float = 0.0):
    """A tiny graph of test_oracle (40 vertices, two of them isolated, 8
    features, 3 labels) and the GAT configuration at its size."""
    src, dst, feats, labels = make_dataset(n=40, m=150, d=8, c=3,
                                           homophily=homophily)
    cfg = dict(CONFIG, num_samples=40, num_edges=len(src), input_dim=8,
               num_labels=3, parties=parties, learning_rate=0.5,
               train_ratio=0.5, val_ratio=0.2, test_ratio=0.3)
    return Graph(40, src, dst, feats, labels), cfg


def revealed(engine):
    f = engine.proto.f
    return [(w[0] + w[1]).to(torch.float64).numpy() / 2.0 ** f
            for w in engine.weights_sh]


@pytest.mark.parametrize("parties", [1, 2, 3])
def test_engine_equals_fixed_reference(parties):
    graph, cfg = tiny(parties, homophily=0.8)
    seeds = seeds_of(2 ** 33 + parties)
    engine = build_engine(cfg, graph, seeds, torch.device("cpu"))
    ref = GatFixed(graph, GatSpec.of(cfg), seeds.glorot)
    valid = ref.valid.numpy()
    order = engine.plan.vertex_order
    n = engine.plan.num_local

    def rows(z):  # the engine's [P, V, C] in the reference's layout
        out = np.zeros((parties, ref.Vr, z.shape[-1]), np.float32)
        for p in range(parties):
            out[p, order[p, :n[p]]] = z[p, :n[p]]
        return out

    z = engine.forward()[0].numpy()
    np.testing.assert_array_equal(rows(z)[valid],
                                  ref.forward().numpy()[valid])
    for _ in range(3):
        got = engine.metrics_host(engine.run_epochs_scan(1))["loss"][:, 0]
        np.testing.assert_array_equal(got, ref.epoch().numpy())
        for a, b in zip(revealed(engine), ref.real_weights()):
            np.testing.assert_array_equal(a, b)
    assert len(ref.weights) == 6


@pytest.mark.parametrize("parties", [1, 2, 3])
def test_fixed_gradients_match_autograd(parties):
    """GatFixed at 28 fractional bits (Z_2^64 holds the tiny graph's
    products at that scale): each leaf's largest gap is under 1e-4 of its
    largest float64 gradient plus 128 units of 2^-28. Every value the
    fixed-point backward reads is rounded to a unit (each truncation, the
    encoded α, ELU's derivative) and an element of a leaf's gradient sums
    up to a few hundred such products here; the logits are revealed to
    float32 for the softmax (2^-24 of p - y). The attention vectors' largest
    gradients are 3e-3 to 5e-2, so their bound is under 3e-4 of them. On
    these graphs the sound backward reads at most an eighth of the bound.
    With one sign of the softmax Jacobian flipped every leaf reads
    thousands of times it; with a_l's gradient read from the logits'
    gradient summed by destination (a fault in the attention vectors'
    gradients alone) both a_l leaves do, and every other leaf passes."""
    graph, cfg = tiny(parties)
    cfg = dict(cfg, frac_bits=GRAD_FRAC)
    unit = 2.0 ** -GRAD_FRAC
    seeds = seeds_of(7 + parties)

    def ratios(fault):
        ref = GatFixed(graph, GatSpec.of(cfg), seeds.glorot, fault=fault)
        fixed = ref.gradients()

        def dec(v):
            return v.to(torch.float64) * unit
        leaves = [dec(w).requires_grad_() for w in ref.weights]
        logits = gat_float(dec(ref.x0), ref.esrc, ref.edst, leaves,
                           ref.heads, ref.slope)
        loss = train_loss(logits, ref.labels,
                          ref.train_mask.to(torch.float64))
        want = torch.autograd.grad(loss, leaves)
        return np.array([np.abs(a - b.numpy()).max()
                         / (1e-4 * np.abs(b.numpy()).max() + 128 * unit)
                         for a, b in zip(fixed, want)])

    assert ratios(None).max() <= 1.0
    assert ratios("softmax_sign").min() > 1.0
    # the leaves W, a_l, a_r of each layer: a_l's are 1 and 4
    wrong = ratios("del_by_dst") > 1.0
    assert wrong.tolist() == [False, True, False, False, True, False]


def wrapping(dtype):
    """numpy's unsigned type of the ring, whose products and sums wrap."""
    return np.uint64 if dtype == torch.int64 else np.uint32


def ring_values(rng, shape, dtype):
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max, shape,
                                         dtype=np.int64)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_weighted_spmm_plain_against_dense(dtype):
    """Full-range ring values (every product wraps), repeated edges, an
    empty row; the wrapper takes the plain version on the CPU."""
    rng = np.random.default_rng(1)
    n_src, n_dst, heads, f = 9, 7, 3, 4
    src = rng.integers(0, n_src, 40)
    dst = np.sort(rng.integers(0, n_dst - 1, 40))  # the last row empty
    w = ring_values(rng, (40, heads), dtype)
    h = ring_values(rng, (n_src, heads * f), dtype)
    u = wrapping(dtype)
    want = np.zeros((n_dst, heads * f), u)
    for k in range(heads):
        a = np.zeros((n_dst, n_src), u)
        np.add.at(a, (dst, src), w[:, k].numpy().astype(u))
        want[:, k * f:(k + 1) * f] = a @ h[:, k * f:(k + 1) * f].numpy(
        ).astype(u)
    k = WeightedSpmm(src, dst, n_src, n_dst, torch.device("cpu"))
    got = k(w, h)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy().astype(u), want)
    np.testing.assert_array_equal(
        wsum_plain(k.indptr, k.indices, w, h).numpy(), got.numpy())
    with pytest.raises(ValueError, match="sorted by destination"):
        WeightedSpmm(src, dst[::-1], n_src, n_dst, torch.device("cpu"))
    with pytest.raises(ValueError, match="heads"):
        k(w, h[:, :10].contiguous())


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_ring_sddmm_plain_against_dense(dtype):
    """Per edge and head, the head's block of the dense product ``a_k
    b_kᵀ`` at (src, dst), wrapping; repeated edges and n_src != n_dst."""
    rng = np.random.default_rng(2)
    n_src, n_dst, heads, f = 6, 10, 4, 3
    src = rng.integers(0, n_src, 50)
    dst = rng.integers(0, n_dst, 50)
    a = ring_values(rng, (n_src, heads * f), dtype)
    b = ring_values(rng, (n_dst, heads * f), dtype)
    u = wrapping(dtype)
    want = np.stack([(a[:, k * f:(k + 1) * f].numpy().astype(u)
                      @ b[:, k * f:(k + 1) * f].numpy().astype(u).T)[src, dst]
                     for k in range(heads)], 1)
    k = Sddmm(src, dst, n_src, n_dst, "cpu")
    got = k.ring(a, b, heads)
    assert got.dtype == dtype and got.shape == (50, heads)
    np.testing.assert_array_equal(got.numpy().astype(u), want)
    np.testing.assert_array_equal(
        heads_plain(k.src, k.dst, a, b, heads).numpy(), got.numpy())
    with pytest.raises(ValueError, match="heads"):
        k.ring(a, b, 5)


def test_heads_shape():
    """16-byte loads where the heads split into them; a head's lanes cover
    it (GAT's f = 8 and 3 at 64 and 32 bits)."""
    assert heads_shape(8, 8, (0, 16)) == (2, 4)
    assert heads_shape(3, 8, (0, 16)) == (1, 4)
    assert heads_shape(8, 4, (0, 16)) == (4, 2)
    assert heads_shape(8, 8, (8, 16)) == (1, 8)
    assert heads_shape(64, 8, (0, 0)) == (2, 32)
    with pytest.raises(ValueError, match="at most 32"):
        heads_shape(65, 8, (0, 0))


def test_epoch_phases():
    """An epoch's phase table holds the GAT's phases beside the
    protocol's (the tracer on, on the CPU's clock)."""
    graph, cfg = tiny(2)
    engine = build_engine(cfg, graph, seeds_of(3), torch.device("cpu"))
    with trace.tracing():
        trace.reset()
        engine.run_epochs_scan(1)
        (table,) = trace.collect()
        trace.reset()
    assert {"attention", "wagg", "sddmm", "matmul", "trunc-reshare",
            "prng", "apply", "metrics"} <= set(table["ns"])


def test_refused_setups():
    graph, cfg = tiny(2)
    engine = build_engine(cfg, graph, seeds_of(3), torch.device("cpu"))
    for kw, match in ((dict(mode="sharded"), "stacks the parties"),
                      (dict(aggregation="sparse"), "ring CSR kernels"),
                      (dict(heads=5), "not 5 heads")):
        with pytest.raises(ValueError, match=match):
            MpcGatEngine(engine.plan, engine.param, device="cpu", **kw)
    with pytest.raises(ValueError, match="leaves"):
        engine.install_state(engine.x0_sh, engine.weights_sh[:3])
