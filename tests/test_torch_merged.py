"""The block-merged SpMM (K4): the tile builder, the kernel's plain version
against the JAX package's ``PallasSpmmMerged`` (interpret mode) and BCSR
reference, and the microbenchmark's check, all on the CPU.

Tolerances: against ``PallasSpmmMerged``, 1e-5 x max|ref|: both round H and
the edge counts to bf16 and form exact products, summed in f32 in another
order. Against ``bcsr_spmm_reference`` (f32 H), rel 5e-3: the bf16
rounding of H, as in tests/test_pallas_spmm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognn_tpu.ops.bcsr import BLOCK, bcsr_spmm_reference, build_bcsr
from cognn_tpu.ops.pallas_spmm import PallasSpmmMerged
from cognn_tpu_torch.ops.bcsr import build_tiles_by_dst
from cognn_tpu_torch.ops.spmm_merged import TILE, SpmmMerged
from cognn_tpu_torch.tools import bench_spmm

torch.set_num_threads(1)

CPU = torch.device("cpu")
SUM_ORDER = 1e-5  # share of max|ref|: same products, f32 sums reordered


def banded(V, E, band, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E)
    return src, (src + rng.integers(-band, band, E)) % V


def rows(n, D, seed):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def pallas_merged(src, dst, n_src, n_dst, h, G, C):
    """PallasSpmmMerged (interpret) on h [n_src, D] -> [n_dst, D]."""
    m = build_bcsr(src, dst, n_src, n_dst)
    D = h.shape[1]
    Dp = -(-D // 8) * 8
    ht = np.zeros((Dp, m.n_src_blocks * BLOCK), np.float32)
    ht[:D, :n_src] = h.T
    k = PallasSpmmMerged(m, G=G, C=C, Cd=C, interpret=True)
    return np.asarray(k(jnp.asarray(ht)))[:D, :n_dst].T


def port(src, dst, n_src, n_dst, h):
    k = SpmmMerged(src, dst, n_src, n_dst, CPU)
    out = k(torch.from_numpy(h)).numpy()
    assert k.launches == 0  # CPU tensors run the plain version
    return out


def dense_counts(src, dst, n_src, n_dst):
    a = np.zeros((n_dst, n_src), np.float32)
    np.add.at(a, (dst, src), 1.0)
    return a


def test_tiles_structure():
    V, E = 300, 1000
    src, dst = banded(V, E, 40, 1)
    src, dst = np.r_[src, src[:99]], np.r_[dst, dst[:99]]  # duplicates
    t = build_tiles_by_dst(src, dst, V, V, TILE)
    assert t.vals.sum() == len(src)  # total mass == number of edges
    nst = -(-V // TILE)
    assert len(t.tptr) == nst + 1 and t.tptr[0] == 0
    assert t.tptr[-1] == t.n_tiles
    dtile = np.repeat(np.arange(nst), np.diff(t.tptr))
    key = dtile.astype(np.int64) * nst + t.tsrc
    assert (np.diff(key) > 0).all()  # by destination tile, then source
    assert (t.vals.reshape(t.n_tiles, -1).max(1) > 0).all()  # none empty
    # destination-major tiles reassemble the [n_dst, n_src] count matrix
    a = np.zeros((nst * TILE, nst * TILE), np.float32)
    for k in range(t.n_tiles):
        i, j = dtile[k] * TILE, t.tsrc[k] * TILE
        a[i:i + TILE, j:j + TILE] += t.vals[k]
    np.testing.assert_array_equal(a[:V, :V], dense_counts(src, dst, V, V))


def test_tiles_duplicates_accumulate():
    t = build_tiles_by_dst([0, 0, 17], [1, 1, 1], 20, 20, TILE)
    np.testing.assert_array_equal(t.tptr, [0, 2, 2])
    np.testing.assert_array_equal(t.tsrc, [0, 1])
    assert t.vals[0, 1, 0] == 2.0 and t.vals[1, 1, 1] == 1.0
    assert t.vals.sum() == 3.0


@pytest.mark.parametrize("G,C", [(4, 2), (3, 4)])
def test_plain_matches_pallas_merged(G, C):
    V, E, D = 1024, 4096, 16
    src, dst = banded(V, E, 256, G)
    h = rows(V, D, C)
    got = port(src, dst, V, V, h)
    ref = pallas_merged(src, dst, V, V, h, G, C)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SUM_ORDER * np.abs(ref).max())
    m = build_bcsr(src, dst, V, V)
    ht = np.zeros((D, m.n_src_blocks * BLOCK), np.float32)
    ht[:, :V] = h.T
    f32 = bcsr_spmm_reference(m, ht)[:, :V].T
    assert np.abs(got - f32).max() / np.abs(f32).max() < 5e-3


def test_repeated_edges():
    n, D = 200, 16
    src, dst = banded(n, 600, 30, 3)
    k = len(src) // 4
    src = np.r_[src, src[:k], src[:k]]  # counts of 3
    dst = np.r_[dst, dst[:k], dst[:k]]
    h = rows(n, D, 4)
    got = port(src, dst, n, n, h)
    h16 = torch.from_numpy(h).to(torch.bfloat16).double().numpy()
    want = dense_counts(src, dst, n, n).astype(np.float64) @ h16
    assert dense_counts(src, dst, n, n).max() >= 3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_ORDER * np.abs(want).max())
    ref = pallas_merged(src, dst, n, n, h, 4, 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SUM_ORDER * np.abs(ref).max())


def test_destinations_in_block0_only():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 1024, 200)
    dst = rng.integers(0, 64, 200)
    h = rows(1024, 8, 6)
    got = port(src, dst, 1024, 1024, h)
    assert got.shape == (1024, 8)
    assert np.abs(got[64:]).max() == 0.0  # higher rows written zero
    assert np.abs(got[:64]).max() > 0.0
    ref = pallas_merged(src, dst, 1024, 1024, h, 4, 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SUM_ORDER * np.abs(ref).max())


def test_empty_graph():
    none = np.zeros(0, np.int64)
    k = SpmmMerged(none, none, 256, 200, CPU)
    assert k.n_tiles == 0 and k.tptr.numel() == -(-200 // TILE) + 1
    got = k(torch.from_numpy(rows(256, 8, 7)))
    assert got.shape == (200, 8) and not got.any()
    assert k.launches == 0


@pytest.mark.parametrize("D", [7, 3])
def test_ragged_widths(D):
    n = 1000
    src, dst = banded(n, 3000, 100, D)
    h = rows(n, D, D + 1)
    got = port(src, dst, n, n, h)
    assert got.shape == (n, D)
    ref = pallas_merged(src, dst, n, n, h, 4, 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SUM_ORDER * np.abs(ref).max())


def test_counts_round_to_bf16():
    # 257 copies of one edge: the tile keeps the exact count, the product
    # takes bf16(257) = 256, in the plain version as in the kernel
    k = SpmmMerged(np.full(257, 2), np.full(257, 1), 3, 3, CPU)
    assert k.counts[0].item() == 257.0
    h = torch.tensor([[0.0], [0.0], [1.0]])
    assert k(h)[1, 0].item() == 256.0


def test_bench_check_on_cpu():
    case = bench_spmm.setup(1024, 4096, 16, 256, device=CPU)
    errs = bench_spmm.check(case)
    assert set(errs) == set(bench_spmm.REL_ERR_BOUND)
    for name, err in errs.items():
        assert err <= bench_spmm.REL_ERR_BOUND[name], (name, err)
    assert errs["spmm_merged_bf16"] > 1e-5  # the rows were rounded to bf16
    assert (case.spmm.launches, case.merged.launches,
            case.sddmm.launches) == (0, 0, 0)


@pytest.mark.parametrize("bad", [
    torch.zeros(5, 4, dtype=torch.float64),  # dtype
    torch.zeros(6, 4),  # rows != n_src
    torch.zeros(5),  # not 2-D
    torch.zeros(4, 5).t(),  # not contiguous
    torch.zeros(5, 4, device="meta"),  # device of the structure
])
def test_wrapper_rejects(bad):
    k = SpmmMerged([0, 1], [1, 2], 5, 5, CPU)
    with pytest.raises((TypeError, ValueError)):
        k(bad)
    assert k.launches == 0
