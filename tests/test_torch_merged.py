"""The block-merged SpMM (K4): the compressed tile builder against a plain
dense expansion, the kernel's plain version against the JAX package's
``PallasSpmmMerged`` (interpret mode) and BCSR reference, and the
microbenchmark's check, all on the CPU.

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
from cognn_tpu_torch.ops.bcsr import TILE, bf16_bits, build_tiles_by_dst
from cognn_tpu_torch.ops.spmm_merged import SpmmMerged
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


def expand(t):
    """The kernel's expansion of the compressed tiles, in numpy: a tile is
    a run of entries with one destination tile and one source tile; each
    entry writes its bf16 count at its position of the tile's zeroed 16x16
    slot. -> (destination tile, source tile, f32 [n_tiles, 16, 16])."""
    dtile = np.repeat(np.arange(len(t.dptr) - 1), np.diff(t.dptr))
    stile = t.esrc.astype(np.int64) // TILE
    w = t.entries.view(np.uint32)
    assert ((w & (TILE - 1)) == t.esrc % TILE).all()  # source columns agree
    key = (dtile * (stile.max(initial=0) + 1) + stile) * 256 + (w & 0xFF)
    assert (np.diff(key) > 0).all()  # sorted, no position twice in a tile
    start = np.diff(key // 256, prepend=-1) != 0
    tile_of = np.cumsum(start) - 1
    dense = np.zeros((start.sum(), TILE * TILE), np.float32)
    dense[tile_of, w & 0xFF] = ((w >> 16) << 16).view(np.float32)
    return dtile[start], stile[start], dense.reshape(-1, TILE, TILE)


def dense_tiles_reference(src, dst, n_src, n_dst):
    """Plain reference: the non-empty 16x16 blocks of the [n_dst, n_src]
    count matrix in (destination, source) block order, rounded to bf16 by
    torch. -> (destination tile, source tile, f32 [n, 16, 16])."""
    ndt, nst = -(-n_dst // TILE), -(-n_src // TILE)
    a = np.zeros((ndt * TILE, nst * TILE), np.float32)
    a[:n_dst, :n_src] = dense_counts(src, dst, n_src, n_dst)
    blocks = a.reshape(ndt, TILE, nst, TILE).transpose(0, 2, 1, 3)
    dt, st = np.nonzero(blocks.any(axis=(2, 3)))
    tiles = torch.from_numpy(blocks[dt, st]).to(torch.bfloat16).float()
    return dt, st, tiles.numpy()


def full_tile_graph(copies=301):
    """Two full 16x16 tiles (every source of blocks 1 and 2 into every
    destination of block 0), counts 1..300, and the pair (20, 3) (count
    68) repeated ``copies`` more times."""
    s, d = np.meshgrid(np.arange(16, 48), np.arange(16), indexing="ij")
    src, dst = s.reshape(-1), d.reshape(-1)
    rep = np.arange(len(src)) % 300  # count of edge i: 1 + i % 300
    src, dst = np.repeat(src, rep + 1), np.repeat(dst, rep + 1)
    return (np.r_[src, np.full(copies, 20)], np.r_[dst, np.full(copies, 3)],
            48, 40)


def graphs():
    V = 300
    b_src, b_dst = banded(V, 1000, 40, 1)
    rng = np.random.default_rng(5)
    yield "banded", b_src, b_dst, V, V
    yield ("duplicates", np.r_[b_src, b_src[:99], b_src[:9]],
           np.r_[b_dst, b_dst[:99], b_dst[:9]], V, V)
    yield ("full tile", *full_tile_graph())
    yield ("block0 only", rng.integers(0, 1024, 200),
           rng.integers(0, 64, 200), 1024, 1024)
    yield "empty", np.zeros(0, np.int64), np.zeros(0, np.int64), 256, 200


def check_tiles(src, dst, n_src, n_dst):
    """The compressed tiles against :func:`dense_tiles_reference`: order,
    pointers, expansion and bytes."""
    t = build_tiles_by_dst(src, dst, n_src, n_dst)
    want_dt, want_st, want = dense_tiles_reference(src, dst, n_src, n_dst)
    assert len(t.dptr) == -(-n_dst // TILE) + 1 and t.dptr[0] == 0
    assert t.dptr[-1] == len(t.entries) == len(t.esrc)
    dt, st, got = expand(t)
    np.testing.assert_array_equal(dt, want_dt)
    np.testing.assert_array_equal(st, want_st)
    np.testing.assert_array_equal(got, want)
    assert t.n_tiles == len(want)
    assert t.nbytes == 4 * (len(t.dptr) + 2 * len(t.entries))


def test_tiles_structure():
    V = 300
    src, dst = banded(V, 1000, 40, 1)
    src, dst = np.r_[src, src[:99]], np.r_[dst, dst[:99]]  # duplicates
    check_tiles(src, dst, V, V)
    t = build_tiles_by_dst(src, dst, V, V)
    assert expand(t)[2].sum() == len(src)  # total mass == number of edges


@pytest.mark.parametrize("graph", list(graphs()), ids=lambda g: g[0])
def test_tiles_expand_to_dense_reference(graph):
    check_tiles(*graph[1:])


def test_tiles_duplicates_accumulate():
    t = build_tiles_by_dst([0, 0, 17], [1, 1, 1], 20, 20)
    np.testing.assert_array_equal(t.dptr, [0, 2, 2])
    np.testing.assert_array_equal(t.esrc, [0, 17])
    _, st, d = expand(t)
    np.testing.assert_array_equal(st, [0, 1])
    assert d[0, 1, 0] == 2.0 and d[1, 1, 1] == 1.0 and d.sum() == 3.0


def test_full_tile_counts_round_to_bf16():
    src, dst, n_src, n_dst = full_tile_graph()
    t = build_tiles_by_dst(src, dst, n_src, n_dst)
    assert t.n_tiles == 2 and len(t.entries) == 512  # two full tiles
    d = expand(t)[2]
    counts = dense_counts(src, dst, n_src, n_dst)
    assert counts[3, 20] == 369 and (counts > 256).sum() > 40
    assert d[0, 3, 4] == 368.0  # bf16(369), a tie, rounds to even
    assert (d != counts[:16, 16:48].reshape(16, 2, 16).transpose(1, 0, 2)
            ).sum() > 20  # other counts above 256 round too
    np.testing.assert_array_equal(
        bf16_bits(np.array([256, 257, 301, 255], np.float32)),
        [0x4380, 0x4380, 0x4396, 0x437F])
    h = rows(n_src, 8, 9)
    got = port(src, dst, n_src, n_dst, h)
    h16 = torch.from_numpy(h).to(torch.bfloat16).double().numpy()
    c16 = torch.from_numpy(counts).to(torch.bfloat16).double().numpy()
    np.testing.assert_allclose(got, c16 @ h16, rtol=0,
                               atol=SUM_ORDER * np.abs(c16 @ h16).max())


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
    assert k.n_tiles == 0 and k.dptr.numel() == -(-200 // TILE) + 1
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
