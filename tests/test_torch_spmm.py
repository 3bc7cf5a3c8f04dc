"""The SpMM kernel's plain version vs the JAX package's BCSR reference and
Pallas kernels (interpret mode) and vs numpy oracles on the kernels' edge
cases, the wrapper's choice of kernel instantiation, and its input checks.

Tolerances: against the f32 numpy reference, atol 1e-5 (the same sums in
another order). The Pallas kernels cast H to bf16 (pallas_spmm.py:35, :166),
so against them the bound is rel 5e-3, as in tests/test_pallas_spmm.py.
Against the float64 oracle, rtol/atol 1e-5 (f32 sums); against the uint64
oracle, equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognn_tpu.ops.bcsr import BLOCK, bcsr_spmm_reference, build_bcsr
from cognn_tpu.ops.pallas_spmm import PallasSpmm, PallasSpmmTiled
from cognn_tpu_torch.core.ring import ring_from_u64, ring_to_u64
from cognn_tpu_torch.ops.bcsr import build_csr_by_dst
from cognn_tpu_torch.ops.spmm import Spmm, launch_shape
from cognn_tpu_torch.tools.sweep_spmm import VARIANTS, variant_source

torch.set_num_threads(1)

CPU = torch.device("cpu")


def edges(kind, n_src, n_dst, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    src = rng.integers(0, n_src, 900)
    # dst in the lower two thirds only: the rest are empty destination rows
    dst = rng.integers(0, 2 * n_dst // 3, 900)
    # repeat a slice so (src, dst) duplicates accumulate into counts
    return np.concatenate([src, src[:100]]), np.concatenate([dst, dst[:100]])


def jax_out(kernel, h, n_dst):
    """Run a JAX kernel on h [n_src, D]: pad to its layout, return [n_dst, D]."""
    n_src, D = h.shape
    Dp = -(-D // 8) * 8
    ht = np.zeros((Dp, kernel.n_src_blocks * BLOCK), np.float32)
    ht[:D, :n_src] = h.T
    return np.asarray(kernel(jnp.asarray(ht)))[:D, :n_dst].T


CASES = [(kind, D) for kind in ("random", "empty") for D in (3, 16)]


@pytest.mark.parametrize("kind,D", CASES)
def test_plain_matches_jax(kind, D):
    n_src, n_dst = 300, 260
    src, dst = edges(kind, n_src, n_dst)
    h = np.random.default_rng(1).normal(size=(n_src, D)).astype(np.float32)
    got = Spmm(src, dst, n_src, n_dst, CPU)(torch.from_numpy(h)).numpy()
    assert got.shape == (n_dst, D)
    assert not got[2 * n_dst // 3:].any()  # rows without edges are zero

    m = build_bcsr(src, dst, n_src, n_dst)
    ht = np.zeros((D, m.n_src_blocks * BLOCK), np.float32)
    ht[:, :n_src] = h.T
    ref = bcsr_spmm_reference(m, ht)[:, :n_dst].T
    np.testing.assert_allclose(got, ref, atol=1e-5)

    scale = max(np.abs(ref).max(), 1.0)
    for kernel in (PallasSpmm(m, interpret=True),
                   PallasSpmmTiled(m, G=4, C=2, Cd=2, interpret=True)):
        pal = jax_out(kernel, h, n_dst)
        assert np.abs(got - pal).max() / scale < 5e-3, type(kernel).__name__


# rows: empty first and last, one below / at / above batch sizes 4, 8, 16
# and 32, and a hub of 1500 entries
EDGE_DEGREES = (0, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 1500, 0)


@pytest.mark.parametrize("dtype", ["f32", "i64"])
def test_plain_matches_oracle_edge_rows(dtype):
    n_src, D = 1601, 3
    rng = np.random.default_rng(11)
    src = np.concatenate([rng.choice(n_src, d, replace=False)
                          for d in EDGE_DEGREES])
    dst = np.repeat(np.arange(len(EDGE_DEGREES)), EDGE_DEGREES)
    src, dst = np.concatenate([src, src[:40]]), np.concatenate([dst, dst[:40]])
    k = Spmm(src, dst, n_src, len(EDGE_DEGREES), CPU)
    np.testing.assert_array_equal(np.diff(k.indptr.numpy()), EDGE_DEGREES)
    if dtype == "f32":
        h = rng.standard_normal((n_src, D)).astype(np.float32)
        want = np.zeros((len(EDGE_DEGREES), D))
        np.add.at(want, dst, h[src].astype(np.float64))
        got = k(torch.from_numpy(h)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        h = rng.integers(0, 1 << 64, (2, n_src, D), dtype=np.uint64)
        want = np.zeros((2, len(EDGE_DEGREES), D), np.uint64)
        for s_, d_ in zip(src, dst):
            want[:, d_] += h[:, s_]
        got = ring_to_u64(k.ring(ring_from_u64(h, device="cpu")))
        np.testing.assert_array_equal(got, want)
    assert not got[..., [0, -1], :].any()
    assert k.launches == 0 and k.ring_launches == 0


@pytest.mark.parametrize("d,elem,ptrs,shares,want", [
    (16, 4, (256, 512), (), (4, 4)),  # f32 D=16: 4 lanes x float4
    (16, 4, (260, 512), (), (1, 16)),  # h one element into its storage
    (16, 4, (256, 520), (), (1, 16)),  # out misaligned
    (7, 4, (256, 512), (), (1, 8)),  # 28-byte rows: scalar
    (3, 4, (256, 512), (), (1, 4)),
    (1, 4, (256, 512), (), (1, 1)),
    (12, 4, (256, 512), (), (4, 4)),  # 3 loads: 4 lanes
    (33, 4, (256, 512), (), (1, 32)),  # two chunks of 32 lanes
    (64, 4, (256, 512), (), (4, 16)),
    (16, 8, (256, 512), (2720 * 16, 2720 * 16), (2, 8)),  # ring D=16
    (16, 8, (264, 512), (2720 * 16, 2720 * 16), (1, 16)),
    (7, 8, (256, 512), (3001 * 7, 16 * 7), (1, 8)),  # odd share stride
    (3, 8, (256, 512), (19744 * 3, 19744 * 3), (1, 4)),
    (2, 8, (256, 512), (3, 4), (1, 2)),  # share 1 of h misaligned
    (64, 8, (256, 512), (64, 64), (2, 32)),
])
def test_launch_shape(d, elem, ptrs, shares, want):
    assert launch_shape(d, elem, ptrs, shares) == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sweep_variant_edits_apply(variant):
    """Every variant the sweep tool builds still finds its edits' targets
    in the kernel source, each exactly once."""
    edits, _ = VARIANTS[variant]
    src = variant_source(edits)
    assert all(new in src for _, new in edits)


def test_csr_counts_duplicates():
    m = build_csr_by_dst([0, 0, 2, 1], [1, 1, 1, 0], 3, 3)
    np.testing.assert_array_equal(m.indptr, [0, 1, 3, 3])
    np.testing.assert_array_equal(m.indices, [1, 0, 2])
    np.testing.assert_array_equal(m.counts, [1, 2, 1])


def test_edge_list_expands_counts():
    k = Spmm([0, 0, 2, 1], [1, 1, 1, 0], 3, 3, CPU)
    src, dst = k.edge_list()
    np.testing.assert_array_equal(src, [1, 0, 0, 2])
    np.testing.assert_array_equal(dst, [0, 1, 1, 1])


def test_csr_rejects_out_of_range():
    with pytest.raises(ValueError):
        build_csr_by_dst([0, 3], [0, 0], 3, 3)


@pytest.mark.parametrize("bad", [
    torch.zeros(5, 4, dtype=torch.float64),  # dtype
    torch.zeros(6, 4),  # rows != n_src
    torch.zeros(5),  # not 2-D
    torch.zeros(4, 5).t(),  # not contiguous
    torch.zeros(5, 4, device="meta"),  # device of the structure
])
def test_wrapper_rejects(bad):
    k = Spmm([0, 1], [1, 2], 5, 5, CPU)
    with pytest.raises((TypeError, ValueError)):
        k(bad)
    assert k.launches == 0
