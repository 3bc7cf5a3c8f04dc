"""The SpMM kernel's plain version vs the JAX package's BCSR reference and
Pallas kernels (interpret mode), and the wrapper's input checks.

Tolerances: against the f32 numpy reference, atol 1e-5 (the same sums in
another order). The Pallas kernels cast H to bf16 (pallas_spmm.py:35, :166),
so against them the bound is rel 5e-3, as in tests/test_pallas_spmm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognn_tpu.ops.bcsr import BLOCK, bcsr_spmm_reference, build_bcsr
from cognn_tpu.ops.pallas_spmm import PallasSpmm, PallasSpmmTiled
from cognn_tpu_torch.ops.bcsr import build_csr_by_dst
from cognn_tpu_torch.ops.spmm import Spmm

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


def test_csr_counts_duplicates():
    m = build_csr_by_dst([0, 0, 2, 1], [1, 1, 1, 0], 3, 3)
    np.testing.assert_array_equal(m.indptr, [0, 1, 3, 3])
    np.testing.assert_array_equal(m.indices, [1, 0, 2])
    np.testing.assert_array_equal(m.counts, [1, 2, 1])


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
