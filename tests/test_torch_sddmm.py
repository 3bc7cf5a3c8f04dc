"""The SDDMM (K5): the kernel's plain version against the JAX package's
``PallasSddmm`` (interpret mode, then ``edge_scores``) and
``sddmm_reference``, the wrapper's edge order, choice of kernel
instantiation and input checks, and the sweep tool's source edits, on the
CPU.

Tolerance: 1e-5 x max|ref|, the same f32 products summed in another order
(the Pallas kernel contracts the feature axis on the matrix unit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognn_tpu.ops.bcsr import BLOCK, build_bcsr
from cognn_tpu.ops.pallas_sddmm import PallasSddmm, sddmm_reference
from cognn_tpu_torch.ops import sddmm as sddmm_mod
from cognn_tpu_torch.ops.sddmm import Sddmm, launch_shape, sddmm_plain
from cognn_tpu_torch.tools.sweep_sddmm import VARIANTS
from cognn_tpu_torch.tools.sweep_spmm import variant_source

torch.set_num_threads(1)

CPU = torch.device("cpu")
SUM_ORDER = 1e-5  # share of max|ref|: same products, f32 sums reordered


def rows(n, D, seed):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def scores(src, dst, n_src, n_dst, a, b):
    k = Sddmm(src, dst, n_src, n_dst, CPU)
    before = sddmm_mod.launches
    out = k(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    # CPU tensors run the plain version
    assert (k.launches, sddmm_mod.launches) == (0, before)
    return out


def test_plain_matches_pallas_sddmm():
    V, E, D = 512, 3000, 16
    rng = np.random.default_rng(17)
    src, dst = rng.integers(0, V, E), rng.integers(0, V, E)
    # dedupe (block values must be 0/1 for the mask semantics), as
    # tests/test_pallas_spmm.py does
    _, idx = np.unique(src * V + dst, return_index=True)
    src, dst = src[idx], dst[idx]
    a, b = rows(V, D, 1), rows(V, D, 2)
    got = scores(src, dst, V, V, a, b)
    assert got.shape == (len(src),)

    m = build_bcsr(src, dst, V, V)
    pad = m.n_src_blocks * BLOCK
    at = np.zeros((D, pad), np.float32)
    bt = np.zeros((D, pad), np.float32)
    at[:, :V], bt[:, :V] = a.T, b.T
    k = PallasSddmm(m, interpret=True)
    blocks = k(jnp.asarray(at), jnp.asarray(bt))
    ref = np.asarray(k.edge_scores(blocks, src, dst))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SUM_ORDER * np.abs(ref).max())
    ref = np.asarray(sddmm_reference(src, dst, a, b))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SUM_ORDER * np.abs(ref).max())


@pytest.mark.parametrize("D", [1, 3, 40])
def test_duplicates_scored_per_copy_in_input_order(D):
    n_src, n_dst = 70, 50
    rng = np.random.default_rng(D)
    src, dst = rng.integers(0, n_src, 300), rng.integers(0, n_dst, 300)
    src, dst = np.r_[src, src[:40]], np.r_[dst, dst[:40]]  # copies
    a, b = rows(n_src, D, 3), rows(n_dst, D, 4)
    got = scores(src, dst, n_src, n_dst, a, b)
    assert got.shape == (340,)
    np.testing.assert_array_equal(got[300:], got[:40])
    want = (a[src].astype(np.float64) * b[dst]).sum(-1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_ORDER * np.abs(want).max())


def test_empty_edge_list():
    none = np.zeros(0, np.int64)
    got = scores(none, none, 4, 3, rows(4, 5, 0), rows(3, 5, 1))
    assert got.shape == (0,) and got.dtype == np.float32
    assert sddmm_plain(torch.zeros(0, dtype=torch.int32),
                       torch.zeros(0, dtype=torch.int32),
                       torch.zeros(4, 5), torch.zeros(3, 5)).shape == (0,)


def test_edges_out_of_range():
    with pytest.raises(ValueError):
        Sddmm([0, 4], [0, 0], 4, 3, CPU)
    with pytest.raises(ValueError):
        Sddmm([0, 1], [0], 4, 3, CPU)


@pytest.mark.parametrize("a,b", [
    (torch.zeros(4, 2, dtype=torch.float64), torch.zeros(3, 2)),  # dtype
    (torch.zeros(5, 2), torch.zeros(3, 2)),  # a rows != n_src
    (torch.zeros(4, 2), torch.zeros(4, 2)),  # b rows != n_dst
    (torch.zeros(4, 2), torch.zeros(3, 3)),  # D differs
    (torch.zeros(4), torch.zeros(3)),  # not 2-D
    (torch.zeros(2, 4).t(), torch.zeros(3, 2)),  # not contiguous
    (torch.zeros(4, 2), torch.zeros(3, 2, device="meta")),  # device
])
def test_wrapper_rejects(a, b):
    k = Sddmm([0, 3], [1, 2], 4, 3, CPU)
    with pytest.raises((TypeError, ValueError)):
        k(a, b)
    assert k.launches == 0


@pytest.mark.parametrize("d,ptrs,want", [
    (1, (256, 512), (1, 1)),  # 4-byte rows: scalar, 1 lane an edge
    (1, (260, 512), (1, 1)),
    (3, (256, 512), (1, 4)),  # 12-byte rows: scalar, 3 lanes and 1 idle
    (3, (256, 516), (1, 4)),
    (7, (256, 512), (1, 8)),
    (7, (260, 512), (1, 8)),
    (16, (256, 512), (4, 4)),  # 4 lanes x float4
    (16, (260, 512), (1, 16)),  # a one element into its storage
    (16, (256, 520), (1, 16)),  # b misaligned
    (33, (256, 512), (1, 32)),  # scalar lanes of 2 elements
    (33, (260, 512), (1, 32)),
    (64, (256, 512), (4, 16)),
    (64, (256, 516), (1, 32)),
])
def test_launch_shape(d, ptrs, want):
    """The instantiation the wrapper picks for rows a, b at ``ptrs``."""
    assert launch_shape(d, 4, ptrs) == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sweep_variant_edits_apply(variant):
    """Every variant the sweep tool builds still finds its edits' targets
    in the kernel source, each exactly once."""
    edits, _ = VARIANTS[variant]
    src = variant_source(edits, "sddmm")
    assert all(new in src for _, new in edits)
