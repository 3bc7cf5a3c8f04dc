"""The port's ring, fixed-point and share helpers, the plain version of the
exact matmul kernel and the int64 plain version of the ring SpMM, against the
JAX package and numpy uint64 oracles on the CPU.

Every comparison is bit-exact: these are integer functions (and
``ring_to_f32`` copies the reference's float32 formula step for step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognn_tpu.core import fixedpoint as jfp
from cognn_tpu.core import ring as jring
from cognn_tpu.ops.intmatmul import ring_matmul_np, ring_matmul_small
from cognn_tpu_torch.convert import mpc_state_from_jax
from cognn_tpu_torch.core import ring
from cognn_tpu_torch.core.fixedpoint import FixedPointSpec, fp_decode, fp_encode
from cognn_tpu_torch.core.ring import RingSpec, ring_from_u64, ring_to_u64
from cognn_tpu_torch.core.shares import (
    random_words,
    share_merge,
    share_merge_np,
    share_split,
    share_split_np,
)
from cognn_tpu_torch.ops import intmatmul
from cognn_tpu_torch.ops.intmatmul import ring_matmul, ring_matmul_plain
from cognn_tpu_torch.ops.spmm import Spmm, spmm_plain

torch.set_num_threads(1)

RNG = np.random.default_rng(64)
EDGE_WORDS = np.array([
    0, 1, (1 << 64) - 1,  # 0, +-1
    1 << 31, (1 << 64) - (1 << 31),  # +-2^31
    1 << 32, (1 << 64) - (1 << 32),  # +-2^32
    1 << 63, (1 << 63) - 1,  # int64 min, max
    0x7FFFFFFF_80000000, 0x7FFFFFFF_FFFFFFFF, 0x80000000_7FFFFFFF,
    0xFFFFFFFF_80000000, 0x00000000_FFFFFFFF,
], dtype=np.uint64)


def words(n=200):
    """Edge words and random full-range 64-bit words."""
    rnd = RNG.integers(0, 1 << 64, size=n, dtype=np.uint64)
    return np.concatenate([EDGE_WORDS, rnd])


def jax_u64(fn, *u64s, **kw):
    """Apply a JAX limb-ring op to uint64 inputs; uint64 out."""
    out = fn(jring.RING64, *[jnp.asarray(jring.ring_from_u64(u))
                             for u in u64s], **kw)
    return jring.ring_to_u64(np.asarray(out))


def test_u64_converters_roundtrip():
    u = words()
    t = ring_from_u64(u, device="cpu")
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(ring_to_u64(t), u)


@pytest.mark.parametrize("f", [16, 1, 31])
def test_to_f32_bit_exact(f):
    u = words()
    got = ring.ring_to_f32(ring_from_u64(u, device="cpu"), f).numpy()
    want = np.asarray(jring.ring_to_f32(
        jring.RING64, jnp.asarray(jring.ring_from_u64(u)), f))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_from_f32_bit_exact():
    x = np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0, 1.5e-5, -1.5e-5, 0.49999997,
                  -2.0**31, 2.0**31, 2.0**40 + 3.0, -(2.0**46)], np.float32),
        RNG.normal(0, 1, 300).astype(np.float32),
        RNG.uniform(-1e6, 1e6, 300).astype(np.float32)])
    for f in (16, 0, 8):
        got = ring_to_u64(ring.ring_from_f32(torch.from_numpy(x), f))
        want = jring.ring_to_u64(np.asarray(
            jring.ring_from_f32(jring.RING64, jnp.asarray(x), f)))
        np.testing.assert_array_equal(got, want, err_msg=f"f={f}")


@pytest.mark.parametrize("f", [16, 1, 31])
def test_arith_shift_bit_exact(f):
    u = words()
    got = ring_to_u64(ring.ring_arith_shift_right(
        ring_from_u64(u, device="cpu"), f))
    np.testing.assert_array_equal(
        got, jax_u64(jring.ring_arith_shift_right, u, f=f))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg"])
def test_elementwise_bit_exact(op):
    a, b = words(), words()[::-1].copy()
    ta, tb = ring_from_u64(a, device="cpu"), ring_from_u64(b, device="cpu")
    if op == "neg":
        got, want = ring.ring_neg(ta), jax_u64(jring.ring_neg, a)
    else:
        got = getattr(ring, f"ring_{op}")(ta, tb)
        want = jax_u64(getattr(jring, f"ring_{op}"), a, b)
    np.testing.assert_array_equal(ring_to_u64(got), want)


def test_fixedpoint_matches_jax():
    x = RNG.uniform(-300, 300, 500)
    u = fp_encode(x)
    np.testing.assert_array_equal(u, jfp.fp_encode(x))
    np.testing.assert_array_equal(fp_decode(u), jfp.fp_decode(u))
    with pytest.raises(NotImplementedError, match="later slice"):
        FixedPointSpec(ring=RingSpec(32))


def test_shares_split_merge():
    gen = torch.Generator().manual_seed(3)
    x = ring_from_u64(words(), device="cpu")
    sh = share_split(gen, x)
    assert sh.shape == (2, *x.shape)
    assert torch.equal(share_merge(sh[0], sh[1]), x)
    # the random share covers all 64 bits: high words look uniform
    r = ring_to_u64(random_words(gen, (4000,)))
    assert len(np.unique(r >> np.uint64(32))) > 3900
    assert 0.45 < (r >> np.uint64(63)).mean() < 0.55
    u = words()
    s0, s1 = share_split_np(u, np.random.default_rng(1))
    np.testing.assert_array_equal(share_merge_np(s0, s1), u)


def test_mpc_state_from_jax_limbs():
    u = words(30).reshape(2, 2, 11)  # [share, P, V]
    limbs = np.stack([jring.ring_from_u64(u[s]) for s in range(2)])
    x0, ws, n0 = mpc_state_from_jax(limbs, [limbs, limbs],
                                    jring.ring_from_u64(u[0]), device="cpu")
    np.testing.assert_array_equal(ring_to_u64(x0), u)
    np.testing.assert_array_equal(ring_to_u64(ws[1]), u)
    np.testing.assert_array_equal(ring_to_u64(n0), u[0])
    with pytest.raises(ValueError):
        mpc_state_from_jax(u, [], u[0], device="cpu")  # not uint32 limbs


@pytest.mark.parametrize("shape", [(2, 5, 37, 3), (1, 9, 1, 4), (3, 4, 6, 1)])
def test_ring_matmul_plain_full_range(shape):
    B, N, K, M = shape
    a = RNG.integers(0, 1 << 64, size=(B, N, K), dtype=np.uint64)
    b = RNG.integers(0, 1 << 64, size=(B, K, M), dtype=np.uint64)
    got = ring_to_u64(ring_matmul_plain(ring_from_u64(a, device="cpu"),
                                        ring_from_u64(b, device="cpu")))
    for i in range(B):
        np.testing.assert_array_equal(got[i], ring_matmul_np(a[i], b[i]))


def test_ring_matmul_plain_chunks_over_k(monkeypatch):
    """The plain version's K chunking (one chunk per k here) gives the same
    bits as one chunk."""
    a = ring_from_u64(RNG.integers(0, 1 << 64, (2, 3, 10), dtype=np.uint64),
                      device="cpu")
    b = ring_from_u64(RNG.integers(0, 1 << 64, (2, 10, 2), dtype=np.uint64),
                      device="cpu")
    whole = ring_matmul_plain(a, b)
    monkeypatch.setattr(intmatmul, "_CHUNK_BYTES", 8 * 2 * 3 * 2)
    assert torch.equal(ring_matmul_plain(a, b), whole)


def test_ring_matmul_matches_jax_small():
    """Against the JAX package's own 24-dot kernel, on operands that fit
    int32 (its precondition), as the protocol's reconstructed activations
    and weights do."""
    a = RNG.integers(-(1 << 31), 1 << 31, (23, 40)).astype(np.int64)
    b = RNG.integers(-(1 << 31), 1 << 31, (40, 6)).astype(np.int64)
    want = jring.ring_to_u64(np.asarray(ring_matmul_small(
        jnp.asarray(jring.ring_from_u64(a.astype(np.uint64))),
        jnp.asarray(jring.ring_from_u64(b.astype(np.uint64))))))
    before = intmatmul.launches
    got = ring_matmul(torch.from_numpy(a)[None], torch.from_numpy(b)[None])
    np.testing.assert_array_equal(ring_to_u64(got[0]), want)
    assert intmatmul.launches == before  # CPU tensors run the plain version


def limb_emulation(a, b, k_slice):
    """The kernel's arithmetic on uint64 [N, K] @ [K, M], in numpy: K in
    slices of ``k_slice``; in a slice, byte limbs A_i, B_j, the 36 pairs
    with i + j <= 7 summed per shift s = i + j in an int32 range (asserted)
    and flushed into uint64 (<< 8s, wrapping) every ``K_CHUNK``; the
    slices' partial C added with wrap-around, as the kernel's atomics do."""
    K = a.shape[1]
    al = [((a >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int64)
          for i in range(8)]
    bl = [((b >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.int64)
          for j in range(8)]
    out = np.zeros((a.shape[0], b.shape[1]), np.uint64)
    for s0 in range(0, K, k_slice):
        s1 = min(K, s0 + k_slice)
        part = np.zeros_like(out)
        for k0 in range(s0, s1, intmatmul.K_CHUNK):
            k1 = min(s1, k0 + intmatmul.K_CHUNK)
            acc = np.zeros((8, *out.shape), np.int64)
            for i in range(8):
                for j in range(8 - i):
                    acc[i + j] += al[i][:, k0:k1] @ bl[j][k0:k1]
            assert acc.min() >= 0 and acc.max() <= 2**31 - 1
            for sh in range(8):
                part += acc[sh].astype(np.uint64) << np.uint64(8 * sh)
        out += part
    return out


@pytest.mark.parametrize("K,full,k_slice", [
    (37, False, 128), (700, False, 256), (1433, False, 512),
    (intmatmul.K_CHUNK, True, 4096), (intmatmul.K_CHUNK + 1, True, 8192),
    (intmatmul.K_CHUNK + 1, True, 128)])
def test_ring_matmul_limb_emulation(K, full, k_slice):
    """The limb emulation equals the plain version and JAX ring_matmul_np
    on full-range operands, and on all-0xFF operands (every word -1: the
    int32 shift sums' worst case) at K = K_CHUNK and K_CHUNK + 1."""
    N, M = 3, 5
    if full:
        a = np.full((N, K), (1 << 64) - 1, np.uint64)
        b = np.full((K, M), (1 << 64) - 1, np.uint64)
    else:
        a = RNG.integers(0, 1 << 64, (N, K), dtype=np.uint64)
        b = RNG.integers(0, 1 << 64, (K, M), dtype=np.uint64)
    got = limb_emulation(a, b, k_slice)
    want = ring_to_u64(ring_matmul_plain(ring_from_u64(a[None], device="cpu"),
                                         ring_from_u64(b[None], device="cpu")))
    np.testing.assert_array_equal(got, want[0])
    if not full or K == intmatmul.K_CHUNK:  # ring_matmul_np is slow at 4097
        np.testing.assert_array_equal(got, ring_matmul_np(a, b))


def test_k_slice_policy():
    """K split into whole stages only while all blocks fit the card at
    once; every slice length is a whole number of stages."""
    ks = intmatmul.k_slice
    full = intmatmul.BLOCK_ROWS * intmatmul.BLOCKS_PER_SM * 132
    assert ks(2, 1360, 1433, 16, 132) == 256  # Cora layer 0: 6 slices
    assert ks(4, 4936, 500, 16, 132) >= 500  # PubMed layer 0: one slice
    assert ks(2, 1360, 16, 7, 132) >= 16
    assert ks(1, full, 5000, 3, 132) >= 5000 > intmatmul.K_CHUNK
    for shape in [(1, 3, 4097, 5), (3, 1001, 777, 19), (1, 1, 1, 1)]:
        k = ks(*shape, 132)
        assert k % intmatmul.STAGE_K == 0 and k > 0


@pytest.mark.parametrize("a,b", [
    (torch.zeros(1, 2, 3), torch.zeros(1, 3, 2)),  # float
    (torch.zeros(2, 3, dtype=torch.int64), torch.zeros(3, 2,
                                                       dtype=torch.int64)),
    (torch.zeros(1, 2, 3, dtype=torch.int64),
     torch.zeros(1, 4, 2, dtype=torch.int64)),  # K mismatch
    (torch.zeros(1, 2, 3, dtype=torch.int64),
     torch.zeros(1, 3, 2, dtype=torch.int64, device="meta")),  # device
])
def test_ring_matmul_rejects(a, b):
    with pytest.raises((TypeError, ValueError)):
        ring_matmul(a, b)


def spmm_oracle(src, dst, n_dst, h_u64):
    """numpy uint64 U = Aᵀ·H over an edge list (duplicates accumulate)."""
    out = np.zeros((h_u64.shape[0], n_dst, h_u64.shape[2]), np.uint64)
    for s, d in zip(src, dst):
        out[:, d] += h_u64[:, s]
    return out


@pytest.mark.parametrize("D", [1, 3, 16])
def test_ring_spmm_plain_matches_u64_oracle(D):
    n_src, n_dst = 70, 60
    rng = np.random.default_rng(D)
    src = rng.integers(0, n_src, 300)
    dst = rng.integers(0, 2 * n_dst // 3, 300)  # the last third stays empty
    src = np.concatenate([src, src[:60], src[:20]])  # counts up to 3
    dst = np.concatenate([dst, dst[:60], dst[:20]])
    h = rng.integers(0, 1 << 64, size=(2, n_src, D), dtype=np.uint64)
    k = Spmm(src, dst, n_src, n_dst, torch.device("cpu"))
    assert k.counts_i64.max().item() >= 3
    got = k.ring(ring_from_u64(h, device="cpu"))
    want = spmm_oracle(src, dst, n_dst, h)
    np.testing.assert_array_equal(ring_to_u64(got), want)
    assert not want[:, 2 * n_dst // 3:].any()
    # the plain version alone, one share at a time
    one = spmm_plain(k.indptr, k.indices, k.counts_i64,
                     ring_from_u64(h[1], device="cpu"))
    np.testing.assert_array_equal(ring_to_u64(one), want[1])
    assert k.ring_launches == 0 and k.launches == 0


@pytest.mark.parametrize("bad", [
    torch.zeros(2, 5, 4),  # float
    torch.zeros(5, 4, dtype=torch.int64),  # no share axis
    torch.zeros(2, 6, 4, dtype=torch.int64),  # rows != n_src
    torch.zeros(2, 4, 5, dtype=torch.int64).transpose(1, 2),  # strides
])
def test_ring_spmm_rejects(bad):
    k = Spmm([0, 1], [1, 2], 5, 5, torch.device("cpu"))
    with pytest.raises((TypeError, ValueError)):
        k.ring(bad)
    assert k.ring_launches == 0
