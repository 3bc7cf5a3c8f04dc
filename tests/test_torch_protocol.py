"""The port's secret-sharing ``Protocol`` against the JAX package's, on the
CPU, on inputs made with numpy from a seed.

The two draw other random words (``torch.Generator`` vs ``jax.random``), so
shares are compared by their reconstructed ring values. Under exact
truncation those do not depend on the random words: add, sub, mask_mul,
matmul, matmul_prepped, scale_rows, scale_const, relu, select, minimum and
the sign masks must agree bit for bit. Probabilistic truncation is held to
2e-3 of the true product, the bound of tests/test_mpc.py:75; the softmax
prediction to 1e-6 (float32 exponentials of two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognn_tpu.core.ring import ring_from_u64 as j_from_u64
from cognn_tpu.core.ring import ring_to_u64 as j_to_u64
from cognn_tpu.mpc import Protocol as JaxProtocol
from cognn_tpu_torch.core.ring import ring_from_u64, ring_to_u64
from cognn_tpu_torch.mpc import Protocol

torch.set_num_threads(1)

RNG = np.random.default_rng(21)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def rec(sh):
    """Port shares -> reconstructed uint64."""
    return ring_to_u64(sh[0] + sh[1])


def jrec(proto, sh):
    """JAX shares -> reconstructed uint64."""
    return j_to_u64(np.asarray(proto.reconstruct_ring(sh)))


def shared(x, seed):
    """The same float32 input shared by both protocols."""
    x = np.asarray(x, np.float32)
    return (Protocol().share(gen(seed), torch.from_numpy(x)),
            JaxProtocol().share(jax.random.key(seed), jnp.asarray(x)))


def shares_of_words(u, seed):
    """Shares (r, u - r) of given uint64 ring words, for both layouts."""
    r = np.random.default_rng(seed).integers(0, 1 << 64, u.shape,
                                             dtype=np.uint64)
    s = np.stack([r, u - r])
    return ring_from_u64(s), jnp.asarray(np.stack(
        [j_from_u64(s[0]), j_from_u64(s[1])]))


def test_share_reveal_roundtrip():
    x = RNG.uniform(-50, 50, (7, 5)).astype(np.float32)
    sh, jsh = shared(x, 0)
    assert sh.shape == (2, 7, 5) and sh.dtype == torch.int64
    got = Protocol().reveal(sh).numpy()
    np.testing.assert_array_equal(got, np.asarray(JaxProtocol().reveal(jsh)))
    np.testing.assert_allclose(got, x, atol=2e-4)
    # the random share's high words look uniform (no plaintext leaks)
    assert len(np.unique(ring_to_u64(sh[0]) >> np.uint64(32))) > 30


def test_linear_ops_exact():
    p, jp = Protocol(), JaxProtocol()
    x = RNG.uniform(-5, 5, (8, 4))
    y = RNG.uniform(-5, 5, (8, 4))
    (sx, jx), (sy, jy) = shared(x, 1), shared(y, 2)
    mask = RNG.integers(0, 2, (8, 4)).astype(bool)
    np.testing.assert_array_equal(rec(p.add(sx, sy)), jrec(jp, jp.add(jx, jy)))
    np.testing.assert_array_equal(rec(p.sub(sx, sy)), jrec(jp, jp.sub(jx, jy)))
    np.testing.assert_array_equal(
        rec(p.mask_mul(sx, torch.from_numpy(mask))),
        jrec(jp, jp.mask_mul(jx, jnp.asarray(mask))))
    pub = RNG.integers(0, 1 << 64, (8, 4), dtype=np.uint64)
    np.testing.assert_array_equal(
        rec(p.add_public(sx, ring_from_u64(pub))),
        jrec(jp, jp.add_public(jx, jnp.asarray(j_from_u64(pub)))))
    assert p.zeros((3, 2)).shape == (2, 3, 2)


def test_matmul_and_prepped_exact():
    p, jp = Protocol(), JaxProtocol()
    a = RNG.uniform(-2, 2, (3, 6, 9))
    b = RNG.uniform(-2, 2, (3, 9, 4))
    (sa, ja), (sb, jb) = shared(a, 3), shared(b, 4)
    got = rec(p.matmul(gen(5), sa, sb))
    got_prep = rec(p.matmul_prepped(gen(6), p.prep_matmul_a(sa), sb))
    np.testing.assert_array_equal(got, got_prep)
    for i in range(3):  # the JAX protocol's matmul is per party (2-D)
        want = jrec(jp, jp.matmul(jax.random.key(i), ja[:, :, i], jb[:, :, i]))
        np.testing.assert_array_equal(got[i], want)
        want_prep = jrec(jp, jp.matmul_prepped(
            jax.random.key(i), jp.prep_matmul_a(ja[:, :, i]), jb[:, :, i]))
        np.testing.assert_array_equal(got[i], want_prep)
    np.testing.assert_allclose(p.reveal(p.matmul(gen(8), sa, sb)).numpy(),
                               a @ b, atol=1e-2)


def test_scale_rows_and_const_exact():
    p, jp = Protocol(), JaxProtocol()
    x = RNG.uniform(-4, 4, (2, 10, 3))
    sx, jx = shared(x, 9)
    s = RNG.uniform(0, 1, (2, 10, 1)).astype(np.float32)
    s_fp = p.encode_public(torch.from_numpy(s))
    js_fp = jp.encode_public(jnp.asarray(s))
    np.testing.assert_array_equal(ring_to_u64(s_fp), j_to_u64(np.asarray(js_fp)))
    np.testing.assert_array_equal(
        rec(p.scale_rows(gen(1), sx, s_fp)),
        jrec(jp, jp.scale_rows(jax.random.key(1), jx, js_fp)))
    for c in (0.5, 1 / 3, -0.25):
        np.testing.assert_array_equal(
            rec(p.scale_const(gen(2), sx, c)),
            jrec(jp, jp.scale_const(jax.random.key(2), jx, c)))


def test_probabilistic_truncation():
    p = Protocol(truncation="probabilistic")
    jp = JaxProtocol(truncation="probabilistic")
    x = RNG.uniform(-4, 4, (64,))
    sx, jx = shared(x, 10)
    got = p.reveal(p.scale_const(gen(3), sx, 0.5)).numpy()
    np.testing.assert_allclose(got, 0.5 * x, atol=2e-3)
    want = np.asarray(jp.reveal(jp.scale_const(jax.random.key(3), jx, 0.5)))
    np.testing.assert_allclose(got, want, atol=2e-3)
    # exact and probabilistic reconstructions differ by at most one unit
    # (the carry lost when the two shares are shifted apart)
    exact = rec(Protocol().scale_const(gen(4), sx, 0.5))
    diff = (rec(p.scale_const(gen(4), sx, 0.5)) - exact).view(np.int64)
    assert np.abs(diff).max() <= 1
    with pytest.raises(ValueError):
        Protocol(truncation="stochastic")


def test_sign_masks_exact_both_modes():
    u = np.concatenate([
        np.array([0, 1, (1 << 64) - 1, 1 << 63, (1 << 63) - 1, 1 << 32,
                  0x7FFFFFFF_80000000], np.uint64),
        RNG.integers(0, 1 << 64, 300, dtype=np.uint64),
        (RNG.integers(-(1 << 20), 1 << 20, 300)).astype(np.uint64)])
    sh, jsh = shares_of_words(u, 11)
    want = (u.view(np.int64) > 0)
    for mode in ("reconstruct", "bitdecomp"):
        got = Protocol(nonlinear=mode).sign_mask(sh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=mode)
        jgot = np.asarray(JaxProtocol(nonlinear=mode).sign_mask(jsh))
        np.testing.assert_array_equal(got, jgot, err_msg=mode)
    # zero and the most negative value from shares whose own signs vary
    for v in (0, 1 << 63):
        zsh, _ = shares_of_words(np.full(200, v, np.uint64), 12)
        assert not Protocol(nonlinear="bitdecomp").sign_mask(zsh).any()


def test_relu_select_minimum_exact():
    p, jp = Protocol(), JaxProtocol()
    x = RNG.uniform(-3, 3, (40,))
    y = RNG.uniform(-3, 3, (40,))
    (sx, jx), (sy, jy) = shared(x, 13), shared(y, 14)
    np.testing.assert_array_equal(rec(p.relu(sx)), jrec(jp, jp.relu(jx)))
    np.testing.assert_array_equal(p.less_mask(sx, sy).numpy(),
                                  np.asarray(jp.less_mask(jx, jy)))
    np.testing.assert_array_equal(rec(p.minimum(sx, sy)),
                                  jrec(jp, jp.minimum(jx, jy)))
    mask = RNG.integers(0, 2, 40).astype(bool)
    np.testing.assert_array_equal(
        rec(p.select(torch.from_numpy(mask), sx, sy)),
        jrec(jp, jp.select(jnp.asarray(mask), jx, jy)))


def test_softmax_pred():
    p, jp = Protocol(), JaxProtocol()
    z = RNG.uniform(-3, 3, (12, 5))
    y = np.eye(5, dtype=np.float32)[RNG.integers(0, 5, 12)]
    sz, jz = shared(z, 15)
    prob, pm = p.softmax_pred(gen(0), sz, torch.from_numpy(y))
    jprob, jpm = jp.softmax_pred(jax.random.key(0), jz, jnp.asarray(y))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=1e-6)
    np.testing.assert_allclose(p.reveal(pm).numpy(), np.asarray(jp.reveal(jpm)),
                               atol=2e-5)
