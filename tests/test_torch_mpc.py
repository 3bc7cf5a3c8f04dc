"""The port's secret-shared inference engine vs the JAX package's, on the CPU.

Under exact truncation every revealed ring value is independent of the
random share words, so on the same encoded inputs (the shares of x0 and the
weights and the encoded normalizers ``n0_fp``, carried over with
``mpc_state_from_jax``) the port's revealed logits must equal the JAX
engine's bit for bit, through both aggregation backends; accuracies and
``num_border`` exactly, the loss within 1e-6 (softmax and log of two
libraries).

The port encodes its normalizers from a float64 rsqrt on the host, rounded
once to float32 (``norm0_host``), so its own ``n0_fp`` equals the JAX
engine's on the test graphs, and with its own state the revealed logits are
bit-equal too. Over every degree 0..199,999 the two encodes differ at one
degree only (88738), by one ring unit: XLA's float32 ``rsqrt`` rounds that
normalizer the other way. The logits are also held to 2e-2 of the port's
plaintext engine, the bound of tests/test_mpc.py:90.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognn_tpu.core.ring import ring_to_u64 as j_to_u64
from cognn_tpu.engine import build_device_plan as jax_build_device_plan
from cognn_tpu.engine.gas import norm0 as jax_norm0
from cognn_tpu.mpc import MpcGasEngine as JaxMpcGasEngine
from cognn_tpu.mpc.protocol import Protocol as JaxProtocol
from cognn_tpu_torch.convert import mpc_state_from_jax
from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
from cognn_tpu_torch.core.ring import RingSpec, ring_to_u64
from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.engine.gas import norm0_host
from cognn_tpu_torch.mpc import MpcGasEngine
from cognn_tpu_torch.mpc.protocol import Protocol as MpcProtocol
from cognn_tpu_torch.ops import intmatmul

from test_oracle import build_parties, make_dataset, make_param
from test_torch_gas import ACC_KEYS, torch_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)


def data():
    src, dst, feats, labels = make_dataset(n=48, m=300, homophily=0.7)
    return src, dst, feats, labels, make_param(48, feats.shape[1],
                                               labels.max() + 1)


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda p: f"{p}p")
def jax_side(request):
    """The JAX secret-shared forward (sparse, CPU) for P parties, with its
    encoded state as numpy limb arrays."""
    P = request.param
    src, dst, feats, labels, param = data()
    eng = JaxMpcGasEngine(
        jax_build_device_plan(build_parties(src, dst, feats, labels, P)),
        param, "opt_inference", aggregation="sparse")
    z, _, metrics = eng.forward()
    return {
        "P": P,
        "z": np.asarray(z),
        "metrics": eng.metrics_host(metrics),
        "state": (np.asarray(eng.x0_sh),
                  [np.asarray(w) for w in eng.weights_sh],
                  np.asarray(eng.n0_fp)),
    }


def torch_engine(P, **kw):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    return MpcGasEngine(plan, torch_param(param), **{"device": "cpu", **kw})


@pytest.mark.parametrize("aggregation", ["sparse", "bcsr"])
def test_forward_bit_equal_to_jax(jax_side, aggregation):
    eng = torch_engine(jax_side["P"], aggregation=aggregation)
    assert eng.aggregation == aggregation
    eng.install_state(*mpc_state_from_jax(*jax_side["state"], device="cpu"))
    before = intmatmul.launches
    z, prob, metrics = eng.forward()
    np.testing.assert_array_equal(z.numpy(), jax_side["z"])
    m, m_ref = eng.metrics_host(metrics), jax_side["metrics"]
    np.testing.assert_allclose(m["loss"], m_ref["loss"], atol=1e-6)
    for k in ACC_KEYS:
        np.testing.assert_array_equal(m[k], m_ref[k].astype(np.float32),
                                      err_msg=k)
    np.testing.assert_array_equal(m["num_border"], m_ref["num_border"])
    np.testing.assert_allclose(prob.sum(-1).numpy(), 1.0, atol=1e-6)
    # CPU tensors run the kernels' plain versions: no launch is counted
    assert intmatmul.launches == before
    if eng.spmm is not None:
        assert eng.spmm.ring_launches == 0 and eng.spmm.launches == 0


def test_own_state_close_to_jax(jax_side):
    eng = torch_engine(jax_side["P"])
    x0_sh, weights_sh, n0_fp = jax_side["state"]
    # x0 and the weights encode identically (float32 truncation), and so do
    # the normalizers (host float64 rsqrt) ...
    rec = lambda s: j_to_u64(s[0]) + j_to_u64(s[1])  # noqa: E731
    np.testing.assert_array_equal(ring_to_u64(eng.x0_sh[0] + eng.x0_sh[1]),
                                  rec(x0_sh))
    for w, jw in zip(eng.weights_sh, weights_sh):
        np.testing.assert_array_equal(ring_to_u64(w[0] + w[1]), rec(jw))
    assert torch.equal(eng.n0_fp, mpc_state_from_jax(
        x0_sh, weights_sh, n0_fp, device="cpu")[2])
    # ... so the revealed logits are bit-equal without carrying state
    np.testing.assert_array_equal(eng.forward()[0].numpy(), jax_side["z"])


def test_norm0_host_encode_vs_jax():
    """Every degree 0..199,999: the port's host normalizer, encoded, against
    JAX's ``norm0`` (XLA float32 ``rsqrt``), encoded; compared as uint64."""
    deg = np.arange(200_000, dtype=np.float32)
    got = ring_to_u64(MpcProtocol().encode_public(
        torch.from_numpy(norm0_host(deg))))
    want = j_to_u64(JaxProtocol().encode_public(jax_norm0(jnp.asarray(deg))))
    diff = got.view(np.int64) - want.view(np.int64)
    np.testing.assert_array_equal(np.nonzero(diff)[0], [88738])
    assert np.abs(diff).max() == 1
    assert norm0_host(np.array([0.0]))[0] == 0.0  # gcn.h:219-221


def test_tracks_plaintext(jax_side):
    P = jax_side["P"]
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    z_plain = GasEngine(plan, torch_param(param), "opt_inference",
                        device="cpu").forward()[0]
    z_mpc = torch_engine(P).forward()[0]
    np.testing.assert_allclose(z_mpc.numpy(), z_plain.numpy(), atol=2e-2)


def test_backends_and_modes_agree():
    """Kernel and sparse backends, and both sign modes, reveal the same
    bits; probabilistic truncation stays within the fixed-point bound."""
    z = torch_engine(2, aggregation="sparse").forward()[0]
    for kw in (dict(aggregation="auto"), dict(nonlinear="bitdecomp"),
               dict(prng_seed=7)):
        assert torch.equal(torch_engine(2, **kw).forward()[0], z), kw
    z_prob = torch_engine(2, truncation="probabilistic").forward()[0]
    torch.testing.assert_close(z_prob, z, rtol=0, atol=2e-2)
    w = torch_engine(2).reveal_weights()
    assert [tuple(t.shape) for t in w] == [(2, 8, 8), (2, 8, 3)]


def test_later_slices_raise():
    for kw in (dict(mode="sharded"), dict(aggregation="dense")):
        with pytest.raises(NotImplementedError, match="slice"):
            torch_engine(2, **kw)
    # the training slice: both opt variants train, as in the JAX package
    for variant in ("opt", "opt_inference"):
        metrics = torch_engine(2, variant=variant).run_epoch()
        assert tuple(metrics["loss"].shape) == (2,)
    with pytest.raises(NotImplementedError, match="later slice"):
        torch_engine(2, fp=FixedPointSpec(ring=RingSpec(32)))
    with pytest.raises(ValueError):
        torch_engine(2, aggregation="tiled")


def test_install_state_rejects_wrong_shapes():
    eng = torch_engine(2)
    with pytest.raises(ValueError, match="x0_sh"):
        eng.install_state(eng.x0_sh[:, :1], eng.weights_sh, eng.n0_fp)
    with pytest.raises(ValueError, match="n0_fp"):
        eng.install_state(eng.x0_sh, eng.weights_sh, eng.n0_fp.float())
    with pytest.raises(ValueError, match="weight layers"):
        eng.install_state(eng.x0_sh, eng.weights_sh[:1], eng.n0_fp)
