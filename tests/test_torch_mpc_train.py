"""The port's secret-shared CoGNN-Opt training epochs vs the JAX package's,
on the CPU, under exact truncation.

Under exact truncation every revealed value is independent of the random
share words. On carried state (``mpc_state_from_jax``) the port's revealed
weights after 1 and 2 epochs are held within atol 1e-4 of the JAX ``sparse``
engine's. Up to the first softmax the two compute the same ring values; torch
and XLA may round a softmax probability differently in the last bit, which
re-enters the ring as one unit of p - y, so the test records the share of
weight entries that are bit-equal rather than asserting all of them. The
first epoch's forward is bit-equal: its revealed logits are compared before
training. With its own state the port is held within 5e-3 of ``GasOracle``
(tests/test_mpc.py:104), and its ``bcsr`` (the kernels' plain versions on CPU
tensors) and ``sparse`` backends train to equal shares' values.
"""

import numpy as np
import pytest
import torch

from cognn_tpu.core.ring import ring_to_u64 as j_to_u64
from cognn_tpu.engine import build_device_plan as jax_build_device_plan
from cognn_tpu.models.oracle import GasOracle
from cognn_tpu.mpc import MpcGasEngine as JaxMpcGasEngine
from cognn_tpu_torch.convert import mpc_state_from_jax
from cognn_tpu_torch.core.ring import ring_to_u64
from cognn_tpu_torch.engine import build_device_plan
from cognn_tpu_torch.mpc import MpcGasEngine

from test_oracle import build_parties
from test_torch_gas import ACC_KEYS, data, torch_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)

EPOCHS = 2


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda p: f"{p}p")
def jax_side(request):
    """The JAX secret-shared engine (``sparse``, CPU) for P parties: its
    encoded state and ``inv_train_fp`` as numpy limb arrays, its revealed
    logits before training, and each epoch's metrics and revealed weights;
    and the oracle's weights after EPOCHS epochs."""
    P = request.param
    src, dst, feats, labels, param = data()
    eng = JaxMpcGasEngine(
        jax_build_device_plan(build_parties(src, dst, feats, labels, P)),
        param, "opt", aggregation="sparse")
    out = {
        "P": P,
        "state": (np.asarray(eng.x0_sh),
                  [np.asarray(w) for w in eng.weights_sh],
                  np.asarray(eng.n0_fp)),
        "inv_train_fp": np.asarray(eng.inv_train_fp),
        "z": np.asarray(eng.forward()[0]),
        "metrics": [], "weights": [],
    }
    for _ in range(EPOCHS):
        out["metrics"].append(eng.metrics_host(eng.run_epoch()))
        out["weights"].append(eng.reveal_weights())
    oracle = GasOracle(build_parties(src, dst, feats, labels, P), param,
                       "opt")
    oracle.run_epochs(EPOCHS)
    out["oracle"] = [[oracle.parties[p].weights[l] for p in range(P)]
                     for l in range(param.num_layers)]
    return out


def torch_engine(P, **kw):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    return MpcGasEngine(plan, torch_param(param), "opt",
                        **{"device": "cpu", **kw})


def test_inv_train_fp_equal(jax_side):
    eng = torch_engine(jax_side["P"])
    assert eng.epoch_layers == 3 * eng.L
    assert tuple(eng.inv_train_fp.shape) == (jax_side["P"],)
    np.testing.assert_array_equal(ring_to_u64(eng.inv_train_fp),
                                  j_to_u64(jax_side["inv_train_fp"]))


@pytest.mark.parametrize("aggregation", ["sparse", "bcsr"])
def test_carried_state_tracks_jax(jax_side, aggregation, request):
    eng = torch_engine(jax_side["P"], aggregation=aggregation)
    eng.install_state(*mpc_state_from_jax(*jax_side["state"], device="cpu"))
    np.testing.assert_array_equal(eng.forward()[0].numpy(), jax_side["z"])
    for epoch in range(EPOCHS):
        m, m_ref = eng.metrics_host(eng.run_epoch()), \
            jax_side["metrics"][epoch]
        np.testing.assert_allclose(m["loss"], m_ref["loss"], atol=1e-6,
                                   err_msg=f"epoch {epoch}")
        for k in ACC_KEYS:
            np.testing.assert_array_equal(
                m[k], m_ref[k].astype(np.float32),
                err_msg=f"epoch {epoch} {k}")
        np.testing.assert_array_equal(m["num_border"], m_ref["num_border"])
        equal = total = 0
        for l, (w, w_ref) in enumerate(zip(eng.reveal_weights(),
                                           jax_side["weights"][epoch])):
            np.testing.assert_allclose(w.numpy(), w_ref, atol=1e-4,
                                       err_msg=f"epoch {epoch} layer {l}")
            equal += int((w.numpy() == w_ref).sum())
            total += w_ref.size
        request.node.user_properties.append(
            (f"bit_equal_weights_epoch{epoch + 1}", f"{equal}/{total}"))


def test_own_state_tracks_oracle(jax_side):
    P = jax_side["P"]
    eng = torch_engine(P)
    eng.run_epochs(EPOCHS)
    for l, w in enumerate(eng.reveal_weights()):
        for p, w_or in enumerate(jax_side["oracle"][l]):
            np.testing.assert_allclose(w[p].numpy(), w_or, atol=5e-3,
                                       err_msg=f"party {p} layer {l}")


def test_backends_equal(jax_side):
    """``bcsr`` and ``sparse`` train to the same revealed weights and
    metrics, epoch by epoch (exact ring sums in another order)."""
    P = jax_side["P"]
    kernel, sparse = torch_engine(P), torch_engine(P, aggregation="sparse")
    assert kernel.aggregation == "bcsr"
    m_k, m_s = kernel.run_epochs_scan(EPOCHS), sparse.run_epochs_scan(EPOCHS)
    for k in m_k:
        assert tuple(m_k[k].shape) == (P, EPOCHS)
        assert torch.equal(m_k[k], m_s[k]), k
    for w_k, w_s in zip(kernel.reveal_weights(), sparse.reveal_weights()):
        assert torch.equal(w_k, w_s)


def test_weight_mean():
    """P = 1 leaves the weight mean out; at P = 2 it is the replicas' mean
    to one truncation, one replica per party again."""
    one = torch_engine(1)
    w = one.weights_sh[0]
    assert one._weight_mean(w) is w
    two = torch_engine(2)
    w = two.proto.share(two._gen, torch.tensor(
        [[[1.0, -2.5]], [[3.0, 0.5]]]))
    mean = two.proto.reveal(two._weight_mean(w))
    torch.testing.assert_close(mean, torch.tensor([[[2.0, -1.0]]] * 2),
                               rtol=0, atol=2.0 ** -16)
