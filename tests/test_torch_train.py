"""The port's plaintext CoGNN-Opt training epochs vs the JAX engine and the
float64 oracle, on the CPU.

The port's ``GasEngine(variant="opt")`` starts from the JAX engine's initial
weights (``weights_from_jax``) and trains 2 epochs on ``sparse`` and on
``bcsr`` (the CUDA SpMM's plain version on CPU tensors). Tolerances: revealed
weights within atol 5e-4 of the JAX ``sparse`` engine and of ``GasOracle``
(the bound of tests/test_engine.py:43), each epoch's accuracies and
``num_border`` exactly, its loss within 1e-5.
"""

import numpy as np
import pytest
import torch

from cognn_tpu.engine import GasEngine as JaxGasEngine
from cognn_tpu.engine import build_device_plan as jax_build_device_plan
from cognn_tpu.models.oracle import GasOracle
from cognn_tpu_torch.convert import weights_from_jax
from cognn_tpu_torch.engine import GasEngine, build_device_plan

from test_oracle import build_parties
from test_torch_gas import ACC_KEYS, data, torch_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)

EPOCHS = 2


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"{p}p")
def jax_side(request):
    """JAX ``sparse`` training epochs and the oracle's for P parties."""
    P = request.param
    src, dst, feats, labels, param = data()
    eng = JaxGasEngine(
        jax_build_device_plan(build_parties(src, dst, feats, labels, P)),
        param, "opt", aggregation="sparse")
    init = [np.asarray(w) for w in eng.weights]
    metrics = [eng.metrics_host(eng.run_epoch()) for _ in range(EPOCHS)]
    oracle = GasOracle(build_parties(src, dst, feats, labels, P), param,
                       "opt")
    oracle.run_epochs(EPOCHS)
    return {"P": P, "init": init, "metrics": metrics,
            "weights": [np.asarray(w) for w in eng.weights],
            "oracle": [[oracle.parties[p].weights[l] for p in range(P)]
                       for l in range(param.num_layers)]}


def torch_engine(P, aggregation):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    return GasEngine(plan, torch_param(param), "opt",
                     aggregation=aggregation, device="cpu")


@pytest.mark.parametrize("aggregation", ["sparse", "bcsr"])
def test_epochs_match_jax_and_oracle(jax_side, aggregation):
    eng = torch_engine(jax_side["P"], aggregation)
    assert eng.epoch_layers == 3 * eng.L
    eng.weights = weights_from_jax(jax_side["init"], device="cpu")
    for epoch, m_ref in enumerate(jax_side["metrics"]):
        m = eng.metrics_host(eng.run_epoch())
        np.testing.assert_allclose(m["loss"], m_ref["loss"], atol=1e-5,
                                   err_msg=f"epoch {epoch}")
        for k in ACC_KEYS:
            np.testing.assert_array_equal(
                m[k], m_ref[k].astype(np.float32),
                err_msg=f"epoch {epoch} {k}")
        np.testing.assert_array_equal(m["num_border"], m_ref["num_border"])
    for l, (w, w_ref) in enumerate(zip(eng.weights, jax_side["weights"])):
        np.testing.assert_allclose(w.numpy(), w_ref, atol=5e-4,
                                   err_msg=f"layer {l} vs JAX")
        for p, w_or in enumerate(jax_side["oracle"][l]):
            np.testing.assert_allclose(w[p].numpy(), w_or, atol=5e-4,
                                       err_msg=f"party {p} layer {l} vs "
                                       "oracle")


def test_scan_equals_loop():
    """run_epochs_scan(3) returns [P, 3] metrics equal to three run_epoch
    calls, and leaves the same weights."""
    loop, scan = torch_engine(2, "bcsr"), torch_engine(2, "bcsr")
    per_epoch = [loop.run_epoch() for _ in range(3)]
    stacked = scan.run_epochs_scan(3)
    assert set(stacked) == set(per_epoch[0])
    for k, v in stacked.items():
        assert tuple(v.shape) == (2, 3), k
        for e, m in enumerate(per_epoch):
            assert torch.equal(v[:, e], m[k]), (k, e)
    for w, w_loop in zip(scan.weights, loop.weights):
        assert torch.equal(w, w_loop)
    last = torch_engine(2, "bcsr").run_epochs(3)
    for k, v in last.items():
        assert torch.equal(v, per_epoch[-1][k]), k
