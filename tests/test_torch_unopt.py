"""The port's plaintext CoGNN (unopt) inference and training vs the JAX engine
and the float64 oracle, on the CPU.

The port's ``GasEngine`` takes the JAX engine's initial weights
(``weights_from_jax``) and runs ``unopt_inference`` and 2 ``unopt`` epochs on
``sparse`` and on ``bcsr`` (the CUDA SpMM's plain version on CPU tensors).
Tolerances: logits atol 2e-5 of the JAX ``sparse`` engine's and the oracle's
(the bound of tests/test_torch_gas.py: f32 sums in another order); weights
after 2 epochs within atol 5e-4 of both (the bound of
tests/test_engine.py:43); each epoch's accuracies and ``num_border``
exactly, its loss within 1e-5; ``bcsr`` within 2e-5 (logits) and 5e-4
(weights) of ``sparse``.
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
    """For P parties: the JAX ``sparse`` engine's unopt_inference forward,
    its unopt training epochs from the same initial weights, and the
    oracle's forward and epochs."""
    P = request.param
    src, dst, feats, labels, param = data()
    out = {"P": P}
    inf = JaxGasEngine(
        jax_build_device_plan(build_parties(src, dst, feats, labels, P)),
        param, "unopt_inference", aggregation="sparse")
    z, _, metrics = inf.forward()
    out["z"], out["z_metrics"] = np.asarray(z), inf.metrics_host(metrics)
    eng = JaxGasEngine(
        jax_build_device_plan(build_parties(src, dst, feats, labels, P)),
        param, "unopt", aggregation="sparse")
    out["init"] = [np.asarray(w) for w in eng.weights]
    out["metrics"] = [eng.metrics_host(eng.run_epoch())
                      for _ in range(EPOCHS)]
    out["weights"] = [np.asarray(w) for w in eng.weights]
    oracle = GasOracle(build_parties(src, dst, feats, labels, P), param,
                       "unopt_inference")
    oracle.run(param.num_layers)
    out["oracle_z"] = [oracle.parties[p].z[param.num_layers - 1]
                       for p in range(P)]
    oracle = GasOracle(build_parties(src, dst, feats, labels, P), param,
                       "unopt")
    oracle.run_epochs(EPOCHS)
    out["oracle"] = [[oracle.parties[p].weights[l] for p in range(P)]
                     for l in range(param.num_layers)]
    return out


def torch_engine(P, aggregation, variant):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    return GasEngine(plan, torch_param(param), variant,
                     aggregation=aggregation, device="cpu")


def assert_metrics(m, m_ref, what):
    np.testing.assert_allclose(m["loss"], m_ref["loss"], atol=1e-5,
                               err_msg=what)
    for k in ACC_KEYS:
        np.testing.assert_array_equal(m[k], m_ref[k].astype(np.float32),
                                      err_msg=f"{what} {k}")
    np.testing.assert_array_equal(m["num_border"], m_ref["num_border"])


@pytest.mark.parametrize("aggregation", ["sparse", "bcsr"])
def test_forward_matches_jax_and_oracle(jax_side, aggregation):
    eng = torch_engine(jax_side["P"], aggregation, "unopt_inference")
    assert eng.epoch_layers == 2 * eng.L
    eng.weights = weights_from_jax(jax_side["init"], device="cpu")
    z, prob, metrics = eng.forward()
    z = z.numpy()
    np.testing.assert_allclose(z, jax_side["z"], atol=2e-5)
    assert_metrics(eng.metrics_host(metrics), jax_side["z_metrics"],
                   "forward")
    np.testing.assert_allclose(prob.sum(-1).numpy(), 1.0, atol=1e-6)
    for p, want in enumerate(jax_side["oracle_z"]):
        np.testing.assert_allclose(z[p, :len(want)], want, atol=2e-5)


@pytest.mark.parametrize("aggregation", ["sparse", "bcsr"])
def test_epochs_match_jax_and_oracle(jax_side, aggregation):
    eng = torch_engine(jax_side["P"], aggregation, "unopt")
    assert eng.epoch_layers == 2 * eng.L
    eng.weights = weights_from_jax(jax_side["init"], device="cpu")
    for epoch, m_ref in enumerate(jax_side["metrics"]):
        assert_metrics(eng.metrics_host(eng.run_epoch()), m_ref,
                       f"epoch {epoch}")
    for l, (w, w_ref) in enumerate(zip(eng.weights, jax_side["weights"])):
        np.testing.assert_allclose(w.numpy(), w_ref, atol=5e-4,
                                   err_msg=f"layer {l} vs JAX")
        for p, w_or in enumerate(jax_side["oracle"][l]):
            np.testing.assert_allclose(w[p].numpy(), w_or, atol=5e-4,
                                       err_msg=f"party {p} layer {l} vs "
                                       "oracle")


def test_kernel_backend_matches_sparse():
    """``bcsr`` (the kernel's plain version on CPU) against ``sparse``:
    logits of a forward, and weights and metrics through
    ``run_epochs_scan``, which equals that many ``run_epoch`` calls."""
    kernel = torch_engine(2, "bcsr", "unopt")
    sparse = torch_engine(2, "sparse", "unopt")
    assert kernel.spmm is not None and sparse.spmm is None
    torch.testing.assert_close(kernel.forward()[0], sparse.forward()[0],
                               rtol=0, atol=2e-5)
    m_k = kernel.run_epochs_scan(3)
    per_epoch = [sparse.run_epoch() for _ in range(3)]
    for k, v in m_k.items():
        assert tuple(v.shape) == (2, 3), k
        for e, m in enumerate(per_epoch):
            torch.testing.assert_close(v[:, e], m[k], rtol=0, atol=1e-5,
                                       msg=f"{k} epoch {e}")
    for w_k, w_s in zip(kernel.weights, sparse.weights):
        torch.testing.assert_close(w_k, w_s, rtol=0, atol=5e-4)
    assert kernel.spmm.launches == 0  # CPU tensors run the plain version
