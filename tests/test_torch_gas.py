"""The port's GasEngine inference forward vs the JAX engine and the float64
oracle, on the CPU.

Tolerances: logits atol 2e-5 against JAX ``sparse`` and the oracle (the bound
of tests/test_engine.py:85: f32 sums in another order), loss 1e-5, the
accuracies and ``num_border`` exactly. JAX ``bcsr`` casts H to bf16 in its
Pallas kernel (its own logits sit up to 1.06e-3 from JAX ``sparse`` here), so
against it the logits get the bf16 bound of tests/test_pallas_spmm.py: max
error below 5e-3 of the largest logit.
"""

import numpy as np
import pytest
import torch

from cognn_tpu.engine import GasEngine as JaxGasEngine
from cognn_tpu.engine import build_device_plan as jax_build_device_plan
from cognn_tpu.models.oracle import GasOracle
from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.convert import weights_from_jax
from cognn_tpu_torch.engine import GasEngine, build_device_plan

from test_oracle import build_parties, make_dataset, make_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)

ACC_KEYS = ("full_acc", "train_acc", "border_train_acc", "test_acc",
            "border_test_acc")


def torch_param(p):
    return GNNParam(**{k: getattr(p, k) for k in (
        "num_layers", "num_labels", "input_dim", "hidden_dim", "num_samples",
        "num_edges", "learning_rate", "train_ratio", "val_ratio",
        "test_ratio")})


def data():
    src, dst, feats, labels = make_dataset(n=48, m=300, homophily=0.7)
    return src, dst, feats, labels, make_param(48, feats.shape[1],
                                               labels.max() + 1)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"{p}p")
def jax_side(request):
    """JAX forwards (sparse and bcsr) and the oracle for P parties."""
    P = request.param
    src, dst, feats, labels, param = data()
    out = {"P": P}
    for agg in ("sparse", "bcsr"):
        eng = JaxGasEngine(
            jax_build_device_plan(build_parties(src, dst, feats, labels, P)),
            param, "opt_inference", aggregation=agg)
        z, _, metrics = eng.forward()
        out[agg] = (np.asarray(z), eng.metrics_host(metrics))
        out["weights"] = [np.asarray(w) for w in eng.weights]
    oracle = GasOracle(build_parties(src, dst, feats, labels, P), param,
                       "opt_inference")
    oracle.run(2)
    out["oracle"] = [oracle.parties[p].z[1] for p in range(P)]
    return out


def torch_engine(P, aggregation, variant="opt_inference"):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    return GasEngine(plan, torch_param(param), variant,
                     aggregation=aggregation, device="cpu")


@pytest.mark.parametrize("aggregation", ["sparse", "bcsr"])
def test_forward_matches_jax(jax_side, aggregation):
    eng = torch_engine(jax_side["P"], aggregation)
    assert eng.aggregation == aggregation
    eng.weights = weights_from_jax(jax_side["weights"], device="cpu")
    z, prob, metrics = eng.forward()
    z = z.numpy()
    m = eng.metrics_host(metrics)

    z_ref, m_ref = jax_side["sparse"]
    np.testing.assert_allclose(z, z_ref, atol=2e-5)
    np.testing.assert_allclose(m["loss"], m_ref["loss"], atol=1e-5)
    for k in ACC_KEYS:
        np.testing.assert_array_equal(m[k], m_ref[k].astype(np.float32),
                                      err_msg=k)
    np.testing.assert_array_equal(m["num_border"], m_ref["num_border"])
    np.testing.assert_allclose(prob.sum(-1).numpy(), 1.0, atol=1e-6)

    z_bf16 = jax_side["bcsr"][0]
    assert np.abs(z - z_bf16).max() < 5e-3 * np.abs(z_bf16).max()
    for p, want in enumerate(jax_side["oracle"]):
        np.testing.assert_allclose(z[p, :len(want)], want, atol=2e-5)


def test_auto_picks_kernel_backend():
    eng = torch_engine(2, "auto")
    assert eng.aggregation == "bcsr" and eng.spmm is not None
    z_auto = eng.forward()[0]
    z_sparse = torch_engine(2, "sparse").forward()[0]
    torch.testing.assert_close(z_auto, z_sparse, rtol=0, atol=2e-5)
    assert eng.spmm.launches == 0  # CPU tensors run the plain version


def test_opt_variant_forward_and_later_slices():
    eng = torch_engine(2, "bcsr", variant="opt")
    torch.testing.assert_close(eng.forward()[0],
                               torch_engine(2, "bcsr").forward()[0])
    with pytest.raises(NotImplementedError, match="training slice"):
        eng.run_epoch()
    for kw in (dict(variant="unopt"), dict(aggregation="dense"),
               dict(mode="sharded")):
        src, dst, feats, labels, param = data()
        plan = build_device_plan(
            build_torch_parties(src, dst, feats, labels, 2))
        with pytest.raises(NotImplementedError, match="slice"):
            GasEngine(plan, torch_param(param), **{"device": "cpu", **kw})


def test_weights_from_jax_rejects_bad_shape():
    with pytest.raises(ValueError):
        weights_from_jax([np.zeros((3, 4))], device="cpu")
