"""The port's secret-shared CoGNN (unopt) inference and training vs the JAX
package's, on the CPU, under exact truncation, with the hoisted layer-0
aggregation agg(x0) (``hoist_agg=True``) and without it.

Under exact truncation every revealed value is independent of the random
share words, and so of where agg(x0) is computed and of the generator it
draws from (JAX hoists it with a fixed key of its own). On carried state
(``mpc_state_from_jax``) the port's revealed ``unopt_inference`` logits and
its ``unopt`` engine's first forward are bit-equal to the JAX engine's
(JAX's two unopt variants run the same forward), and its revealed weights
after 1 and 2 epochs lie within atol 1e-4 of the JAX engine's with the same
``hoist_agg``; the share of bit-equal weight entries is recorded, as in
tests/test_torch_mpc_train.py (a softmax probability that torch and XLA
round differently re-enters the ring as one unit of p - y). Within the port,
``hoist_agg`` True and False, and the ``bcsr`` (the kernels' plain versions
on CPU tensors) and ``sparse`` backends, give ``torch.equal`` revealed
weights and metrics. With its own state the port is held within 5e-3 of
``GasOracle`` (tests/test_mpc.py:281-294). The JAX engines compile whole
epochs (``compile_mode="epoch"``, pinned equal to its phase programs by the
JAX package's tests), which compiles faster on the CPU.
"""

import numpy as np
import pytest
import torch

from cognn_tpu.engine import build_device_plan as jax_build_device_plan
from cognn_tpu.models.oracle import GasOracle
from cognn_tpu.mpc import MpcGasEngine as JaxMpcGasEngine
from cognn_tpu_torch.convert import mpc_state_from_jax
from cognn_tpu_torch.engine import build_device_plan
from cognn_tpu_torch.mpc import MpcGasEngine

from test_oracle import build_parties
from test_torch_gas import ACC_KEYS, data, torch_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)

EPOCHS = 2


@pytest.fixture(scope="module", params=[1, 2], ids=lambda p: f"{p}p")
def jax_side(request):
    """The JAX secret-shared ``unopt`` engines (``sparse``, CPU) for P
    parties, hoisted and not, built alike (the same shares): the encoded
    state as numpy limb arrays, the revealed logits of the hoisted engine's
    forward before training, and each engine's per-epoch metrics and
    revealed weights; and the oracle's weights after EPOCHS epochs."""
    P = request.param
    src, dst, feats, labels, param = data()
    out = {"P": P}
    for hoist in (True, False):
        eng = JaxMpcGasEngine(
            jax_build_device_plan(build_parties(src, dst, feats, labels, P)),
            param, "unopt", aggregation="sparse", hoist_agg=hoist,
            compile_mode="epoch")
        if hoist:
            out["state"] = (np.asarray(eng.x0_sh),
                            [np.asarray(w) for w in eng.weights_sh],
                            np.asarray(eng.n0_fp))
            out["z"] = np.asarray(eng.forward()[0])
        out[hoist] = {"metrics": [], "weights": []}
        for _ in range(EPOCHS):
            out[hoist]["metrics"].append(eng.metrics_host(eng.run_epoch()))
            out[hoist]["weights"].append(eng.reveal_weights())
    oracle = GasOracle(build_parties(src, dst, feats, labels, P), param,
                       "unopt")
    oracle.run_epochs(EPOCHS)
    out["oracle"] = [[oracle.parties[p].weights[l] for p in range(P)]
                     for l in range(param.num_layers)]
    return out


def torch_engine(P, variant="unopt", **kw):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    return MpcGasEngine(plan, torch_param(param), variant,
                        **{"device": "cpu", **kw})


@pytest.mark.parametrize("aggregation", ["sparse", "bcsr"])
@pytest.mark.parametrize("hoist", [True, False], ids=["hoist", "no_hoist"])
def test_carried_state_tracks_jax(jax_side, hoist, aggregation, request):
    state = mpc_state_from_jax(*jax_side["state"], device="cpu")
    inf = torch_engine(jax_side["P"], "unopt_inference",
                       aggregation=aggregation, hoist_agg=hoist)
    inf.install_state(*state)
    np.testing.assert_array_equal(inf.forward()[0].numpy(), jax_side["z"])
    eng = torch_engine(jax_side["P"], aggregation=aggregation,
                       hoist_agg=hoist)
    assert eng.epoch_layers == 2 * eng.L
    eng.install_state(*state)
    np.testing.assert_array_equal(eng.forward()[0].numpy(), jax_side["z"])
    ref = jax_side[hoist]
    for epoch in range(EPOCHS):
        m, m_ref = eng.metrics_host(eng.run_epoch()), ref["metrics"][epoch]
        np.testing.assert_allclose(m["loss"], m_ref["loss"], atol=1e-6,
                                   err_msg=f"epoch {epoch}")
        for k in ACC_KEYS:
            np.testing.assert_array_equal(
                m[k], m_ref[k].astype(np.float32),
                err_msg=f"epoch {epoch} {k}")
        np.testing.assert_array_equal(m["num_border"], m_ref["num_border"])
        equal = total = 0
        for l, (w, w_ref) in enumerate(zip(eng.reveal_weights(),
                                           ref["weights"][epoch])):
            np.testing.assert_allclose(w.numpy(), w_ref, atol=1e-4,
                                       err_msg=f"epoch {epoch} layer {l}")
            equal += int((w.numpy() == w_ref).sum())
            total += w_ref.size
        request.node.user_properties.append(
            (f"bit_equal_weights_epoch{epoch + 1}", f"{equal}/{total}"))


def test_hoist_and_backends_equal(jax_side):
    """``hoist_agg`` True and False, on the kernel backend and on
    ``sparse``, reveal equal logits and train to equal revealed weights and
    metrics, epoch by epoch; the JAX engine's hoisted and unhoisted epochs
    agree likewise."""
    P = jax_side["P"]
    engines = [torch_engine(P), torch_engine(P, hoist_agg=False),
               torch_engine(P, aggregation="sparse"),
               torch_engine(P, aggregation="sparse", hoist_agg=False)]
    assert [e.aggregation for e in engines] == ["bcsr"] * 2 + ["sparse"] * 2
    z = engines[0].forward()[0]
    metrics = [e.run_epochs_scan(EPOCHS) for e in engines]
    weights = [e.reveal_weights() for e in engines]
    for e, m, w in zip(engines[1:], metrics[1:], weights[1:]):
        what = f"{e.aggregation} hoist_agg={e.hoist_agg}"
        assert torch.equal(e.forward()[0], engines[0].forward()[0]), what
        for k, v in m.items():
            assert tuple(v.shape) == (P, EPOCHS)
            assert torch.equal(v, metrics[0][k]), (what, k)
        for a, b in zip(w, weights[0]):
            assert torch.equal(a, b), what
    assert tuple(z.shape) == (P, engines[0].plan.V, 3)
    for a, b in zip(jax_side[True]["weights"][-1],
                    jax_side[False]["weights"][-1]):
        np.testing.assert_array_equal(a, b)


def test_own_state_tracks_oracle(jax_side):
    P = jax_side["P"]
    eng = torch_engine(P)
    eng.run_epochs(EPOCHS)
    for l, w in enumerate(eng.reveal_weights()):
        for p, w_or in enumerate(jax_side["oracle"][l]):
            np.testing.assert_allclose(w[p].numpy(), w_or, atol=5e-3,
                                       err_msg=f"party {p} layer {l}")


def test_hoisted_state():
    """The hoist holds the reconstruct of agg(x0) (its prepped transpose
    contiguous for ``unopt`` only, a view for ``unopt_inference``) and is
    redone by ``install_state``; without the hoist nothing is kept."""
    eng = torch_engine(2)
    agg = eng.proto.prep_matmul_a(eng._aggregate(eng.arr, eng.x0_sh, True))
    assert torch.equal(eng.x0_prep, agg)
    assert torch.equal(eng.x0_prep_bwd, agg.transpose(1, 2))
    assert eng.x0_prep_bwd.is_contiguous()
    inf = torch_engine(2, "unopt_inference")
    assert torch.equal(inf.x0_prep, agg)
    assert not inf.x0_prep_bwd.is_contiguous()
    x0_sh = eng.x0_sh.flip(-2).contiguous()
    eng.install_state(x0_sh, eng.weights_sh, eng.n0_fp)
    assert torch.equal(eng.x0_prep, eng.proto.prep_matmul_a(
        eng._aggregate(eng.arr, x0_sh, True)))
    bare = torch_engine(2, hoist_agg=False)
    assert bare.x0_prep is None and bare.x0_prep_bwd is None
