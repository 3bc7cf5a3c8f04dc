"""The port's float64 oracle (``cognn_tpu_torch/models/oracle.py``) against
the JAX package's (``cognn_tpu/models/oracle.py``), and the port's plaintext
engine against the port's oracle, on the CPU.

The two oracles run the same float64 numpy operations in the same order on
graphs each package builds, so for all four variants at P = 1, 2, 3 the
weights, every layer's pre-activation and input, and every metric are
``np.array_equal`` after 2 epochs (training) or one forward (inference), and
``print_reference_format`` prints the same lines. The port's ``GasEngine``
(``auto``: the CSR kernel's plain version on the CPU) lies within 5e-4 of
the port's oracle (tests/test_engine.py:43): its weights after 2 epochs, or
its logits after one forward.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cognn_tpu.models import oracle as jax_oracle
from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.models import oracle
from cognn_tpu_torch.models.oracle import GasOracle

from test_oracle import build_parties
from test_torch_gas import data, torch_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)

EPOCHS = 2
TOL = 5e-4  # tests/test_engine.py:43
VARIANTS = ("opt", "opt_inference", "unopt", "unopt_inference")


def run(oracle_cls, graphs, param, variant):
    orc = oracle_cls(graphs, param, variant)
    if variant.endswith("inference"):
        orc.run(orc.L)  # the reference's max_iters = L forward
    else:
        orc.run_epochs(EPOCHS)
    return orc


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda p: f"{p}p")
def parties(request):
    P = request.param
    src, dst, feats, labels, param = data()
    return (P, build_parties(src, dst, feats, labels, P), param,
            build_torch_parties(src, dst, feats, labels, P),
            torch_param(param))


@pytest.mark.parametrize("variant", VARIANTS)
def test_oracle_equals_jax_oracle(parties, variant, capsys):
    P, jax_graphs, jparam, graphs, param = parties
    want = run(jax_oracle.GasOracle, jax_graphs, jparam, variant)
    got = run(GasOracle, graphs, param, variant)
    assert (got.it, got.epoch_layers, got.n) == (want.it, want.epoch_layers,
                                                 want.n)
    for p, (g, w) in enumerate(zip(got.parties, want.parties)):
        for l in range(param.num_layers):
            np.testing.assert_array_equal(g.weights[l], w.weights[l],
                                          err_msg=f"party {p} W{l}")
        for name in ("z", "h_in"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.keys() == b.keys()
            for l in a:
                np.testing.assert_array_equal(a[l], b[l],
                                              err_msg=f"party {p} {name}{l}")
        np.testing.assert_array_equal(g.h, w.h, err_msg=f"party {p} h")
        assert (g.train_n, g.val_n) == (w.train_n, w.val_n)
    assert len(got.metrics) == len(want.metrics) > 0
    for m, mw in zip(got.metrics, want.metrics):
        assert dataclasses.asdict(m) == dataclasses.asdict(mw)
    capsys.readouterr()
    for m in got.metrics:
        m.print_reference_format()
    printed = capsys.readouterr().out
    for m in want.metrics:
        m.print_reference_format()
    assert printed == capsys.readouterr().out
    assert printed.count("cross-entropy-loss = ") == len(got.metrics)


def test_helpers_equal_jax():
    rng = np.random.default_rng(0)
    deg = np.array([0, 1, 2, 7, 199999])
    np.testing.assert_array_equal(oracle.norm0(deg), jax_oracle.norm0(deg))
    z = rng.standard_normal((9, 4))
    p = oracle.softmax(z)
    np.testing.assert_array_equal(p, jax_oracle.softmax(z))
    y = np.eye(4)[rng.integers(0, 4, 9)]
    mask = rng.random(9) < 0.5
    for args in ((y, p), (y, p, mask), (y, p, np.zeros(9, bool)),
                 (y[:0], p[:0])):
        assert oracle.accuracy(*args) == jax_oracle.accuracy(*args)
    assert oracle.cross_entropy_loss(y, p) == \
        jax_oracle.cross_entropy_loss(y, p)
    with pytest.raises(ValueError, match="unknown variant"):
        GasOracle([], torch_param(data()[-1]), "gcn")


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_within_oracle(parties, variant):
    P, _, _, graphs, param = parties
    orc = run(GasOracle, graphs, param, variant)
    eng = GasEngine(build_device_plan(graphs), param, variant, device="cpu")
    if variant.endswith("inference"):
        z = eng.forward()[0].numpy()
        for p, party in enumerate(orc.parties):
            want = party.z[param.num_layers - 1]
            np.testing.assert_allclose(z[p, :len(want)], want, atol=TOL,
                                       err_msg=f"party {p} logits")
        return
    eng.run_epochs(EPOCHS)
    for l, w in enumerate(eng.weights):
        for p, party in enumerate(orc.parties):
            np.testing.assert_allclose(w[p].numpy(), party.weights[l],
                                       atol=TOL, err_msg=f"party {p} W{l}")
