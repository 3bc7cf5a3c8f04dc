"""The stacked engines' CUDA graphs (``cognn_tpu_torch/engine/graphs.py``),
on the CPU, where the engines run eager.

Checked here: where an engine may capture (by default on the card on
``bcsr`` or ``dense``, stacked or sharded; ``cuda_graphs=True`` raises on
the CPU and on ``sparse``), and the eager code the graphs are captured
from, which now updates the weights in place: ``run_epochs_scan(n)`` equals
n ``run_epoch`` calls of an engine built with the same seeds, weights
assigned between calls and ``install_state`` take effect on the next call,
and a result handed out earlier is unchanged by later calls. The graphs
themselves run only on the card, where ``chip_smoke.py`` ``graph_phase``
holds them against eager engines built from the same seeds.
"""

from types import SimpleNamespace

import pytest
import torch

from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.engine.graphs import use_graphs
from cognn_tpu_torch.mpc import MpcGasEngine

from test_torch_gas import data, torch_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)

P = 2
# (secret-shared, variant, hoist_agg)
CASES = [(False, "opt", True), (False, "unopt", True), (True, "opt", True),
         (True, "unopt", True), (True, "unopt", False)]


def case_id(case):
    mpc, variant, hoist = case
    return "-".join(["mpc"] * mpc + [variant] + ["nohoist"] * (not hoist))


def build(mpc=False, variant="opt", hoist=True, **kw):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, P))
    kw.setdefault("device", "cpu")
    if mpc:
        kw["hoist_agg"] = hoist
    return (MpcGasEngine if mpc else GasEngine)(plan, torch_param(param),
                                                variant, **kw)


def weights(eng):
    return eng.weights_sh if hasattr(eng, "weights_sh") else eng.weights


def revealed(eng):
    return (eng.reveal_weights() if hasattr(eng, "weights_sh")
            else eng.weights)


def clone_all(x):
    """``x`` (tensors in tuples, lists and dicts) with every tensor
    cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_all(v) for k, v in x.items()}
    return type(x)(clone_all(v) for v in x)


def assert_equal(a, b):
    """Equal tensors in equal nests of tuples, lists and dicts."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_equal(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal(x, y)


def test_default_captures_only_stacked_on_the_card():
    """On the card every engine but ``sparse`` captures, stacked or sharded
    alike (the rule no longer reads the rank); the CPU and ``sparse``
    refuse ``True``."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for agg in ("bcsr", "dense", None):
        assert use_graphs(None, cuda, agg)
        assert use_graphs(True, cuda, agg)
        assert not use_graphs(False, cuda, agg)
    for device, agg in ((cpu, "bcsr"), (cpu, None), (cuda, "sparse")):
        assert not use_graphs(None, device, agg)
        assert not use_graphs(False, device, agg)
        with pytest.raises(ValueError, match="cuda_graphs=True"):
            use_graphs(True, device, agg)


@pytest.mark.parametrize("mpc", [False, True], ids=["plain", "mpc"])
def test_cuda_graphs_true_raises_where_the_engine_runs_eager(mpc):
    with pytest.raises(ValueError, match="on the CPU"):
        build(mpc, cuda_graphs=True)
    with pytest.raises(ValueError, match="sparse backend"):
        build(mpc, aggregation="sparse", cuda_graphs=True)
    # sharded, only the party's device refuses now
    party = SimpleNamespace(world=P, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="on the CPU"):
        build(mpc, mode="sharded", group=party, cuda_graphs=True)
    for flag in (None, False):
        assert not build(mpc, cuda_graphs=flag)._graphs.enabled


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_scan_equals_epochs(case):
    """run_epochs_scan(3): [P, 3] metrics equal to 3 run_epoch calls of an
    engine built with the same seeds, and the same weights after; the last
    epoch of run_epochs(3) equal too."""
    loop, scan, last = build(*case), build(*case), build(*case)
    per_epoch = [loop.run_epoch() for _ in range(3)]
    stacked = scan.run_epochs_scan(3)
    assert stacked.keys() == per_epoch[0].keys()
    for k, v in stacked.items():
        assert tuple(v.shape) == (P, 3) and v.dtype == per_epoch[0][k].dtype
        for e, m in enumerate(per_epoch):
            assert torch.equal(v[:, e], m[k]), (k, e)
    assert_equal(weights(scan), weights(loop))
    assert_equal(last.run_epochs(3), per_epoch[-1])
    assert_equal(weights(last), weights(loop))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_earlier_results_unchanged_by_later_calls(case):
    """The epochs write the weights in place; what an engine handed out
    before (a forward, the weights, an epoch's metrics, a scan) stays as it
    was."""
    eng = build(*case)
    out = [eng.forward(), weights(eng), eng.run_epoch(),
           eng.run_epochs_scan(2), eng.run_epochs(2)]
    before = clone_all(out)
    eng.run_epochs(2)
    eng.forward()
    assert_equal(out, before)
    assert not all(torch.equal(a, b) for a, b in zip(weights(eng), out[1]))


@pytest.mark.parametrize("case", CASES[:2], ids=case_id)
def test_assigned_weights_take_effect(case):
    """Weights assigned between calls drive the next forward and epoch, and
    the epochs leave the caller's tensors alone."""
    a, b = build(*case), build(*case)
    a.forward()
    a.run_epoch()
    b.run_epochs(3)
    mine = b.weights
    kept = [w.clone() for w in mine]
    a.weights = mine
    assert_equal(a.forward(), b.forward())
    assert_equal(a.run_epoch(), b.run_epoch())
    assert_equal(a.weights, b.weights)
    assert_equal(mine, kept)


@pytest.mark.parametrize("case", CASES[2:], ids=case_id)
def test_installed_state_takes_effect(case):
    """install_state, and weight shares assigned, between calls: the next
    forward and epoch reveal what the other engine's do (exact truncation:
    the share randomness drops out)."""
    a, b = build(*case), build(*case, prng_seed=7)
    a.forward()
    a.run_epoch()
    b.run_epochs(3)
    a.install_state(b.x0_sh, b.weights_sh, b.n0_fp)
    assert_equal(a.forward(), b.forward())
    assert_equal(a.run_epoch(), b.run_epoch())
    assert_equal(a.reveal_weights(), b.reveal_weights())
    b.run_epoch()
    a.weights_sh = b.weights_sh
    assert_equal(a.reveal_weights(), b.reveal_weights())
    assert_equal(a.run_epoch(), b.run_epoch())
    assert_equal(revealed(a), revealed(b))
