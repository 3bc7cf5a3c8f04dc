"""The GCN metrics (``cognn_tpu_torch/ops/metrics.py``): the wrapper of the
one-pass CUDA kernel of ``csrc/metrics.cu`` and its plain version, on the
CPU, where the wrapper takes the plain version.

Checked here: the engines' metrics go through the wrapper and launch
nothing on the CPU; the plain version against the metric definitions worked
out by hand (exact zeros in ``prob``, argmax ties, empty train, test and
border sets, a party with no border vertices); a party's metrics the same
stacked ``[P, V]`` and alone ``[1, V]``, bit for bit; the wrapper's refusals;
the C entry point's signature against its ``ctypes`` binding. The kernel
itself runs only on the card, where ``chip_smoke.py`` ``metrics_phase``
holds it ``torch.equal`` to the plain version.
"""

import ctypes
import math
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.engine.gas import gcn_metrics as engine_metrics
from cognn_tpu_torch.engine.graphs import kernel_counters
from cognn_tpu_torch.mpc import MpcGasEngine
from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.ops import metrics as metric_ops
from cognn_tpu_torch.ops.metrics import gcn_metrics, gcn_metrics_plain

from test_torch_gas import data, torch_param
from test_torch_plan import build_torch_parties

torch.set_num_threads(1)

KEYS = ("loss", "full_acc", "train_acc", "border_train_acc", "test_acc",
        "border_test_acc", "num_border")


def by_hand(prob, labels, valid, train, val, border, num_local) -> dict:
    """The metric definitions, a party and a row at a time: the loss the
    exact sum of -log(p[label]) (0 taken as 0.001, torch's float32 log) over
    the valid rows over num_local, rounded once to f32; an accuracy
    float32(hits) / float32(rows), 0 over no rows; the hit the first
    maximal index."""
    P, V, _ = prob.shape
    out = {k: [] for k in KEYS}
    for p in range(P):
        terms, sets = [], {k: [0, 0] for k in KEYS[1:6]}
        for v in range(V):
            row = prob[p, v].tolist()
            y = int(labels[p, v])
            hit = row.index(max(row)) == y
            q = prob[p, v, y]
            q = torch.where(q == 0.0, 0.001, q)
            if valid[p, v]:
                terms.append(-float(torch.log(q)))
            test = bool(valid[p, v] and not train[p, v] and not val[p, v])
            for key, inside in (
                    ("full_acc", valid[p, v]), ("train_acc", train[p, v]),
                    ("border_train_acc", train[p, v] and border[p, v]),
                    ("test_acc", test),
                    ("border_test_acc", test and border[p, v])):
                if inside:
                    sets[key][0] += hit
                    sets[key][1] += 1
        out["loss"].append(np.float32(math.fsum(terms) / int(num_local[p])))
        for key, (hits, n) in sets.items():
            out[key].append(np.float32(hits) / np.float32(n) if n else
                            np.float32(0.0))
        out["num_border"].append(int((valid[p] & border[p]).sum()))
    return {k: torch.tensor(np.array(v)) for k, v in out.items()}


def edge_inputs():
    """3 parties, 6 rows, 3 labels. Party 0: a label's probability exactly
    0 (the clamp), ties for the maximum (the first index wins), rows past
    num_local invalid; party 1: no train rows, no border rows; party 2: no
    test rows (every valid row train or val), a train row outside the
    valid rows."""
    prob = torch.tensor([
        [[0.0, 0.5, 0.5], [0.4, 0.4, 0.2], [0.4, 0.4, 0.2], [0.1, 0.2, 0.7],
         [0.3, 0.3, 0.4], [1.0, 0.0, 0.0]],
        [[0.2, 0.3, 0.5], [0.6, 0.2, 0.2], [0.25, 0.25, 0.5],
         [0.0, 1.0, 0.0], [0.5, 0.5, 0.0], [0.1, 0.1, 0.8]],
        [[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.5, 0.0, 0.5],
         [0.3, 0.3, 0.4], [0.2, 0.2, 0.6], [0.7, 0.2, 0.1]],
    ], dtype=torch.float32)
    labels = torch.tensor([[0, 0, 1, 2, 1, 0], [2, 0, 1, 1, 0, 2],
                           [0, 1, 2, 2, 0, 0]], dtype=torch.int64)
    valid = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1],
                          [1, 1, 1, 1, 0, 0]], dtype=torch.bool)
    train = torch.tensor([[1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0],
                          [1, 1, 0, 0, 1, 0]], dtype=torch.bool)
    val = torch.tensor([[0, 0, 1, 0, 0, 0], [1, 0, 0, 0, 0, 0],
                        [0, 0, 1, 1, 0, 0]], dtype=torch.bool)
    border = torch.tensor([[1, 0, 1, 1, 1, 0], [0, 0, 0, 0, 0, 0],
                           [0, 1, 1, 0, 1, 1]], dtype=torch.bool)
    num_local = torch.tensor([4, 6, 4], dtype=torch.int64)
    return prob, labels, valid, train, val, border, num_local


def random_inputs(P=3, V=1000, C=7, seed=0):
    """Softmax rows of random logits (some rows all equal: ties), random
    labels and masks, the last rows of each party invalid."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(P, V, C, generator=g) * 3
    z[:, ::37] = 1.0
    prob = torch.softmax(z, -1)
    labels = torch.randint(0, C, (P, V), generator=g)
    num_local = torch.tensor([V - 17 * p for p in range(P)])
    valid = torch.arange(V)[None] < num_local[:, None]
    split = torch.rand(P, V, generator=g)
    train, val = (split < 0.3) & valid, (split > 0.8) & valid
    border = torch.rand(P, V, generator=g) < 0.4
    return prob, labels, valid, train, val, border, num_local


def assert_metrics_equal(got, want):
    assert list(got) == list(KEYS)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), (k, got[k], want[k])


def test_plain_edge_cases_by_hand():
    args = edge_inputs()
    got = gcn_metrics(*args)
    assert_metrics_equal(got, by_hand(*args))
    # the cases the inputs were built for
    assert got["train_acc"][1] == 0 and got["border_train_acc"][1] == 0
    assert got["num_border"][1] == 0 and got["border_test_acc"][1] == 0
    assert got["test_acc"][2] == 0 and got["border_test_acc"][2] == 0
    # ties: row 1 picks label 0, a hit, row 2 the same index, a miss
    assert got["full_acc"][0] == 0.5
    assert got["loss"][0] > -math.log(0.001) / 4  # row 0's clamped zero


def test_plain_random_by_hand():
    args = random_inputs(P=2, V=300, C=5, seed=3)
    assert_metrics_equal(gcn_metrics(*args), by_hand(*args))


@pytest.mark.parametrize("inputs", ["edge", "random"])
def test_stacked_equals_each_party_alone(inputs):
    args = edge_inputs() if inputs == "edge" else random_inputs()
    stacked = gcn_metrics(*args)
    for p in range(args[0].shape[0]):
        alone = gcn_metrics(*(a[p:p + 1] for a in args))
        assert_metrics_equal(alone, {k: v[p:p + 1]
                                     for k, v in stacked.items()})


@pytest.mark.parametrize("mpc", [False, True], ids=["plain", "mpc"])
def test_engines_take_the_wrapper_and_launch_nothing_on_cpu(mpc):
    src, dst, feats, labels, param = data()
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, 2))
    eng = (MpcGasEngine if mpc else GasEngine)(plan, torch_param(param),
                                               "opt", device="cpu")
    before = metric_ops.launches
    _, prob, got = eng.forward()
    epoch = eng.run_epoch()
    assert metric_ops.launches == before == 0
    arr = eng.arr
    args = (prob, arr.labels, arr.vertex_mask, arr.train_mask, arr.val_mask,
            arr.border, arr.num_local)
    assert_metrics_equal(got, gcn_metrics_plain(*args))
    assert_metrics_equal(engine_metrics(arr, prob), by_hand(*args))
    assert list(epoch) == list(KEYS)
    assert (metric_ops, "launches") in kernel_counters(None)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    prob, labels, valid, train, val, border, num_local = edge_inputs()
    rest = (valid, train, val, border, num_local)
    wide = torch.zeros(*prob.shape[:2], 2 * prob.shape[2])
    wide[..., ::2] = prob
    with pytest.raises(ValueError, match="prob must be contiguous"):
        gcn_metrics(wide[..., ::2], labels, *rest)
    with pytest.raises(TypeError, match="prob must be torch.float32"):
        gcn_metrics(prob.double(), labels, *rest)
    with pytest.raises(TypeError, match="labels must be torch.int64"):
        gcn_metrics(prob, labels.int(), *rest)
    with pytest.raises(TypeError, match="train must be torch.bool"):
        gcn_metrics(prob, labels, valid, train.to(torch.uint8), val, border,
                    num_local)
    with pytest.raises(ValueError, match=r"border must be \[3, 6\]"):
        gcn_metrics(prob, labels, valid, train, val, border[:, :5],
                    num_local)
    with pytest.raises(ValueError, match="C >= 1"):
        gcn_metrics(prob[..., :0], labels, *rest)
    meta = [t.to("meta") for t in (prob, labels, *rest)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gcn_metrics(*meta)
    with pytest.raises(ValueError, match="labels is on meta"):
        gcn_metrics(prob, meta[1], *rest)


def test_c_entry_matches_its_binding():
    """The kernel's extern "C" parameters, read from the source, against
    the argument types the wrapper binds (no compiler here)."""
    src = (_build.CSRC / "metrics.cu").read_text()
    m = re.search(r'extern "C" int cognn_gcn_metrics_f32\(([^)]*)\)', src)
    kinds = ["pointer" if "*" in p or "cudaStream_t" in p else p.split()[0]
             for p in m[1].split(",")]
    assert "metrics" in _build.SOURCES
    lib = SimpleNamespace(cognn_gcn_metrics_f32=SimpleNamespace())
    fn = metric_ops.bind(lib)
    assert kinds == ["int" if t is ctypes.c_int else "pointer"
                     for t in fn.argtypes]
    assert fn.restype is ctypes.c_int and len(kinds) == 13
    # the wrapper's limit on C is the kernel's tile
    assert f"kTileFloats = {metric_ops.MAX_CLASSES};" in src
