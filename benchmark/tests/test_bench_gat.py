"""The GAT cell on the CPU at a small size: a whole run is correct, the
plain fixed-point reference (``reference/gat_fixed.py``) equals the port's
engine bit for bit, the check catches a state left unchanged and each
party's gradient over half its training rows (planted in the port's GAT
engine), and the work counts of ``harness/work_gat.py`` match a hand
count."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import cell, check, spec, work_gat
from benchmark.harness.data import draw_graph, seeds_of

WORKLOAD = "gat-pubmed4p-ss-train"
BENCH = spec.load_benchmark()
SYSTEM = spec.module("systems", "mpc_gat")
REFERENCE = spec.module("reference", "gat_fixed")
SMALL = dict(num_samples=400, num_edges=1600, input_dim=24, num_labels=3)
SEED = 2 ** 36 + 23


def small(**kw) -> dict:
    cfg = spec.config(BENCH, spec.cell(BENCH, WORKLOAD)["config"])
    cfg.update(SMALL, **kw)
    return cfg


def small_run(trace: bool = False) -> dict:
    traffic = dict(spec.traffic("train"), epochs_per_dispatch=4)
    return cell.run(WORKLOAD, SEED, 0.2, trace, device="cpu", cfg=small(),
                    traffic=traffic, bench=BENCH)


@pytest.mark.parametrize("trace", [False, True])
def test_cpu_run_is_correct(trace):
    r = small_run(trace)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0.0 for c in r["checks"].values()), r["checks"]
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu"
    assert r["attempted"] > 0
    json.dumps(r)


@pytest.mark.parametrize("parties", [1, 2, 4])
def test_reference_matches_port(parties):
    """Bit for bit: the port's revealed losses, leaves and logits and the
    plain fixed-point reference's."""
    cfg = small(parties=parties, learning_rate=0.5, train_ratio=0.2)
    seeds = seeds_of(2 ** 41 + parties)
    graph = draw_graph(cfg, seeds.graph)
    sut = SYSTEM.build(cfg, graph, seeds, "cpu")
    w0 = sut.weights()
    m1 = sut.epochs(1)
    w1 = sut.weights()
    m2 = sut.epochs(2)
    ref = REFERENCE.for_config(cfg, graph, seeds)
    r = ref.readings(3)
    loss = np.concatenate([m1["loss"], m2["loss"]], 1)
    np.testing.assert_array_equal(loss, r["loss"])
    assert len(w0) == 6
    for got, want in zip(w0 + w1 + sut.weights(),
                         r["w0"] + r["w1"] + r["wn"]):
        np.testing.assert_array_equal(got, want)
    valid = ref.valid.numpy()
    np.testing.assert_array_equal(sut.rows(sut.request())[valid],
                                  ref.forward().numpy()[valid])
    numbers = check.train_numbers(
        {"loss": loss, "w0": w0, "w1": w1, "wn": sut.weights()}, r, 0.5)
    assert numbers == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def state_unchanged(monkeypatch, gat):
    """An epoch computes its leaves and metrics but keeps the old ones."""
    monkeypatch.setattr(gat.MpcGatEngine, "_epoch_step",
                        lambda self: self._epoch_gat()[1])


def half_batch(monkeypatch, gat):
    """Each party's gradient over the first half of its training rows, the
    mean taken over that half."""
    init = gat.MpcGatEngine.__init__

    def patched(self, *args, **kw):
        init(self, *args, **kw)
        mask = self.arr.train_mask
        rank = torch.cumsum(mask.to(torch.int64), dim=-1)
        half = (mask.sum(-1, keepdim=True) // 2).clamp(min=1)
        self.arr.train_mask = mask & (rank <= half)
        self.inv_train_fp = self.proto.encode_public(
            1.0 / half[:, 0].to(torch.float32))
    monkeypatch.setattr(gat.MpcGatEngine, "__init__", patched)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_fault_is_not_correct(monkeypatch, fault):
    from cognn_tpu_torch.mpc import gat

    fault(monkeypatch, gat)
    r = small_run()
    assert not r["correct"], r["checks"]


def test_work_counts_by_hand():
    """2 layers, (2 heads of 4, then 3 heads of 2) on 64 vertices, 256
    edges, 2 parties: 320 entries, 64 flat rows, counted by hand."""
    cfg = dict(num_samples=64, num_edges=256, num_layers=2, heads=2,
               hidden_dim=8, output_heads=3, num_labels=2, parties=2,
               ring_bits=64)
    assert work_gat.layer_heads(cfg) == [(2, 4), (3, 2)]
    # layer 0: row pointers 4 * 65, an entry 4 + 8 * 2, rows 8 * 2 * 64 * 8
    bytes0 = 4 * 65 + 20 * 320 + 8 * 2 * 64 * 8
    ops0 = 320 * 8 * 3 / (64 * 132 * 1980e6)
    assert work_gat.wagg_bound_s(cfg, 2, 4) == max(bytes0 / 3.35e12, ops0)
    bytes1 = 4 * 65 + (4 + 8 * 3) * 320 + 8 * 2 * 64 * 6
    assert work_gat.wagg_bound_per_unit(cfg, "epoch") == pytest.approx(
        2 * (bytes0 + bytes1) / 3.35e12)
    assert work_gat.wagg_bound_per_unit(cfg, "request") == pytest.approx(
        (bytes0 + bytes1) / 3.35e12)
    # the SDDMM: both operands' rows, 2 indices and H results an entry
    sd0 = 8 * 2 * 64 * 8 + 8 * 320 + 8 * 2 * 320
    sd1 = 8 * 2 * 64 * 6 + 8 * 320 + 8 * 3 * 320
    assert work_gat.sddmm_bound_per_unit(cfg, "epoch") == pytest.approx(
        (sd0 + sd1) / 3.35e12)
    assert work_gat.sddmm_bound_per_unit(cfg, "request") == 0.0
    assert work_gat.share(2e-6, 4.0) == pytest.approx(50.0)
    assert work_gat.share(2e-6, None) is None


@pytest.mark.parametrize("key,value", [
    ("activation", "relu"), ("self_loops", False), ("dropout", 0.6),
    ("output_heads_combined", "concat"), ("head_dim", 4)])
def test_other_recipe_is_refused(key, value):
    """A configuration that states a GAT other than the one implemented
    is refused, not run as this one."""
    cfg = small(**{key: value})
    seeds = seeds_of(3)
    with pytest.raises(ValueError, match=key):
        SYSTEM.build(cfg, draw_graph(cfg, seeds.graph), seeds, "cpu")
