"""Port vs JAX package: device plan, Glorot init and synthetic datasets.

The port's numpy modules are copies, so they must agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cognn_tpu.engine.plan import build_device_plan as jax_build_device_plan
from cognn_tpu.engine.plan import set_split as jax_set_split
from cognn_tpu.harness.datasets import synthetic_planetoid as jax_synthetic
from cognn_tpu.utils.glibc_rand import glorot_init as jax_glorot
from cognn_tpu_torch.engine.plan import (
    build_device_plan,
    plan_tensors,
    set_split,
)
from cognn_tpu_torch.graph import build_party_graph
from cognn_tpu_torch.harness.datasets import synthetic_planetoid
from cognn_tpu_torch.utils.glibc_rand import glorot_init

from test_oracle import build_parties, make_dataset

torch.set_num_threads(1)


def build_torch_parties(src, dst, feats, labels, n_parties):
    """``test_oracle.build_parties`` with the port's graph module."""
    n = len(feats)
    vids = np.arange(n)
    tid = None if n_parties == 1 else {v: v % n_parties for v in range(n)}
    graphs = []
    for p in range(n_parties):
        g = build_party_graph(src, dst, None, tid, p, n_parties,
                              all_vids=vids)
        g.set_vertex_data(vids, feats, labels)
        graphs.append(g)
    return graphs


def assert_plans_equal(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    # the JAX plan's only extra field is the dense operator, not built here
    assert want.dense_adj is None


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("n_parties", [1, 2, 4])
def test_device_plan_matches_jax(n_parties, reorder):
    src, dst, feats, labels = make_dataset(n=48, m=300, homophily=0.7)
    want = jax_build_device_plan(
        build_parties(src, dst, feats, labels, n_parties), reorder=reorder)
    got = build_device_plan(
        build_torch_parties(src, dst, feats, labels, n_parties),
        reorder=reorder)
    jax_set_split(want, 0.5, 0.2)
    set_split(got, 0.5, 0.2)
    assert_plans_equal(got, want)


def test_plan_tensors_keep_values():
    src, dst, feats, labels = make_dataset(n=48, m=300, homophily=0.7)
    plan = build_device_plan(build_torch_parties(src, dst, feats, labels, 2))
    set_split(plan, 0.5, 0.2)
    t = plan_tensors(plan, torch.device("cpu"))
    assert t["loc_src"].dtype == torch.int64
    assert t["vertex_mask"].dtype == torch.bool
    assert t["in_deg"].dtype == torch.float32
    for name, v in t.items():
        np.testing.assert_array_equal(v.numpy(), getattr(plan, name),
                                      err_msg=name)


@pytest.mark.parametrize("dims", [(16, 3), (8, 8), (1433, 16)])
def test_glorot_init_bit_identical(dims):
    np.testing.assert_array_equal(glorot_init(*dims), jax_glorot(*dims))


def test_synthetic_planetoid_identical():
    got, want = synthetic_planetoid("cora_small"), jax_synthetic("cora_small")
    for name in ("src", "dst", "features", "labels"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert dataclasses.asdict(got.param) == dataclasses.asdict(want.param)
