"""The system under test of the ``mpc_gat`` configurations: the port's
secret-shared GAT engine (``MpcGatEngine``), stacked on one card, built from
a configuration and the inputs drawn from the seed, behind the calls of
:mod:`benchmark.systems.mpc_gas`'s ``System`` (its leaves are the weights).

Like ``mpc_gas``, it imports ``cognn_tpu_torch`` inside the function that
builds the engine, so that a checkout without the GAT engine fails there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.harness.data import Graph, Seeds, party_of
from benchmark.systems.mpc_gas import System


# the recipe the engine and the reference implement: a configuration that
# states another is refused, not run as this one
RECIPE = {"activation": "elu", "self_loops": True, "dropout": 0.0,
          "output_heads_combined": "mean"}


def check_recipe(cfg: dict) -> None:
    """Raise ``ValueError`` where ``cfg`` states a GAT other than the one
    implemented: ``head_dim`` other than ``hidden_dim / heads``, or a value
    of RECIPE's keys other than its own."""
    wrong = {k: cfg[k] for k, v in RECIPE.items() if cfg[k] != v}
    if cfg["head_dim"] * cfg["heads"] != cfg["hidden_dim"]:
        wrong["head_dim"] = cfg["head_dim"]
    if wrong:
        raise ValueError(f"{wrong}: the GAT implemented has {RECIPE} and "
                         f"hidden_dim / heads features a head")


def build_engine(cfg: dict, graph: Graph, seeds: Seeds, device,
                 ring: Optional[Tuple[int, int]] = None, **engine_kw):
    """The port's ``MpcGatEngine`` of ``cfg`` over ``graph``: one party graph
    a party (the partition of :func:`party_of`), the device plan with the
    features as drawn, the engine with the Glorot leaves and share generator
    of ``seeds``. ``ring`` (bits, fractional bits) overrides the
    configuration's ring (the control's lower precision); ``engine_kw``
    goes to the engine (``cuda_graphs``)."""
    from cognn_tpu_torch.config import GNNParam
    from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
    from cognn_tpu_torch.core.ring import RingSpec
    from cognn_tpu_torch.engine import build_device_plan
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.mpc.gat import MpcGatEngine

    check_recipe(cfg)
    if cfg["layout"] != "stacked":
        raise ValueError(f"layout {cfg['layout']!r}: this system stacks the "
                         "parties on one card")
    P = cfg["parties"]
    vids = np.arange(graph.n)
    tid = {int(v): int(p) for v, p in zip(vids, party_of(graph.n, P))}
    graphs = []
    for p in range(P):
        g = build_party_graph(graph.src, graph.dst, None, tid, p, P,
                              all_vids=vids)
        g.set_vertex_data(vids, graph.features, graph.labels)
        graphs.append(g)
    plan = build_device_plan(graphs, degree_scale=False)
    param = GNNParam(num_layers=cfg["num_layers"],
                     num_labels=cfg["num_labels"],
                     input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                     num_samples=cfg["num_samples"],
                     num_edges=cfg["num_edges"],
                     learning_rate=cfg["learning_rate"],
                     train_ratio=cfg["train_ratio"],
                     val_ratio=cfg["val_ratio"], test_ratio=cfg["test_ratio"])
    bits, frac = ring or (cfg["ring_bits"], cfg["frac_bits"])
    return MpcGatEngine(
        plan, param, fp=FixedPointSpec(RingSpec(bits), frac),
        truncation=cfg["truncation"], seed=seeds.glorot,
        prng_seed=seeds.shares, mode=cfg["layout"],
        aggregation=cfg["aggregation"], device=device, heads=cfg["heads"],
        out_heads=cfg["output_heads"], negative_slope=cfg["negative_slope"],
        **engine_kw)


def build(cfg: dict, graph: Graph, seeds: Seeds, device,
          ring: Optional[Tuple[int, int]] = None) -> System:
    device = torch.device(device)
    return System(build_engine(cfg, graph, seeds, device, ring), device)
