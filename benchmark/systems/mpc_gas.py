"""The system under test of the ``mpc_gas`` configurations: the port's
secret-shared GCN engine (``MpcGasEngine``), stacked on one card, built from
a configuration and the inputs drawn from the seed, and what the loops and
the check read of it (revealed weights, fetched metrics, served logits in
the reference's layout).

This is the one file of the benchmark that imports ``cognn_tpu_torch``;
it imports it inside the functions, so that a checkout without the port
fails where it first needs it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness.data import Graph, Seeds, party_of


def build_engine(cfg: dict, graph: Graph, seeds: Seeds, device,
                 ring: Optional[Tuple[int, int]] = None):
    """The port's ``MpcGasEngine`` of ``cfg`` over ``graph``: one party
    graph a party (the partition of :func:`party_of`), the device plan, the
    engine with the Glorot weights and share generator of ``seeds``.
    ``ring`` (bits, fractional bits) overrides the configuration's ring
    (the control's lower precision)."""
    from cognn_tpu_torch.config import GNNParam
    from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
    from cognn_tpu_torch.core.ring import RingSpec
    from cognn_tpu_torch.engine import build_device_plan
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.mpc.engine import MpcGasEngine

    if cfg["layout"] != "stacked":
        raise ValueError(f"layout {cfg['layout']!r}: this system stacks the "
                         "parties on one card")
    P = cfg["parties"]
    vids = np.arange(graph.n)
    parts = party_of(graph.n, P)
    tid = {int(v): int(p) for v, p in zip(vids, parts)}
    graphs = []
    for p in range(P):
        g = build_party_graph(graph.src, graph.dst, None, tid, p, P,
                              all_vids=vids)
        g.set_vertex_data(vids, graph.features, graph.labels)
        graphs.append(g)
    plan = build_device_plan(graphs)
    param = GNNParam(num_layers=cfg["num_layers"],
                     num_labels=cfg["num_labels"],
                     input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                     num_samples=cfg["num_samples"],
                     num_edges=cfg["num_edges"],
                     learning_rate=cfg["learning_rate"],
                     train_ratio=cfg["train_ratio"],
                     val_ratio=cfg["val_ratio"], test_ratio=cfg["test_ratio"])
    bits, frac = ring or (cfg["ring_bits"], cfg["frac_bits"])
    return MpcGasEngine(
        plan, param, variant=cfg["variant"],
        fp=FixedPointSpec(RingSpec(bits), frac),
        truncation=cfg["truncation"], seed=seeds.glorot,
        prng_seed=seeds.shares, mode=cfg["layout"],
        aggregation=cfg["aggregation"], device=device)


def real_weights(engine) -> List[np.ndarray]:
    """The engine's weights, reconstructed from its shares (a wrapping sum)
    and read as float64 [P held, d_in, d_out] a layer."""
    f = engine.proto.f
    return [(w[0] + w[1]).cpu().to(torch.float64).numpy() / 2.0 ** f
            for w in engine.weights_sh]


def to_reference_rows(engine, z: torch.Tensor) -> np.ndarray:
    """Stacked logits [P, V, C] in the plan's vertex order -> [P, n_p max,
    C] in each party's ascending vertex order, the reference's layout
    (rows past a party's vertices NaN)."""
    plan = engine.plan
    z = z.detach().cpu().numpy()
    P = z.shape[0]
    n = plan.num_local
    out = np.full((P, int(n.max()), z.shape[-1]), np.nan, np.float32)
    for p in range(P):
        out[p, plan.vertex_order[p, :n[p]]] = z[p, :n[p]]
    return out


class System:
    """The engine behind the calls the loops make."""

    def __init__(self, engine, device: torch.device):
        self.engine, self.device = engine, device

    def epochs(self, n: int) -> Dict[str, np.ndarray]:
        """``n`` training epochs in one dispatch (``run_epochs_scan``),
        their stacked metrics fetched to the host."""
        return self.engine.metrics_host(self.engine.run_epochs_scan(n))

    def weights(self) -> List[np.ndarray]:
        return real_weights(self.engine)

    def request(self) -> torch.Tensor:
        """One full-graph inference, its revealed logits fetched."""
        return self.engine.forward()[0].cpu()

    def rows(self, answer: torch.Tensor) -> np.ndarray:
        return to_reference_rows(self.engine, answer)


def build(cfg: dict, graph: Graph, seeds: Seeds, device,
          ring: Optional[Tuple[int, int]] = None) -> System:
    device = torch.device(device)
    return System(build_engine(cfg, graph, seeds, device, ring), device)
