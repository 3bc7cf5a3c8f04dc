"""Communication accounting, counted and analytic (port of
``cognn_tpu/engine/comm_model.py``).

The reference measures per-NIC bytes around each run with psutil
(`tools/tmp_run_cluster.py:77-103`). The JAX package reads the collectives
of a sharded program off its jaxpr (``traced_collectives``, which has no
counterpart in PyTorch); the port counts them where it calls them: each
:class:`cognn_tpu_torch.utils.distributed.PartyGroup` collective adds its
wire bytes a party (``all_to_all`` (P-1)/P of its input, ``all_reduce``
2(P-1)/P, ``all_gather`` (P-1)/P of its output) and one call. A call is one
round: a synchronization point whose cost scales with the interconnect's
latency. :func:`engine_epoch_comm` reads those counters around one epoch or
forward of a sharded engine. Unlike JAX's trace, it RUNS that epoch (and so
updates the engine's weights).

:func:`analytic_bytes_per_epoch` and :func:`analytic_rounds_per_epoch` are
the closed-form twins, for the port's collectives. Each GAS aggregation is
one halo ``all_to_all`` of P chunks of M rows (``sparse``) or V rows
(``bcsr``, ``dense``), 4 bytes an element plaintext and 2 shares of
4·limbs bytes secret-shared (``limbs = ring_bits / 32``), as in the JAX
package. Each layer's weight mean is one ``all_reduce``: of the f32 weights
plaintext, and of both shares at once secret-shared, 8·limbs bytes an
element and ONE round a layer; the JAX package sums 16-bit planes there
(``_ring_psum_shares``), 16·limbs bytes and 4·limbs rounds a layer
(``cognn_tpu/engine/comm_model.py:228-230, 250-252``). The results name the
port's collectives (``all_reduce`` where JAX says ``psum``).

:func:`predict_epoch_duration` and :func:`duration_grid` put bytes and
rounds on the reference's simulated networks.
"""

from __future__ import annotations

from typing import Dict

from cognn_tpu_torch.utils.distributed import wire_bytes

# the reference's simulated-network grid (`tools/tmp_run_cluster.py:23-29`,
# `tools/scripts/setup_network.sh:32-39`)
REFERENCE_BANDWIDTHS_MBIT = (200, 400, 1000, 4000)
REFERENCE_LATENCIES_MS = (0.15, 1.0, 10.0, 20.0)


def predict_epoch_duration(compute_s: float, bytes_per_epoch: float,
                           rounds_per_epoch: float, bandwidth_mbit: float,
                           latency_ms: float) -> float:
    """Predicted epoch duration on an interconnect with the given per-link
    bandwidth and one-way latency:

        duration = compute + wire_bytes*8/bandwidth + rounds*latency

    the counterpart of the reference's Tables 1/2 (epoch duration under the
    tc htb/netem grid). It assumes no compute/comm overlap (an upper bound,
    matching how the netem delay serializes the reference's interactive
    2PC rounds)."""
    return (compute_s + bytes_per_epoch * 8.0 / (bandwidth_mbit * 1e6)
            + rounds_per_epoch * latency_ms * 1e-3)


def duration_grid(compute_s: float, bytes_per_epoch: float,
                  rounds_per_epoch: float,
                  bandwidths=REFERENCE_BANDWIDTHS_MBIT,
                  latencies=REFERENCE_LATENCIES_MS):
    """{(bw_mbit, lat_ms): predicted seconds} over the reference grid."""
    return {(bw, lat): predict_epoch_duration(
        compute_s, bytes_per_epoch, rounds_per_epoch, bw, lat)
        for bw in bandwidths for lat in latencies}


def _opt_agg_dims(dims) -> list:
    """Aggregation-phase widths of one CoGNN-Opt epoch (mirrors
    GasEngine._epoch_opt's dataflow; 3L-2 GAS aggregations per epoch)."""
    L = len(dims) - 1
    out = [dims[l + 1] for l in range(L)]
    hdim = dims[L]
    g = None
    for phase in range(L, 3 * L):
        l = L - 1 - (phase - L) // 2
        first = ((phase - L) % 2 == 0)
        if phase % L != 0:
            out.append(hdim)
        if first:
            g = dims[l]
        else:
            hdim = g
    return out


def _unopt_agg_dims(dims) -> list:
    L = len(dims) - 1
    return [dims[l] for l in range(L)] + [dims[l]
                                          for l in reversed(range(1, L))]


def _variant_agg_dims(dims, variant: str, mpc: bool,
                      hoist_agg: bool | None) -> list:
    """Aggregation widths of one epoch/forward of ``variant``. The mpc
    engines hoist the unopt schedule's loop-invariant layer-0 aggregation
    agg(x0) out of every epoch by default (``hoist_agg=None`` resolves to
    ``mpc``), which removes its f-wide halo collective from every epoch;
    pass ``hoist_agg=False`` for the reference-faithful schedule
    (MpcGasEngine(hoist_agg=False))."""
    L = len(dims) - 1
    agg_dims = (_unopt_agg_dims(dims) if variant == "unopt"
                else _opt_agg_dims(dims))
    if variant == "opt_inference":
        agg_dims = [dims[l + 1] for l in range(L)]
    elif variant == "unopt_inference":
        # original-gcn forward aggregates in the INPUT width per layer
        agg_dims = [dims[l] for l in range(L)]
    if hoist_agg is None:
        hoist_agg = mpc
    if hoist_agg and variant.startswith("unopt"):
        agg_dims = agg_dims[1:]  # layer-0 agg(x0) precomputed at init
    return agg_dims


def analytic_bytes_per_epoch(plan, param, variant: str = "opt",
                             mpc: bool = False,
                             aggregation: str = "sparse",
                             limbs: int = 2,
                             hoist_agg: bool | None = None
                             ) -> Dict[str, float]:
    """Closed-form per-party bytes sent in one epoch (or, for an
    ``*_inference`` variant, one forward) of the port's sharded engines:
    ``{"all_to_all", "all_reduce", "total"}`` (see the module docstring;
    ``limbs`` = ring_bits / 32)."""
    P = plan.num_parties
    if P <= 1:
        return {"all_to_all": 0.0, "all_reduce": 0.0, "total": 0.0}
    dims = param.layer_dims
    agg_dims = _variant_agg_dims(dims, variant, mpc, hoist_agg)
    halo_rows = plan.M if aggregation == "sparse" else plan.V
    elem = 8 * limbs if mpc else 4  # 2 shares of 4·limbs bytes, or f32
    a2a = float(sum(wire_bytes("all_to_all", P * halo_rows * d * elem, P)
                    for d in agg_dims))
    reduce = (0.0 if variant.endswith("inference") else float(sum(
        wire_bytes("all_reduce", dims[l] * dims[l + 1] * elem, P)
        for l in reversed(range(len(dims) - 1)))))
    return {"all_to_all": a2a, "all_reduce": reduce, "total": a2a + reduce}


def analytic_rounds_per_epoch(param, variant: str = "opt",
                              mpc: bool = False,
                              limbs: int = 2,
                              hoist_agg: bool | None = None
                              ) -> Dict[str, float]:
    """Closed-form collective calls (rounds) in one epoch or forward of the
    port's sharded engines: one halo ``all_to_all`` an aggregation, one
    ``all_reduce`` a layer's weight mean, plaintext or secret-shared at
    either ring width (``limbs`` is kept for the JAX package's signature
    and changes nothing here). ``hoist_agg`` as in
    :func:`_variant_agg_dims`."""
    dims = param.layer_dims
    n_agg = len(_variant_agg_dims(dims, variant, mpc, hoist_agg))
    n_reduce = 0 if variant.endswith("inference") else len(dims) - 1
    return {"all_to_all": float(n_agg), "all_reduce": float(n_reduce),
            "total": float(n_agg + n_reduce)}


def engine_epoch_comm(engine, kind: str = "epoch"
                      ) -> Dict[str, Dict[str, float]]:
    """Counted per-party collective bytes and rounds of one training epoch
    (``kind="epoch"``, :meth:`run_epoch`) or one ``forward()``
    (``kind="forward"``) of a SHARDED engine (plaintext GasEngine or
    MpcGasEngine) in this process: its group's counters are reset, the
    epoch or forward RUNS, and the counters are read. A graphed engine
    counts as an eager one: its first call (the warm-up) and every replay
    run each collective once, and a capture runs none.
    Returns ``{"bytes": {collective: b, ..., "total": b}, "rounds":
    {collective: n, ..., "total": n}}``, ``all_to_all`` and ``all_reduce``
    always present."""
    if engine.mode != "sharded":
        raise ValueError("counted comm accounting needs a sharded engine")
    if kind not in ("epoch", "forward"):
        raise ValueError(f"kind {kind!r} (epoch or forward)")
    group = engine.comm.group
    group.reset_counts()
    if kind == "epoch":
        engine.run_epoch()
    else:
        engine.forward()
    out = {}
    for key, counts in (("bytes", group.bytes), ("rounds", group.calls)):
        d = {"all_to_all": 0.0, "all_reduce": 0.0,
             **{k: float(v) for k, v in counts.items()}}
        d["total"] = sum(d.values())
        out[key] = d
    return out


def engine_epoch_bytes(engine, kind: str = "epoch") -> Dict[str, float]:
    """Bytes half of :func:`engine_epoch_comm`."""
    return engine_epoch_comm(engine, kind)["bytes"]
