"""Main run entry (port of ``cognn_tpu/harness/run_party.py``; reference
`algo_kernels/common_harness/harness.cpp:50-212`).

Flow (the reference's main): parse args -> GNNParam.read_config -> load the
graph tiles and vertex data (``::graph_load took``) -> device plan
(``::preprocess took``) -> engine -> restore (``-n``) -> train the epochs or
run one forward (``::iteration took`` each) -> output dump. The logs keep
the reference's grep-able lines: the spans, and the ``tid-> 0, iteration->
N`` line and metric block of each epoch (`optimize-gcn/gcn.h:620-632`).

Process models (``cognn_tpu/harness/run_party.py:99-123``):

  * stacked (the default): one process hosts all parties on one device
    (``--device``, the card by default), and prints party 0's metrics;
  * ``-c``: this process is party ``-i`` of ``-g``, the reference's process
    model. It meets the others at ``--coordinator`` over
    ``torch.distributed`` (:mod:`cognn_tpu_torch.utils.distributed`: NCCL
    when each party has a card of its own, else gloo through host copies),
    runs the sharded engines, prints ``tid-> i, ...`` and its own party's
    metrics, checkpoints its own party under ``party<i>/``, and writes no
    dump, as in the JAX package;
  * ``--mode sharded`` without ``-c``: this process starts the ``-g`` party
    processes on this host itself (party i on card ``i % cards``), passes
    party 0's output through, and party 0 writes the usual dump from the
    gathered logits. The JAX package lays the parties over the local
    devices of one process instead.

Every process builds the whole plan from the files, as the JAX package's
does, and keeps its party's slice.

``-n`` restores the weight checkpoint of the setting, ``checkpoints/
<setting>/`` (:mod:`cognn_tpu_torch.harness.checkpoint`). The JAX package's
``-n`` also reuses its persistent XLA compilation cache; the port has no
XLA, and its compile cache is the kernel build (``cognn_tpu_torch/_build/``,
keyed by a hash of each source), which every run reuses. So here ``-n``
means the checkpoint restore only.

The output dump is ``<vid> <logits %.6f>`` a vertex, party by party in
ascending vid order. Under ``--reorder`` the engine's rows follow the plan's
vertex order, so the dump maps them back through ``plan.vertex_order``
(the JAX package writes them in their reordered positions,
``cognn_tpu/harness/run_party.py:186-193``).

Usage:
  python -m cognn_tpu_torch.harness.run_party -g 2 -m 540 \\
      cora.edge.preprocessed cora.vertex.preprocessed \\
      cora.part.preprocessed.2p out.txt cora_config.txt
  # one process per party, started here:   add --mode sharded
  # one process per party, started by hand: add -c -i <i> --coordinator
  #   <host:port of party 0>, in each of the -g processes
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from cognn_tpu_torch.config import GNNParam, RunConfig
from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
from cognn_tpu_torch.core.ring import RingSpec
from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.graph import (build_party_graph, native_io,
                                   read_edge_list, read_partition_file,
                                   read_vertex_file)
from cognn_tpu_torch.harness.checkpoint import save, try_restore
from cognn_tpu_torch.harness.cli import build_parser, to_run_config
from cognn_tpu_torch.mpc import MpcGasEngine
from cognn_tpu_torch.utils.device import resolve_device
from cognn_tpu_torch.utils.distributed import (destroy_party_group,
                                               free_port, init_party_group,
                                               run_parties)
from cognn_tpu_torch.utils.logging_utils import duration_span

PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def load_party_graphs(cfg: RunConfig, param: GNNParam, device=None):
    """The parties' graphs from the run's edge, vertex and partition files
    (the ``::graph_load`` span); ``-t`` > 0 caps the native parser's
    threads."""
    if cfg.threads > 0:
        native_io.set_threads(cfg.threads)
    with duration_span("graph_load", device=device):
        src, dst, w = read_edge_list(cfg.edge_file,
                                     undirected=cfg.undirected)
        vid, feats, labels = read_vertex_file(cfg.vertex_file,
                                              param.input_dim)
        tid = (read_partition_file(cfg.partition_file, cfg.tiles)
               if cfg.tiles > 1 else None)
        graphs = []
        for p in range(cfg.tiles):
            g = build_party_graph(src, dst, w, tid, p, cfg.tiles,
                                  no_dummy_edge=cfg.no_dummy_edge,
                                  all_vids=vid)
            g.set_vertex_data(vid, feats, labels)
            graphs.append(g)
    return graphs


def print_metrics_reference_format(metrics_host: dict, party: int = 0,
                                   num_vertices: int = 0) -> None:
    m = {k: np.asarray(v) for k, v in metrics_host.items()}
    print("--------")
    print(f"cross-entropy-loss = {m['loss'][party]:.6f}")
    print(f"full set accuracy = {m['full_acc'][party]:.6f}")
    print(f"training set accuracy = {m['train_acc'][party]:.6f}")
    print(f"border training set accuracy = {m['border_train_acc'][party]:.6f}")
    print(f"test set accuracy = {m['test_acc'][party]:.6f}")
    print(f"border test set accuracy = {m['border_test_acc'][party]:.6f}")
    print(f"the number of vertices is {num_vertices}, the number of border "
          f"vertices is {int(m['num_border'][party])}", flush=True)


def write_dump(path, graphs, plan, logits: np.ndarray) -> None:
    """``<vid> <logits>`` a vertex (the reference's #ifdef VDATA block,
    harness.cpp:183-194); ``logits [P, V, C]`` in the plan's vertex order,
    written in each party's ascending-vid order."""
    with open(path, "w") as f:
        for p, g in enumerate(graphs):
            n = g.num_local
            rows = np.empty((n, logits.shape[-1]), logits.dtype)
            rows[plan.vertex_order[p, :n]] = logits[p, :n]
            for vid, row in zip(g.local_vids, rows):
                f.write(f"{vid} " + " ".join(f"{x:.6f}" for x in row) + "\n")


def launch_sharded(argv, parties: int) -> int:
    """``--mode sharded`` without ``-c``: run the ``parties`` party
    processes of this command on this host, party 0's output passed
    through, the others' standard output dropped; raises if one fails."""
    port = free_port()
    print(f"sharded: starting {parties} party processes (coordinator "
          f"127.0.0.1:{port})", flush=True)
    path = (str(PACKAGE_ROOT), os.environ.get("PYTHONPATH", ""))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in path if p)}
    run_parties([[sys.executable, "-m", "cognn_tpu_torch.harness.run_party",
                  *argv, "-c", "-i", str(i), "--coordinator",
                  f"127.0.0.1:{port}", "--dump-gathered"]
                 for i in range(parties)],
                stdouts=[None] + [subprocess.DEVNULL] * (parties - 1),
                env=env)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(map(str, argv))
    args = build_parser().parse_args(argv)
    cfg = to_run_config(args)
    if args.variant == "ss":
        args.mpc = True  # gcn-ss is the secret-shared unopt schedule
    fp = FixedPointSpec(RingSpec(cfg.ring_bits), cfg.scaler_bits)
    if args.mode == "sharded" and not cfg.is_cluster:
        resolve_device(args.device)  # no card: raise before starting any
        return launch_sharded(argv, cfg.tiles)
    group = None
    if cfg.is_cluster:
        # one process per party (the reference's process model,
        # engine.h:143-222 channel mesh -> torch.distributed)
        group = init_party_group(cfg.tile_index, cfg.tiles,
                                 args.coordinator, device=args.device)
        print(f"party {cfg.tile_index}: joined cluster ({group})",
              flush=True)
    try:
        return _run(args, cfg, fp, group)
    finally:
        if group is not None:
            destroy_party_group()


def _run(args, cfg: RunConfig, fp: FixedPointSpec, group) -> int:
    """The run of main: stacked when ``group`` is None, else this
    process's party of the group."""
    device = resolve_device(args.device) if group is None else group.device
    tid = 0 if group is None else group.rank  # the party whose lines print
    param = GNNParam.read_config(cfg.gnn_config_file)

    graphs = load_party_graphs(cfg, param, device)
    aggregation = "dense" if args.dense_aggregation else args.aggregation
    with duration_span("preprocess", device=device):
        plan = build_device_plan(graphs, lane=8,
                                 dense=(aggregation == "dense") or None,
                                 reorder=args.reorder)
    mode = "stacked" if group is None else "sharded"
    # a profiled run traces the eager ops, which a graph replay hides
    cuda_graphs = False if args.profile else None
    if args.mpc:
        engine = MpcGasEngine(plan, param, cfg.variant, fp=fp,
                              aggregation=aggregation, device=device,
                              mode=mode, group=group, cuda_graphs=cuda_graphs)
    else:
        engine = GasEngine(plan, param, cfg.variant, mode=mode,
                           aggregation=aggregation, device=device,
                           group=group, cuda_graphs=cuda_graphs)

    ckpt_dir = Path("checkpoints") / cfg.setting
    if cfg.no_preprocess and try_restore(engine, ckpt_dir):
        print(f"restored checkpoint from {ckpt_dir}")

    def print_metrics(metrics):
        # stacked: party 0's entry; sharded: this party's only entry
        print_metrics_reference_format(engine.metrics_local(metrics),
                                       num_vertices=graphs[tid].num_local)

    with contextlib.ExitStack() as stack:
        prof = None
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CPU,
                *([ProfilerActivity.CUDA] if device.type == "cuda" else [])]))
            print(f"profiling to {args.profile}")
        if cfg.variant.endswith("inference"):
            with duration_span("iteration", device=device):
                z, _, metrics = engine.forward()
            print_metrics(metrics)
        else:
            epoch_layers = engine.epoch_layers
            for e in range(max(1, cfg.max_iters // epoch_layers)):
                with duration_span("iteration", device=device):
                    metrics = engine.run_epoch()
                print(f"tid-> {tid}, iteration-> {(e + 1) * epoch_layers}")
                print_metrics(metrics)
                if args.checkpoint_every and \
                        (e + 1) % args.checkpoint_every == 0:
                    save(engine, ckpt_dir, e + 1)
            z, _, _ = engine.forward()
    if prof is not None:
        trace = Path(args.profile) / (
            "trace.json" if group is None else f"party{tid}/trace.json")
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        print(f"profile written to {trace}")

    if group is not None:
        if not args.dump_gathered:
            return 0  # per-party processes skip the global dump
        z = group.all_gather(z)  # [P, V, C], every party's logits
        if tid != 0:
            return 0
    if cfg.output_file and cfg.output_file != "-":
        write_dump(cfg.output_file, graphs, plan, z.cpu().numpy())
        print(f"wrote vertex outputs to {cfg.output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
