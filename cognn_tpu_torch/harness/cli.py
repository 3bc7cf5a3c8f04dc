"""CLI argument surface (port of ``cognn_tpu/harness/cli.py``; reference
`include/harness.h:25-220`).

Flags (same letters as the reference's getopt list):
  -t/--threads, -g/--tiles, -i/--tile-index, -m/--max-iters, -p/--num-parts,
  -s/--setting, -n/--no-preprocess, -c/--cluster, -r/--no-dummy-edge,
  -u/--undirected
Positionals: edgelist vertexlist partition output gnnconfig.

Extensions, as in the JAX package: --variant, --mpc, --mode, --ring-bits,
--scaler-bits, --aggregation, --reorder, --dense-aggregation,
--checkpoint-every, --coordinator. The port's own: --device {cuda,cpu}, and
--profile DIR (a ``torch.profiler`` trace) in place of --jax-profile.

The multi-process mode: ``-c`` makes this process party ``-i`` of ``-g``,
which meets the others at ``--coordinator`` (``host:port``, where party 0
listens) over ``torch.distributed``; ``--mode sharded`` without ``-c``
starts the ``-g`` party processes on this host itself
(:mod:`cognn_tpu_torch.harness.run_party`).
"""

from __future__ import annotations

import argparse

from cognn_tpu_torch.config import RunConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cognn-tpu-torch",
        description="collaborative GNN training/inference on PyTorch and "
                    "CUDA (CoGNN capability rebuild)")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="threads of the native graph file parser "
                        "(0 = auto: one below 4096 rows, else the host's "
                        "cores up to 16)")
    p.add_argument("-g", "--tiles", type=int, default=2,
                   help="number of parties/graph tiles")
    p.add_argument("-i", "--tile-index", type=int, default=0,
                   help="this party's index (per-party mode)")
    p.add_argument("-m", "--max-iters", type=int, default=6,
                   help="GAS schedule iterations (6 per opt epoch)")
    p.add_argument("-p", "--num-parts", type=int, default=1,
                   help="accepted for reference CLI parity; the reference "
                        "GCN kernels never read numParts either (it feeds "
                        "the vestigial plaintext analytics path, "
                        "algo_kernel.h:82-89)")
    p.add_argument("-s", "--setting", type=str, default="default",
                   help="run setting tag (log/checkpoint naming)")
    p.add_argument("-n", "--no-preprocess", action="store_true",
                   help="restore the checkpoint of this setting if present")
    p.add_argument("-c", "--cluster", action="store_true",
                   help="multi-process mode (one process per party)")
    p.add_argument("-r", "--no-dummy-edge", action="store_true",
                   help="pad only isolated vertices (reference -r mode)")
    p.add_argument("-u", "--undirected", action="store_true",
                   help="add reverse edges at load")
    p.add_argument("edge_file")
    p.add_argument("vertex_file")
    p.add_argument("partition_file")
    p.add_argument("output_file")
    p.add_argument("gnn_config_file")
    p.add_argument("--variant",
                   choices=["opt", "unopt", "inference", "unopt-inference",
                            "ss"],
                   default="opt",
                   help="ss = the reference's gcn-ss build: the unopt "
                        "(fused original-style) schedule in share space "
                        "(sets --mpc); unopt-inference = the original-gcn "
                        "forward run with maxIters=2 (reference "
                        "tmp_run_cluster.py:417-435)")
    p.add_argument("--mpc", action="store_true",
                   help="secret-shared execution (additive shares, Z_2^64)")
    p.add_argument("--mode", choices=["stacked", "sharded"],
                   default="stacked",
                   help="sharded = one process per party (without -c: "
                        "started here, one per local card)")
    p.add_argument("--ring-bits", type=int, default=64, choices=[32, 64])
    p.add_argument("--scaler-bits", type=int, default=16,
                   help="fixed-point fractional bits (SCALER_BIT_LENGTH)")
    p.add_argument("--aggregation", default="auto",
                   choices=["auto", "sparse", "dense", "bcsr"],
                   help="aggregation backend, plaintext and mpc (bcsr = "
                        "the CUDA CSR SpMM kernel; dense = one product "
                        "with the dense flat adjacency; sparse = plain "
                        "torch; auto = the faster of bcsr and dense by the "
                        "card's measured numbers)")
    p.add_argument("--reorder", action="store_true",
                   help="BFS-reorder local vertices for aggregation "
                        "locality (semantics preserved, outputs mapped "
                        "back to vids)")
    p.add_argument("--dense-aggregation", action="store_true",
                   help="alias for --aggregation dense")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save weights every N epochs (0 = off)")
    p.add_argument("--coordinator", default="127.0.0.1:29400",
                   help="rendezvous address (multi-process mode)")
    # set on the party processes that --mode sharded starts: they gather
    # the logits and party 0 writes the dump
    p.add_argument("--dump-gathered", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activity) of the run to DIR; the engine runs "
                        "eager, each op launched from its Python frame, "
                        "not as CUDA graph replays")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on (cuda raises without a card)")
    return p


def to_run_config(args: argparse.Namespace) -> RunConfig:
    return RunConfig(
        threads=args.threads,
        tiles=args.tiles,
        tile_index=args.tile_index,
        max_iters=args.max_iters,
        num_parts=args.num_parts,
        setting=args.setting,
        no_preprocess=args.no_preprocess,
        is_cluster=args.cluster,
        no_dummy_edge=args.no_dummy_edge,
        undirected=args.undirected,
        edge_file=args.edge_file,
        vertex_file=args.vertex_file,
        partition_file=args.partition_file,
        output_file=args.output_file,
        gnn_config_file=args.gnn_config_file,
        ring_bits=args.ring_bits,
        scaler_bits=args.scaler_bits,
        variant={"inference": "opt_inference",
                 "unopt-inference": "unopt_inference",
                 "ss": "unopt"}.get(args.variant, args.variant),
    )
