"""Variants of the SDDMM kernel (``csrc/sddmm.cu``, K5) timed beside the
shipped build on the card.

    python -m cognn_tpu_torch.tools.sweep_sddmm [--reps 100] [--json PATH]

Each variant is the shipped source with the edits of :data:`VARIANTS`,
built and swapped in by the machinery of
:mod:`cognn_tpu_torch.tools.sweep_spmm` (each edit must match the source
exactly once; one ``nvcc`` a variant, in parallel) and launched through
:class:`~cognn_tpu_torch.ops.sddmm.Sddmm`, which picks the loads and the
lanes as always. Seven variants are other designs: batches of 1, 2 and 8
edges a lane group; twice, half and a quarter of the lanes an edge (fewer
lanes: a float4 lane loops over more chunks, a scalar lane covers 2 or 4
elements a chunk); and every lane loading its own edges' indices (no
hand-out by shuffles). Each is held to the plain version before it is
timed (rtol 1e-5, atol 1e-5 of max|plain|: the same products summed in
another order). Three remove a part of the kernel and compute something
else, so they are only timed: no row gathers (each value made from its
edge's indices, which are still loaded), no index loads (each edge's
source hashed from its position by a multiply and a high multiply,
scattered over the rows; its destination the position scaled onto the
rows, in order, as the cells' destination-major edges are; the rows of a
and b reach the kernel as two more arguments of the C entry, last), and
neither.
Shapes: the flat edges of synthetic Cora with 2 parties and PubMed with 4
at D = 16 and the label width, and the microbenchmark's graph at D = 16
on ``(h, h)``, random normal rows from a fixed seed. Timing as in
``sweep_spmm``: in turns, forward then backward, the first line the
launch floor. Raises without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json

import numpy as np
import torch

from cognn_tpu_torch.ops import sddmm as sddmm_mod
from cognn_tpu_torch.ops.sddmm import Sddmm, launch_shape, sddmm_plain
from cognn_tpu_torch.tools import bench_spmm
from cognn_tpu_torch.tools.sweep_spmm import (
    build_variants,
    entry_points,
    time_in_turns,
)
from cognn_tpu_torch.utils.device import resolve_device
from cognn_tpu_torch.utils.timing import device_ms

SUM_ORDER = 1e-5  # rtol, and atol as a share of max|plain|

_PICK = "  const Kernel kernel = pick(vec, lanes, d);\n"
# a scalar lane covering 2 or 4 elements a chunk at every lane count, not
# only at 32 (what fewer lanes than the shipped build's ask for)
_SCALAR_WIDE = (
    """\
  if (lanes != 32) return nullptr;
  return d <= 64 ? edge_dot_f32<1, 2, 32> : edge_dot_f32<1, 4, 32>;
""", """\
  if (d <= 2 * lanes) return with_lanes<1, 2>(lanes);
  return with_lanes<1, 4>(lanes);
""")
# the rows of a and b (n_src, n_dst) passed to the kernel, last in the C
# entry's arguments: what the no-index-loads ablation scatters its made-up
# indices over
_ROWS = (
    ("int64_t n_edges, int d) {", "int64_t n_edges, int n_src, int n_dst, "
     "int d) {"),
    ("float*, int64_t, int);", "float*, int64_t, int, int, int);"),
    ("cudaStream_t stream) {", "cudaStream_t stream, int n_src, "
     "int n_dst) {"),
    ("(src, dst, a, b, out, n_edges, d);", "(src, dst, a, b, out, n_edges, "
     "n_src, n_dst, d);"),
)
_HANDOUT = """\
  int held_src[kHeld], held_dst[kHeld];
#pragma unroll
  for (int m = 0; m < kHeld; ++m) {
    const int k = m * 32 + lane;
    const bool ok = k < kWarpEdges && base + k < n_edges;
    held_src[m] = ok ? src[base + k] : 0;
    held_dst[m] = ok ? dst[base + k] : 0;
  }
  // edge j of group q (warp offset j * NG + q) sits in lane j % GC * NG + q,
  // slot j / GC
  int es[kBatch], ed[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    es[j] = __shfl_sync(~0u, held_src[j / GC], j % GC * NG + q);
    ed[j] = __shfl_sync(~0u, held_dst[j / GC], j % GC * NG + q);
  }
"""
_PER_LANE = """\
  int es[kBatch], ed[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int64_t e = base + j * NG + q;
    es[j] = e < n_edges ? src[e] : 0;
    ed[j] = e < n_edges ? dst[e] : 0;
  }
"""
_LOADS = """\
    held_src[m] = ok ? src[base + k] : 0;
    held_dst[m] = ok ? dst[base + k] : 0;
"""
_NO_LOADS = """\
    held_src[m] = static_cast<int>(__umulhi(
        static_cast<uint32_t>(base + k) * 2654435761u,
        static_cast<uint32_t>(n_src)));
    held_dst[m] = static_cast<int>((base + k) * n_dst / n_edges);
"""
_GATHER = """\
        load_piece<V>(a + static_cast<int64_t>(es[j]) * d + c, d - c, x[j]);
        load_piece<V>(b + static_cast<int64_t>(ed[j]) * d + c, d - c, y[j]);
"""
_NO_GATHER = """\
#pragma unroll
        for (int i = 0; i < W; ++i) {
          x[j][i] = static_cast<float>(es[j] + c + i);
          y[j][i] = static_cast<float>(ed[j] - i);
        }
"""

# name -> (edits (old, new) of the source, computes the kernel's function)
VARIANTS = {
    "shipped": ((), True),
    "batch 1": ((("kBatch = 4;", "kBatch = 1;"),), True),
    "batch 2": ((("kBatch = 4;", "kBatch = 2;"),), True),
    "batch 8": ((("kBatch = 4;", "kBatch = 8;"),), True),
    "lanes x2": (((_PICK, "  lanes = lanes < 32 ? 2 * lanes : 32;\n" +
                   _PICK),), True),
    "lanes /2": (((_PICK, "  lanes = lanes > 1 ? lanes / 2 : 1;\n" + _PICK),
                  _SCALAR_WIDE), True),
    "lanes /4": (((_PICK, "  lanes = lanes > 4 ? lanes / 4 : 1;\n" + _PICK),
                  _SCALAR_WIDE), True),
    "per-lane index loads": (((_HANDOUT, _PER_LANE),), True),
    "no row gathers": (((_GATHER, _NO_GATHER),), False),
    "no index loads": (((_LOADS, _NO_LOADS), *_ROWS), False),
    "neither": (((_GATHER, _NO_GATHER), (_LOADS, _NO_LOADS), *_ROWS), False),
}
TAKES_ROWS = {name for name, (edits, _) in VARIANTS.items()
              if _ROWS[0] in edits}

use = functools.partial(entry_points, module=sddmm_mod, attr="_kernel")


def with_rows(fns: dict, k: Sddmm) -> dict:
    """``fns``, with the variants of :data:`TAKES_ROWS` given ``k``'s rows
    after the shipped arguments."""
    return {name: (lambda *args, f=f: f(*args, k.n_src, k.n_dst))
            if name in TAKES_ROWS else f for name, f in fns.items()}


def shapes(dev):
    """(name, Sddmm, a, b) for every timed shape; random normal rows from a
    fixed seed."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.harness.datasets import party_plan

    rng = np.random.default_rng(0)
    for name, dataset, parties in (("cora_2p", "cora", 2),
                                   ("pubmed_4p", "pubmed", 4)):
        plan, param = party_plan(dataset, parties)
        spmm = GasEngine(plan, param, "opt_inference", device=dev).spmm
        k = Sddmm(*spmm.edge_list(), spmm.n_src, spmm.n_dst, dev)
        for D in param.layer_dims[1:]:
            yield name, k, *(torch.from_numpy(rng.standard_normal(
                (n, D), dtype=np.float32)).to(dev) for n in (k.n_src, k.n_dst))
    case = bench_spmm.setup(device=dev)
    yield "bench", case.sddmm, case.h, case.h


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    built = build_variants(VARIANTS, "sddmm", sddmm_mod.bind)
    for name in TAKES_ROWS:
        built[name].argtypes = built[name].argtypes + [ctypes.c_int] * 2
    floor = device_ms(torch.zeros(1, device=dev).zero_, args.reps, dev)
    print(json.dumps({"launch_floor_ms": floor}), flush=True)
    rows = []
    for name, k, a, b in shapes(dev):
        call = lambda k=k, a=a, b=b: k(a, b)  # noqa: E731
        fns = with_rows(built, k)
        want = sddmm_plain(k.src, k.dst, a, b)
        atol = SUM_ORDER * want.abs().max().item()
        for variant, (_, exact) in VARIANTS.items():
            if exact:
                with use(fns[variant]):
                    got = call()
                torch.testing.assert_close(got, want, rtol=SUM_ORDER,
                                           atol=atol, msg=lambda m: (
                                               f"{name} {variant}: {m}"))
        ms = time_in_turns(call, fns, use, args.reps, dev)
        shape = launch_shape(a.shape[1], 4, (a.data_ptr(), b.data_ptr()))
        for variant, t in ms.items():
            row = dict(shape=name, D=a.shape[1], edges=k.n_edges,
                       variant=variant, vec_lanes=shape, ms=t)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(dev),
                       "launch_floor_ms": floor, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
