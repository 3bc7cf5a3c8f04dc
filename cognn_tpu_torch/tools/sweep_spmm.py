"""Variants of the CSR SpMM kernels (``csrc/spmm.cu``) timed beside the
shipped build on the card.

    python -m cognn_tpu_torch.tools.sweep_spmm [--reps 100] [--json PATH]

Each variant is the shipped source with the edits of :data:`VARIANTS`
(each edit must match the source exactly once), compiled into
``cognn_tpu_torch/_build/variants/`` and launched through the wrappers
(:class:`~cognn_tpu_torch.ops.spmm.Spmm` and its ``ring``, which pick the
loads as always), with the variant's entry points in place of the shipped
ones. Five variants are other designs: one entry slot a row, 8 entries a
slot, 256 threads a block, a row's column chunks looped over in one group
(one block row; the shipped build gives each chunk a block row), and the
entries handed out by coalesced loads and ``__shfl_sync``; each is held to
the plain version before it is timed (f32 rtol/atol 1e-5, ring
``torch.equal``). Three remove a part of the kernel and compute something
else, so they are only timed: no H gathers (each value made from its
source index, which is still loaded), no index loads (each source hashed
from the entry's position by a multiply and a high multiply, scattered over
the rows, counts 1), and neither. Shapes: the flat CSR of synthetic Cora
with 2 parties and PubMed with 4 (the engines' aggregation) at the input
width (the unopt layer-0 aggregation), D = 16 and the label width, f32 and
ring, and the microbenchmark's graph at D = 16, f32. The variants of one
shape run in turns, forward then backward, and each time printed is the
mean of the two windows
(:func:`~cognn_tpu_torch.utils.timing.device_ms`, µs-scale calls queued
behind a sleep kernel); the first line is the launch floor, a one-element
``zero_`` timed the same way. Raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.ops import spmm as spmm_mod
from cognn_tpu_torch.ops.spmm import launch_shape, spmm_plain
from cognn_tpu_torch.tools import bench_spmm
from cognn_tpu_torch.utils.device import resolve_device
from cognn_tpu_torch.utils.timing import device_ms

_LOADS = """\
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = b + j * GE + slot;
        src[j] = e < end ? indices[e] : 0;
        w[j] = e < end ? counts[e] : T(0);
      }
"""
_GATHER = "load_row(p + s * h_share, x[j][s]);"
_NO_GATHER = "for (int v = 0; v < V; ++v) x[j][s][v] = T(src[j] + v);"
_NO_LOADS = """\
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = b + j * GE + slot;
        src[j] = static_cast<int>(__umulhi(static_cast<uint32_t>(e) *
                                           2654435761u,
                                           static_cast<uint32_t>(n_dst)));
        w[j] = T(1);
      }
"""
# a batch's entries loaded by the whole group at once, then each sent to
# its slot's lanes with __shfl_sync
_SHUFFLE = """\
      constexpr int kPerLane = (kRowBatch + G - 1) / G;
      int idx[kPerLane];
      T cnt[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int k = i * G + g;  // entry b + k
        const bool ok = k < kRowBatch && b + k < end;
        idx[i] = ok ? indices[b + k] : 0;
        cnt[i] = ok ? counts[b + k] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = j * GE + slot;
        src[j] = __shfl_sync(group, idx[k / G], k % G, G);
        w[j] = __shfl_sync(group, cnt[k / G], k % G, G);
      }
"""

# name -> (edits (old, new) of the source, computes the kernel's function)
VARIANTS = {
    "shipped": ((), True),
    "1 slot": ((("kSlots = GC < 32 ? 2 : 1;", "kSlots = 1;"),), True),
    "8 entries a slot": ((("kBatch = 4;", "kBatch = 8;"),), True),
    "256 threads": ((("kThreads = 128;", "kThreads = 256;"),), True),
    # a wide row's chunks looped over in one group, one block row
    "chunks in one group": (((
        "const int chunks = (d + GC * V - 1) / (GC * V);",
        "const int chunks = 1;"),), True),
    "shuffle hand-out": (((_LOADS, _SHUFFLE),), True),
    "no H gathers": (((_GATHER, _NO_GATHER),), False),
    "no index loads": (((_LOADS, _NO_LOADS),), False),
    "neither": (((_GATHER, _NO_GATHER), (_LOADS, _NO_LOADS)), False),
}


def variant_source(edits, name: str = "spmm") -> str:
    """``csrc/<name>.cu`` with ``edits`` made; raises where an edit's text
    is not in the source exactly once."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit target found {src.count(old)} times in "
                             f"{name}.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(variants=VARIANTS, name: str = "spmm",
                   bind=spmm_mod.bind) -> dict:
    """Each variant's entry points (``bind`` of its library), compiled in
    parallel."""
    out = _build.BUILD_DIR / "variants"

    def one(item):
        i, (variant, (edits, _)) = item
        cu = out / f"{name}_{i}.cu"
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(variant_source(edits, name))
        _build.compile_cu(cu, cu.with_suffix(".so"))
        return variant, bind(ctypes.CDLL(str(cu.with_suffix(".so"))))

    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each
        return dict(pool.map(one, enumerate(variants.items())))


@contextlib.contextmanager
def entry_points(fns, module=spmm_mod, attr: str = "_kernels"):
    """The wrappers of ``module`` launch ``fns`` instead of the shipped
    build's entry points (what ``module.<attr>()`` returns) while this is
    open."""
    shipped = getattr(module, attr)
    setattr(module, attr, lambda: fns)
    try:
        yield
    finally:
        setattr(module, attr, shipped)


def time_in_turns(call, fns, use, reps: int, dev) -> dict:
    """ms of one ``call()`` under each variant's entry points (``use(fns[
    variant])`` opens them): the variants in turns, forward then backward,
    each time the mean of its two windows."""
    ms = dict.fromkeys(fns, 0.0)
    for order in (list(fns), list(fns)[::-1]):
        for variant in order:
            with use(fns[variant]):
                ms[variant] += device_ms(call, reps, dev) / 2
    return ms


def shapes(dev):
    """(name, Spmm, D, ring, h) for every timed shape; ``h`` from a fixed
    seed (standard normal f32, full-range int64 shares)."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.harness.datasets import party_plan

    rng = np.random.default_rng(0)
    cells = []
    for name, dataset, parties in (("cora_2p", "cora", 2),
                                   ("pubmed_4p", "pubmed", 4)):
        plan, param = party_plan(dataset, parties)
        k = GasEngine(plan, param, "opt_inference", device=dev).spmm
        cells.append((name, k, param.layer_dims, (False, True)))
    cells.append(("bench", bench_spmm.setup(device=dev).spmm, (16,),
                  (False,)))
    for name, k, widths, kinds in cells:
        for D, ring in itertools.product(widths, kinds):
            if ring:
                h = torch.from_numpy(rng.integers(
                    -(1 << 63), (1 << 63) - 1, (2, k.n_src, D),
                    dtype=np.int64)).to(dev)
            else:
                h = torch.from_numpy(rng.standard_normal(
                    (k.n_src, D), dtype=np.float32)).to(dev)
            yield name, k, D, ring, h


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    fns = build_variants()
    one = torch.zeros(1, device=dev)
    floor = device_ms(one.zero_, args.reps, dev)
    print(json.dumps({"launch_floor_ms": floor}), flush=True)
    rows = []
    for name, k, D, ring, h in shapes(dev):
        if k.n_src < k.n_dst:
            raise ValueError("the no-index-loads variant needs n_src >= "
                             "n_dst")
        call = (lambda k=k, h=h: k.ring(h)) if ring else (lambda k=k, h=h:
                                                            k(h))
        counts = k.counts_i64 if ring else k.counts
        want = spmm_plain(k.indptr, k.indices, counts, h)
        for variant, (_, exact) in VARIANTS.items():
            if not exact:
                continue
            with entry_points(fns[variant]):
                got = call()
            if ring and not torch.equal(got, want):
                raise AssertionError(f"{name} D={D} {variant}: ring output "
                                     "differs from plain")
            if not ring:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        ms = time_in_turns(call, fns, entry_points, args.reps, dev)
        launch = launch_shape(D, h.element_size(), (h.data_ptr(),),
                              (k.n_src * D, k.n_dst * D) if ring else ())
        for variant, t in ms.items():
            row = dict(shape=name, D=D, kernel="ring" if ring else "f32",
                       nnz=k.nnz, n=k.n_dst, variant=variant,
                       vec_lanes=launch, ms=t)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(dev),
                       "launch_floor_ms": floor, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
