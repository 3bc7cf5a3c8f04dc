"""Per-phase device-time breakdown of the secret-shared epoch from a
``torch.profiler`` trace (port of the repo's ``tools/profile_mpc_epoch.py``).

Traces ``--reps`` calls of ``run_epochs_scan(--scan)`` on a stacked
:class:`~cognn_tpu_torch.mpc.MpcGasEngine` with the Python tracer on
(``with_stack=True``), exports the Chrome trace, and attributes every
device event (kernel, memcpy, memset) to the engine function that launched
it. The engine is built with ``cuda_graphs=False`` and runs eager, as the
output says: on the card the stacked engines replay each epoch as one CUDA
graph (:mod:`cognn_tpu_torch.engine.graphs`), whose launch carries no
Python frame to attribute its kernels to. The device time an epoch is the
same work either way; the wall time is the eager engine's.

  1. the event's ``correlation`` finds its launch on the host (a
     ``cuda_runtime`` or ``cuda_driver`` event: ``cudaLaunchKernel``,
     ``cudaMemsetAsync``, ...);
  2. on the launch's thread, the Python frames (``"<path>(<line>):
     <func>"``) that enclose it in time are found;
  3. the innermost of them that lies in ``cognn_tpu_torch/`` names the
     source;
  4. a ``(file, function)`` rule, else a file rule, gives its bucket, else
     ``<other:file:func>``; a launch inside ``aten::randint`` /
     ``aten::random_`` is ``prng``.

The ring helpers (``core/ring.py``, ``core/shares.py``,
``core/fixedpoint.py``) are looked through: a launch whose innermost frame
is a helper takes the bucket of the function that called the helper where
that function has a ``(file, function)`` rule, and ``ring-helpers`` only
where it has none. The port's protocol computes through those helpers
(``reconstruct_ring`` is one ``ring_add``, ``reshare`` one
``share_split``), so without this every share op would land in
``ring-helpers`` and the ``scale``, ``reconstruct``, ``trunc-reshare`` and
``share-linear`` buckets would stay empty.

A device event with no launch in the trace goes to ``<other:unlinked>``,
never spread by time window; a launch with no device event (a record the
profiler lost) is counted in ``Breakdown.lost`` and reported. The JAX
tool's XPlane ``source`` metadata is the same innermost-user-frame
attribution, so the rules are its tables under the port's module names,
and the buckets map onto the reference's per-phase span tags
(``ss_vertex_centric_algo_kernel.h:745-897``):

    PreScatterComp       <- matmul + scale
    Scatter_Merge_Gather <- oga (the CSR SpMM, with the halo)
    Apply_computation    <- apply + nonlinear
    shared_share_arith   <- trunc-reshare, reconstruct, prng, ring-helpers,
                            share-linear

The parser takes the leaf category as an argument: ``kernel`` (and the
memcpy / memset events) on the card; on the CPU, ``cpu_op``, where each
operator that contains no other is its own launch, so the same
classification runs on a CPU trace.

``--graphed`` reads the same table from the engine as it runs on the card:
built with its CUDA graphs (eager on the CPU and on ``sparse``), with the
port's tracer on (:mod:`cognn_tpu_torch.utils.logging_utils`), whose device
phases carry the buckets' names at the functions the rules name. A
dispatch's metrics are fetched, then the tracer's ``collect`` reads the
phase table of its last epoch; the table is the sum over ``--reps``
dispatches of ``run_epochs_scan(--scan)`` after a warm one (the capture),
so ``--reps`` epochs. A phase's time is its exclusive time between the
timing events that each phase boundary records inside the graph (device
clock; the host clock on the CPU), and the time outside every phase is
``<other:unphased>``. Two rows differ from the eager table by design:
``gcn_metrics`` is its own ``metrics`` phase (nested in ``apply``), and
``add``, ``sub`` and ``mask_mul`` take their caller's phase (no
``share-linear`` or ``ring-helpers`` rows). The boundaries' events run
inside the graph, so a traced epoch is slower than an untraced one. No
profiler runs and nothing is written to ``--outdir``.

Usage:
  python -m cognn_tpu_torch.tools.profile_epoch [--dataset cora]
      [--parties 2] [--agg auto] [--variant opt] [--scan 64] [--reps 2]
      [--outdir DIR] [--dump] [--parse-only] [--breakdown-log PATH]
      [--device cuda] [--graphed]

--dump prints the first device events with their launch, frame and
bucket. --breakdown-log writes ``::<tag> took <s>`` per-epoch lines in the
driver log format, which ``tools/plot/plot_duration_breakdown_and_comm.py``
renders as the phase table (Tables 7-12 role).
"""

from __future__ import annotations

import argparse
import gzip
import json
import re
import sys
import tempfile
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

PACKAGE = "cognn_tpu_torch/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the host calls that put work on the device, each with a device record
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync")
PRNG_OPS = ("aten::randint", "aten::random_")
UNLINKED = "<other:unlinked>"
TRACE_GLOB = "*.trace.json*"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_engine(dataset, parties, agg, variant, device="cuda",
                 cuda_graphs=False):
    """The JAX tool's engine (``build_engine``, :45-68): synthetic Planetoid
    statistics, vertex v to party v mod P, lane 128, PubMed reordered;
    eager unless ``cuda_graphs`` (the engine's argument) says otherwise."""
    from cognn_tpu_torch.engine import build_device_plan
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid
    from cognn_tpu_torch.mpc import MpcGasEngine

    ds = synthetic_planetoid(dataset)
    n = len(ds.features)
    vids = np.arange(n)
    tid = {v: v % parties for v in range(n)}
    graphs = []
    for p in range(parties):
        g = build_party_graph(ds.src, ds.dst, None, tid, p, parties,
                              all_vids=vids)
        g.set_vertex_data(vids, ds.features, ds.labels)
        graphs.append(g)
    reorder = dataset == "pubmed"
    plan = build_device_plan(graphs, lane=128, reorder=reorder)
    eng = MpcGasEngine(plan, ds.param, variant, aggregation=agg,
                       device=device, cuda_graphs=cuda_graphs)
    return ds, eng


# buckets by the package file (relative to cognn_tpu_torch/) and function
# of the innermost package frame around a launch
_FILE_RULES = {
    "ops/spmm.py": "oga", "ops/bcsr.py": "oga", "ops/aggregate.py": "oga",
    "ops/intmatmul.py": "matmul",
    "ops/metrics.py": "apply",  # gcn_metrics' kernel or plain version
    "core/ring.py": "ring-helpers", "core/fixedpoint.py": "ring-helpers",
    "core/shares.py": "ring-helpers",
    "utils/glibc_rand.py": "other",
}
_FUNC_RULES = {  # (file, function) overrides
    ("mpc/engine.py", "_aggregate"): "oga",
    ("mpc/engine.py", "_scale_rows"): "scale",
    ("mpc/engine.py", "_predict_apply"): "apply",
    ("mpc/engine.py", "_weight_mean"): "apply",
    ("mpc/engine.py", "weight_total"): "apply",
    ("mpc/engine.py", "run_epochs_scan"): "scan-overhead",
    ("mpc/engine.py", "_epoch_step"): "apply",  # the weight write-back
    ("engine/gas.py", "_aggregate"): "oga",
    ("engine/gas.py", "halo"): "oga",
    ("engine/gas.py", "stack_epochs"): "scan-overhead",
    ("engine/gas.py", "_epoch_step"): "apply",
    ("mpc/protocol.py", "matmul"): "matmul",
    ("mpc/protocol.py", "matmul_prepped"): "matmul",
    ("mpc/protocol.py", "prep_matmul_a"): "matmul",
    ("mpc/protocol.py", "scale_rows"): "scale",
    ("mpc/protocol.py", "scale_const"): "apply",
    ("mpc/protocol.py", "sign_mask"): "nonlinear",
    ("mpc/protocol.py", "_sign_mask_bitdecomp"): "nonlinear",
    ("mpc/protocol.py", "mask_mul"): "nonlinear",
    ("mpc/protocol.py", "relu"): "nonlinear",
    ("mpc/protocol.py", "softmax_pred"): "apply",
    ("mpc/protocol.py", "reveal"): "apply",
    ("mpc/protocol.py", "share"): "apply",
    ("mpc/protocol.py", "reshare"): "trunc-reshare",
    ("mpc/protocol.py", "trunc"): "trunc-reshare",
    ("mpc/protocol.py", "_trunc_ring"): "trunc-reshare",
    ("mpc/protocol.py", "reconstruct_ring"): "reconstruct",
    ("mpc/protocol.py", "add"): "share-linear",
    ("mpc/protocol.py", "sub"): "share-linear",
}

# mapping onto the reference's per-phase span-tag table
# (`ss_vertex_centric_algo_kernel.h:745-897`), the JAX tool's: the OGA is
# one CSR SpMM launch with the halo; trunc/reshare, reconstruct, PRNG and
# the ring helpers are SHARED share-arithmetic that the reference buries
# inside each 2PC phase, reported as their own row.
REF_TAGS = {
    "PreScatterComp": ("matmul", "scale"),
    "Scatter_Merge_Gather": ("oga",),
    "Apply_computation": ("apply", "nonlinear"),
    "shared_share_arith": ("trunc-reshare", "reconstruct", "prng",
                           "ring-helpers", "share-linear"),
}

# --graphed: the tracer's own metrics phase is gcn_metrics, which the rules
# put in apply
GRAPHED_TAGS = {**REF_TAGS,
                "Apply_computation": REF_TAGS["Apply_computation"]
                + ("metrics",)}

_FRAME = re.compile(r"^(?P<path>.*)\((?P<line>\d+)\): (?P<func>.*)$")


def package_frame(name: str):
    """``(file, function)`` of a ``python_function`` event's name when the
    file lies in the package (file relative to ``cognn_tpu_torch/``), else
    None."""
    m = _FRAME.match(name)
    if m is None or PACKAGE not in m["path"]:
        return None
    return m["path"].rpartition(PACKAGE)[2], m["func"]


HELPER_FILES = {f for f, b in _FILE_RULES.items() if b == "ring-helpers"}


def classify(frame, ops=(), caller=None) -> str:
    """The bucket of a launch: ``frame`` is its innermost package frame
    ``(file, function)`` or None, ``ops`` the names of the operators that
    enclose it, outermost first, and ``caller`` the innermost enclosing
    package frame outside :data:`HELPER_FILES`."""
    if any(op in PRNG_OPS for op in ops):
        return "prng"
    if frame is None:
        return f"<other:{ops[-1] if ops else 'host'}>"
    if frame[0] in HELPER_FILES and caller in _FUNC_RULES:
        return _FUNC_RULES[caller]
    if frame in _FUNC_RULES:
        return _FUNC_RULES[frame]
    if frame[0] in _FILE_RULES:
        return _FILE_RULES[frame[0]]
    return f"<other:{Path(frame[0]).name}:{frame[1]}>"


def _innermost(spans, points, inherit=None):
    """For each time in ``points``, the payload of the innermost span of
    ``spans`` ``[(start, end, payload)]`` (properly nested, one thread)
    that contains it, or None. ``inherit(payload, parent)``, if given,
    makes each span's payload from its own and its enclosing span's."""
    out = [None] * len(points)
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack = []
    j = 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while j < len(spans) and spans[j][0] <= t:
            start, end, payload = spans[j]
            while stack and stack[-1][1] < start:
                stack.pop()
            if inherit is not None:
                payload = inherit(payload, stack[-1][2] if stack else None)
            stack.append((start, end, payload))
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def _op_chain(name, parent):
    return (parent or ()) + (name,)


def _with_caller(frame, parent):
    """(frame, innermost enclosing-or-own frame outside the helpers)."""
    if frame[0] not in HELPER_FILES:
        return frame, frame
    return frame, parent[1] if parent else None


def _leaves(ops):
    """The operators of one thread that contain no other."""
    ops = sorted(ops, key=lambda e: (e["ts"], -e["dur"]))
    leaves = []
    for k, e in enumerate(ops):
        nxt = ops[k + 1] if k + 1 < len(ops) else None
        if nxt is None or not (nxt["ts"] < e["ts"] + e["dur"]
                               or nxt["ts"] == e["ts"]):
            leaves.append(e)
    return leaves


@dataclass
class Breakdown:
    """A parsed trace: ``by_scope`` {bucket: ps}, ``total`` ps (their sum),
    ``kernels`` {(bucket, event name): count}, ``plane`` what ran, ``lost``
    the launches whose device record is not in the trace."""

    plane: str
    by_scope: dict
    total: int
    kernels: Counter = field(default_factory=Counter)
    lost: int = 0


def load_trace(path: Path) -> dict:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)


def latest_trace(outdir: Path) -> Path:
    traces = sorted(outdir.rglob(TRACE_GLOB), key=lambda p: p.stat().st_mtime)
    if not traces:
        raise SystemExit(f"no {TRACE_GLOB} under {outdir}")
    return traces[-1]


def parse_trace(trace: dict, leaf: str = "kernel", dump: bool = False,
                plane: str | None = None) -> Breakdown:
    """Attribute a Chrome trace's device time (``leaf="kernel"``: the
    kernel, memcpy and memset events) or its leaf operators
    (``leaf="cpu_op"``) to buckets, in picoseconds."""
    events = trace["traceEvents"]
    if leaf == "kernel":
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        launch_of = {e["args"]["correlation"]: e for e in events
                     if e.get("cat") in LAUNCH_CATS
                     and "correlation" in e.get("args", {})}
        launches = [launch_of.get(e.get("args", {}).get("correlation"))
                    for e in device]
        recorded = {e.get("args", {}).get("correlation") for e in device}
        lost = sum(1 for c, e in launch_of.items()
                   if e["name"] in LAUNCH_NAMES and c not in recorded)
    elif leaf == "cpu_op":
        by_thread = defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op" and e.get("ph") == "X":
                by_thread[e["pid"], e["tid"]].append(e)
        device = [x for ops in by_thread.values() for x in _leaves(ops)]
        launches = list(device)
        lost = 0
    else:
        raise ValueError(f"leaf {leaf!r} (kernel or cpu_op)")

    frames, ops = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "python_function":
            f = package_frame(e["name"])
            if f is not None:
                frames[e["pid"], e["tid"]].append(
                    (e["ts"], e["ts"] + e["dur"], f))
        elif e.get("cat") == "cpu_op":
            ops[e["pid"], e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                            e["name"]))
    # the launches of each thread, by the midpoint of each
    points = defaultdict(list)
    for k, la in enumerate(launches):
        if la is not None:
            points[la["pid"], la["tid"]].append(
                (k, la["ts"] + la.get("dur", 0) / 2))
    frame_of, ops_of = {}, {}
    for key, pts in points.items():
        ts = [t for _, t in pts]
        for (k, _), f, o in zip(pts,
                                _innermost(frames[key], ts, _with_caller),
                                _innermost(ops[key], ts, _op_chain)):
            frame_of[k], ops_of[k] = f or (None, None), o or ()

    by_scope = defaultdict(int)
    kernels = Counter()
    total = 0
    for k, e in enumerate(device):
        dur = round(e["dur"] * 1e6)  # us -> ps
        if launches[k] is None:
            bucket = UNLINKED
        else:
            bucket = classify(frame_of[k][0], ops_of[k], frame_of[k][1])
        by_scope[bucket] += dur
        total += dur
        kernels[bucket, e["name"]] += 1
        if dump and k < 30:
            la = launches[k]
            log(f"    ev {e['name'][:60]!r} launch="
                f"{la['name'] if la else None} frame={frame_of.get(k)} "
                f"ops={ops_of.get(k, ())[-2:]} -> {bucket} dur_ps={dur}")
    if plane is None:
        props = trace.get("deviceProperties") or []
        plane = (f"{props[0].get('name', 'cuda')} (cuda:0)"
                 if leaf == "kernel" and props else
                 "host (leaf cpu_op events)" if leaf == "cpu_op" else "cuda")
    if dump:
        log(f"plane {plane!r}: {len(device)} {leaf} events, total "
            f"{total/1e6:.1f} us, {sum(x is None for x in launches)} "
            f"without a launch, {lost} launches without a device record")
    return Breakdown(plane, dict(by_scope), total, kernels, lost)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    the device name where ``nvidia-smi`` cannot be run."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "-i", "0",
                            "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.profile_epoch",
        description="per-phase device time of the secret-shared epoch")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--agg", default="auto")
    ap.add_argument("--variant", default="opt")
    ap.add_argument("--scan", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--outdir", default=str(Path(tempfile.gettempdir())
                                            / "cognn_torch_trace"))
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--parse-only", action="store_true",
                    help="re-parse the newest trace in --outdir (no "
                         "device run; epochs = --reps * --scan)")
    ap.add_argument("--breakdown-log", default=None,
                    help="write ::<tag> took lines (driver log format)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the epochs run (the card by default)")
    ap.add_argument("--graphed", action="store_true",
                    help="the engine's graphs, phases from the port's "
                         "tracer (module docstring)")
    return ap


def trace_epochs(eng, scan: int, reps: int, path: Path, device,
                 on_start=None) -> float:
    """Trace ``reps`` calls of ``eng.run_epochs_scan(scan)`` (CPU and, on
    the card, CUDA activity; the Python tracer on), the last ending in a
    device synchronization, and export the Chrome trace to ``path``
    (gzipped for a ``.gz`` suffix). One more call runs first as the
    profiler's warm-up step, untraced: without it the card's activity
    records of the window's first launches can be missing. ``on_start``,
    if given, is called as the traced window begins. Returns the traced
    window's wall seconds, which the profiler inflates."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        eng.run_epochs_scan(scan)
        _sync(device)
        prof.step()
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.run_epochs_scan(scan)
        _sync(device)
        wall = time.perf_counter() - t0
        prof.step()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return wall


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def untraced_epoch_s(eng, scan: int, device) -> float:
    """Wall seconds an epoch of one ``run_epochs_scan(scan)`` ending in a
    device synchronization, without the profiler."""
    _sync(device)
    t0 = time.perf_counter()
    eng.run_epochs_scan(scan)
    _sync(device)
    return (time.perf_counter() - t0) / scan


def graphed_phases(eng, scan: int, reps: int) -> dict:
    """{bucket: ps} over ``reps`` epochs: the last epoch of each of
    ``reps`` dispatches of ``run_epochs_scan(scan)``, its metrics fetched,
    after a warm one, read from the tracer's phase tables."""
    from cognn_tpu_torch.utils.logging_utils import (UNPHASED, collect,
                                                     reset, tracing)

    by_scope = defaultdict(int)
    with tracing():
        reset()
        eng.metrics_host(eng.run_epochs_scan(scan))  # the capture
        collect()
        for _ in range(reps):
            eng.metrics_host(eng.run_epochs_scan(scan))
            for unit in collect():
                for name, ns in unit["ns"].items():
                    key = "<other:unphased>" if name == UNPHASED else name
                    by_scope[key] += 1000 * ns
        reset()
    return dict(by_scope)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    leaf = "kernel" if args.device == "cuda" else "cpu_op"
    n_epochs = args.reps * args.scan
    outdir = Path(args.outdir)
    if args.parse_only:
        result = parse_trace(load_trace(latest_trace(outdir)), leaf,
                             args.dump)
        report(result.plane, result.by_scope, result.total, n_epochs,
               args.breakdown_log)
        return 0

    from cognn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # no card: raise before any work
    if args.graphed:
        ds, eng = build_engine(args.dataset, args.parties, args.agg,
                               args.variant, device, cuda_graphs=None)
        how = "graphed" if eng._graphs.enabled else "eager"
        log(f"device={device} {args.dataset} P={args.parties} "
            f"agg={eng.aggregation} variant={args.variant} {how}, the "
            "port's tracer on")
        by_scope = graphed_phases(eng, args.scan, args.reps)
        plane = (f"{card_line()} (cuda:0), {how}, phase events"
                 if device.type == "cuda" else
                 "host (phase boundaries on the host clock)")
        report(plane, by_scope, sum(by_scope.values()), args.reps,
               args.breakdown_log, GRAPHED_TAGS)
        return 0
    ds, eng = build_engine(args.dataset, args.parties, args.agg,
                           args.variant, device)
    log(f"device={device} {args.dataset} P={args.parties} "
        f"agg={eng.aggregation} variant={args.variant} eager "
        "(cuda_graphs=False: a graph replay carries no Python frames)")
    t0 = time.perf_counter()
    eng.run_epochs_scan(args.scan)
    _sync(device)
    log(f"first scan({args.scan}): {time.perf_counter()-t0:.2f}s")
    log(f"untraced scan({args.scan}): "
        f"{untraced_epoch_s(eng, args.scan, device)*1e6:.1f} us/epoch wall")
    path = outdir / (f"{args.dataset}_{args.parties}p_{args.variant}"
                     ".trace.json.gz")
    wall = trace_epochs(eng, args.scan, args.reps, path, device)
    log(f"traced {n_epochs} epochs in {wall:.2f}s wall "
        f"({wall/n_epochs*1e6:.1f} us/epoch incl. host and the profiler)")
    plane = f"{card_line()} (cuda:0)" if device.type == "cuda" else None
    result = parse_trace(load_trace(path), leaf, args.dump, plane)
    if result.lost:
        log(f"WARNING: {result.lost} launches in the trace have no device "
            "record (lost by the profiler): the device total is short")
    report(result.plane, result.by_scope, result.total, n_epochs,
           args.breakdown_log)
    return 0


def report(plane, by_scope, total, n_epochs, breakdown_log,
           tags=REF_TAGS):
    print(f"# trace plane: {plane}")
    print(f"# {n_epochs} epochs; device total "
          f"{total/1e12/n_epochs*1e6:.1f} us/epoch")
    width = max(len(k) for k in by_scope)
    print(f"{'scope':<{width}}  us/epoch  share")
    for k, v in sorted(by_scope.items(), key=lambda kv: -kv[1]):
        print(f"{k:<{width}}  {v/1e12/n_epochs*1e6:8.2f}  "
              f"{v/total*100:5.1f}%")
    print()
    print("reference-tag mapping (ss_…h:745-897):")
    for tag, scopes in tags.items():
        ps = sum(by_scope.get(s, 0) for s in scopes)
        print(f"  ::{tag} took {ps/1e12/n_epochs:.6f}")
    if breakdown_log:
        with open(breakdown_log, "w") as f:
            for tag, scopes in tags.items():
                ps = sum(by_scope.get(s, 0) for s in scopes)
                f.write(f"::{tag} took {ps/1e12/n_epochs:.6f}\n")
            other = sum(v for k, v in by_scope.items()
                        if k.startswith("<other"))
            f.write(f"::other_device took {other/1e12/n_epochs:.6f}\n")
        log(f"wrote {breakdown_log}")


if __name__ == "__main__":
    sys.exit(main())
