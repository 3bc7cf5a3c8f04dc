"""Experiment driver: the paper's evaluation matrix on the port (port of the
repo's ``tools/run_cluster.py``; reference `tools/tmp_run_cluster.py`).

Runs each evaluation on one device (the card by default, ``--device cpu``
on a host without one), parties stacked, and writes per-party logs in the
reference's naming scheme ``<log-root>/<setting>/gcn_test_<dataset>_<p>.log``
with the same grep-able lines (``tid-> p, iteration-> N``, ``::iteration
took``, the accuracy block), so the plot suite (``tools/plot/``) and
:mod:`cognn_tpu_torch.tools.summarize_matrix` read either package's output.
The settings' names are the JAX driver's, so rows line up with
``results/matrix/SUMMARY.md``.

Where the reference measures per-NIC bytes with psutil over its TCP mesh and
the JAX driver traces its sharded program's jaxpr, this driver COUNTS the
sharded deployment's collective bytes: one epoch (a forward for the
inference settings) of the sharded engines in P party processes over gloo
on the CPU, :func:`cognn_tpu_torch.engine.comm_model.engine_epoch_comm` at
each :class:`~cognn_tpu_torch.utils.distributed.PartyGroup` collective (the
bytes do not depend on the device). The counts go into
``<comm-root>/<setting>/<dataset>_<p>.comm`` with ``"measured": true``,
beside the closed-form ``analytic_per_epoch_bytes``; only where counting
cannot run (one party, or the party processes fail) is the analytic count
written, with ``"measured": false``. The driver prints which.

Evaluations (reference `tmp_run_cluster.py:263-448`):
  --smallest-cognn-efficiency   2-party run, 2 epochs (the ~1 min check)
  --cognn-opt-accuracy          90-epoch training, parties 2..5
  --cognn-unopt-accuracy        same with the unopt (2L) schedule
  --cognn-opt-efficiency        scaler subsets 2s..5s, 1 epoch timing
  --cognn-unopt-efficiency      the same with the unopt schedule
  --cognn-opt-inference         forward only
  --cognn-unopt-inference       the unopt forward
  --fedgnn                      FedAvg baseline (cross-party edges removed)
  --graphsc                     GraphSC's analytic comm row (no logs)
  --plaintext                   single-party global-graph baseline
  --all                         every one of them
Options: --mpc (secret-shared execution), --dataset, --epochs, --parties,
--aggregation, --reorder, --planetoid-root, --device, --log-root,
--comm-root.

  python -m cognn_tpu_torch.tools.run_cluster --smallest-cognn-efficiency
  python -m cognn_tpu_torch.tools.run_cluster --all --dataset citeseer
  python -m cognn_tpu_torch.tools.run_cluster --cognn-opt-accuracy --mpc \\
      --dataset pubmed --parties 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cognn_tpu_torch.config import GNNParam
from cognn_tpu_torch.engine import GasEngine, build_device_plan
from cognn_tpu_torch.engine.comm_model import (analytic_bytes_per_epoch,
                                               analytic_rounds_per_epoch,
                                               engine_epoch_comm)
from cognn_tpu_torch.engine.gas import forward_widths, select_backend
from cognn_tpu_torch.graph import build_party_graph
from cognn_tpu_torch.harness.datasets import (Dataset, scaler_subset,
                                              strip_cross_edges,
                                              synthetic_planetoid)
from cognn_tpu_torch.mpc import MpcGasEngine
from cognn_tpu_torch.utils import distributed
from cognn_tpu_torch.utils.device import resolve_device

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
TIME_BUDGET_S = 0.5  # minimum timed window (repeats of the whole run)
MAX_TIMING_REPS = 4096
COUNT_TIMEOUT_S = 900  # the counting party processes, start to end


def default_partition(n: int, n_parties: int):
    """{vid: party}, vertex v to party v mod P (None for one party)."""
    return {v: v % n_parties for v in range(n)} if n_parties > 1 else None


def build_graphs(ds: Dataset, n_parties: int, tid=None):
    """The parties' graphs of ``ds`` under the partition ``tid`` ({vid:
    party}; :func:`default_partition` where None)."""
    n = len(ds.features)
    vids = np.arange(n)
    if tid is None:
        tid = default_partition(n, n_parties)
    graphs = []
    for p in range(n_parties):
        g = build_party_graph(ds.src, ds.dst, None, tid, p, n_parties,
                              all_vids=vids)
        g.set_vertex_data(vids, ds.features, ds.labels)
        graphs.append(g)
    return graphs


def make_engine(plan, param, variant, mpc, aggregation, device, **kw):
    if mpc:
        return MpcGasEngine(plan, param, variant, aggregation=aggregation,
                            device=device, **kw)
    return GasEngine(plan, param, variant, aggregation=aggregation,
                     device=device, **kw)


def sharded_backend(plan, param, variant: str, mpc: bool, aggregation: str,
                    device, hoist_agg: bool = True) -> str:
    """The backend the SHARDED deployment of this run takes: an explicit
    choice passes through, ``auto`` resolves by the engines' own rule with
    ``sharded=True`` on ``device`` (the card's rule there; the CSR kernel
    on the CPU), as a party process of that deployment would.
    ``hoist_agg``: the secret-shared engines' (unopt only)."""
    if aggregation != "auto":
        return aggregation
    hoisted = mpc and hoist_agg and variant.startswith("unopt")
    return select_backend(plan, device,
                          forward_widths(param, variant, hoisted),
                          ring=64 if mpc else False, sharded=True)


def _count_party(data_file: str, rank: int, world: int, port: int,
                 out_file: str) -> None:
    """``--_count-party`` entry: one party process of the counted epoch or
    forward, on the CPU over gloo; writes its counts as JSON."""
    torch.set_num_threads(1)
    with np.load(data_file) as f:
        data = {k: f[k] for k in f.files}
    cfg = json.loads(str(data["cfg"]))
    param = GNNParam(**json.loads(str(data["param"])))
    ds = Dataset(name=cfg["name"], src=data["src"], dst=data["dst"],
                 features=data["features"], labels=data["labels"],
                 param=param)
    tid = {v: int(t) for v, t in enumerate(data["tid"])}
    plan = build_device_plan(build_graphs(ds, world, tid=tid),
                             reorder=cfg["reorder"])
    group = distributed.init_party_group(rank, world, f"127.0.0.1:{port}",
                                         backend="gloo", device="cpu")
    kw = {"hoist_agg": cfg["hoist_agg"]} if cfg["mpc"] else {}
    try:
        engine = make_engine(plan, param, cfg["variant"], cfg["mpc"],
                             cfg["backend"], "cpu", mode="sharded",
                             group=group, **kw)
        kind = "forward" if cfg["variant"].endswith("inference") else "epoch"
        Path(out_file).write_text(json.dumps(engine_epoch_comm(engine,
                                                               kind)))
    finally:
        distributed.destroy_party_group()


def count_comm(ds: Dataset, tid, n_parties: int, variant: str, mpc: bool,
               backend: str, reorder: bool, hoist_agg: bool = True) -> dict:
    """Party 0's counted bytes and rounds of one epoch (or forward) of the
    sharded engines on ``backend``, ``{"bytes": {...}, "rounds": {...}}``:
    ``n_parties`` party processes on the CPU over gloo, each building the
    whole plan from ``ds``'s edges and the partition ``tid`` ({vid:
    party}); ``hoist_agg`` as the secret-shared engines take it. Raises if
    a party fails or the parties' counts differ."""
    tid_of = np.array([tid[v] for v in range(len(ds.features))], np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data_file = tmp / "data.npz"
        np.savez(data_file, src=ds.src, dst=ds.dst, features=ds.features,
                 labels=ds.labels, tid=tid_of,
                 param=json.dumps(dataclasses.asdict(ds.param),
                                  default=lambda x: x.item()),
                 cfg=json.dumps({"name": ds.name, "variant": variant,
                                 "mpc": mpc, "backend": backend,
                                 "reorder": reorder,
                                 "hoist_agg": hoist_agg}))
        port = distributed.free_port()
        outs = [tmp / f"party{r}.json" for r in range(n_parties)]
        logs = [open(tmp / f"party{r}.log", "w") for r in range(n_parties)]
        path = (str(PACKAGE_ROOT), os.environ.get("PYTHONPATH", ""))
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(p for p in path if p)}
        try:
            distributed.run_parties(
                [[sys.executable, "-m", "cognn_tpu_torch.tools.run_cluster",
                  "--_count-party", str(data_file), str(r), str(n_parties),
                  str(port), str(outs[r])] for r in range(n_parties)],
                timeout=COUNT_TIMEOUT_S, stdouts=logs, stderrs=logs, env=env)
        except (RuntimeError, TimeoutError) as e:
            tail = "\n".join((tmp / f"party{r}.log").read_text()[-1500:]
                             for r in range(n_parties))
            raise RuntimeError(f"{e}\n{tail}") from e
        finally:
            for f in logs:
                f.close()
        counts = [json.loads(o.read_text()) for o in outs]
    if any(c != counts[0] for c in counts[1:]):
        raise RuntimeError(f"the parties counted differently: {counts}")
    return counts[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_window(fn, device, time_budget: float):
    """(seconds, reps): ``fn`` repeated until one window of ``reps`` calls,
    ending in a device synchronization, lasts at least ``time_budget``
    seconds (or reaches MAX_TIMING_REPS)."""
    reps = 1
    while True:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(device)
        dt = time.perf_counter() - t0
        if dt >= time_budget or reps >= MAX_TIMING_REPS:
            return dt, reps
        reps = min(MAX_TIMING_REPS,
                   max(reps * 2, int(reps * 1.2 * time_budget
                                     / max(dt, 1e-6))))


def run_training(ds: Dataset, n_parties: int, epochs: int, variant: str,
                 mpc: bool, setting: str, fedgnn: bool = False,
                 log_root=Path("log"), comm_root=Path("comm"),
                 aggregation: str = "auto", reorder: bool = False,
                 time_budget: float = TIME_BUDGET_S, tid_map=None,
                 device="cuda"):
    """One evaluation run: the ``epochs``-epoch trajectory through
    ``run_epochs_scan`` (or one forward for an ``*_inference`` variant),
    timed windows of the same call, reference-format per-party logs and
    the ``.comm`` payload. Returns the engine.

    Timing: after the logged run, the whole run is repeated until one
    window, ending in ``torch.cuda.synchronize()``, lasts ``time_budget``
    seconds; an epoch's duration is window / (reps * epochs) and each
    schedule iteration's span a share of it. The logged metrics come from
    the first run; the repeats only advance the weights. The counting
    party processes run on the CPU while the engine is built and the
    logged run trains, and are awaited before the timed window."""
    device = resolve_device(device)
    tid = (default_partition(len(ds.features), n_parties) if tid_map is None
           else tid_map)
    if fedgnn and tid:  # FedGNN's local graphs: the edges inside a party
        ds = dataclasses.replace(ds, **dict(zip(
            ("src", "dst"), strip_cross_edges(ds.src, ds.dst, tid))))
    graphs = build_graphs(ds, n_parties, tid=tid)
    plan = build_device_plan(graphs, reorder=reorder)
    backend = sharded_backend(plan, ds.param, variant, mpc, aggregation,
                              device)
    with ThreadPoolExecutor(1) as pool:
        counted = (pool.submit(count_comm, ds, tid, n_parties, variant, mpc,
                               backend, reorder)
                   if n_parties > 1 else None)
        engine = make_engine(plan, ds.param, variant, mpc, aggregation,
                             device)
        inference = variant.endswith("inference")
        if inference:
            run = engine.forward
            metrics = run()[2]
        else:
            def run():
                return engine.run_epochs_scan(epochs)
            metrics = run()
        m = engine.metrics_host(metrics)
        try:
            comm = counted.result() if counted is not None else None
            why = "one party" if counted is None else ""
        except Exception as e:  # noqa: BLE001 (reported, written unmeasured)
            traceback.print_exc()
            comm, why = None, f"{type(e).__name__}: {e}"
    dt, reps = _timed_window(run, device, time_budget)

    logdir = Path(log_root) / setting
    logdir.mkdir(parents=True, exist_ok=True)
    name = ds.name.lower()
    logs = [open(logdir / f"gcn_test_{name}_{p}.log", "w")
            for p in range(n_parties)]

    def emit(p, line):
        logs[p].write(line + "\n")

    if inference:
        per_fwd = dt / reps
        for p in range(n_parties):
            for _ in range(engine.L):  # one span a schedule iteration
                emit(p, f"::iteration took {per_fwd / engine.L:.6f}")
            _emit_metrics(emit, p, m, graphs[p])
    else:
        per_epoch = dt / (reps * epochs)
        el = engine.epoch_layers
        for e in range(epochs):
            me = {k: v[:, e] for k, v in m.items()}
            for p in range(n_parties):
                emit(p, f"tid-> {p}, iteration-> {(e + 1) * el}")
                for _ in range(el):
                    emit(p, f"::iteration took {per_epoch / el:.6f}")
                _emit_metrics(emit, p, me, graphs[p])
    for f in logs:
        f.close()

    analytic = analytic_bytes_per_epoch(plan, ds.param, variant, mpc=mpc,
                                        aggregation=backend)
    rounds = analytic_rounds_per_epoch(ds.param, variant, mpc=mpc)
    n_ep = 1 if inference else max(epochs, 1)
    per_epoch_b = (comm["bytes"] if comm else analytic)["total"]
    total_mb = per_epoch_b * n_ep / 1e6
    payload = {"sent_MB": total_mb, "recv_MB": total_mb,
               "measured": comm is not None,
               # what the numbers DESCRIBE: a party's collective wire bytes
               # in the sharded deployment of this run on ``backend``; the
               # run itself was stacked on one device (run_backend)
               "backend": backend,
               "mode": "sharded",
               "run_backend": engine.aggregation,
               "run_mode": engine.mode,
               "per_epoch_bytes": comm["bytes"] if comm else analytic,
               "per_epoch_rounds": comm["rounds"] if comm else rounds,
               "analytic_per_epoch_bytes": analytic,
               "analytic_per_epoch_rounds": rounds}
    commdir = Path(comm_root) / setting
    commdir.mkdir(parents=True, exist_ok=True)
    for p in range(n_parties):
        (commdir / f"{name}_{p}.comm").write_text(json.dumps(payload) + "\n")
    how = ("counted in gloo party processes" if comm else
           f"analytic ({why})")
    unit = "a forward" if inference else "an epoch"
    test_acc = m["test_acc"] if inference else m["test_acc"][:, -1]
    print(f"{setting} {name}: {n_parties} parties, backend "
          f"{engine.aggregation}, sharded {backend}; "
          f"{dt / reps / (1 if inference else epochs) * 1e3:.4f} ms {unit} "
          f"over {reps} reps; test acc {float(test_acc.mean()):.6f}; comm "
          f"{how}: {per_epoch_b:.0f} B {unit} a party", flush=True)
    return engine


def _emit_metrics(emit, p, m, graph):
    emit(p, "--------")
    emit(p, f"cross-entropy-loss = {m['loss'][p]:.6f}")
    emit(p, f"full set accuracy = {m['full_acc'][p]:.6f}")
    emit(p, f"training set accuracy = {m['train_acc'][p]:.6f}")
    emit(p, f"border training set accuracy = {m['border_train_acc'][p]:.6f}")
    emit(p, f"test set accuracy = {m['test_acc'][p]:.6f}")
    emit(p, f"border test set accuracy = {m['border_test_acc'][p]:.6f}")
    emit(p, f"the number of vertices is {graph.num_local}, the number of "
            f"border vertices is {int(m['num_border'][p])}")


def graphsc_rows(ds: Dataset, parties, comm_root=Path("comm")) -> None:
    """The GraphSC baseline's analytic comm rows (reference
    `tmp_run_cluster.py:153-199`): GraphSC itself is a third-party system
    living only in the paper's Docker image, so each scaler subset ``ks``
    gets its per-epoch comm model (paper Table 6, 8·sum_dims·10·(n+m)),
    marked model-derived; no log, no duration."""
    p = ds.param
    sum_dims = p.input_dim + 2 * p.hidden_dim  # unopt-space dims
    for k in parties:
        sub, _ = scaler_subset(ds, k)
        keep_n, m_k = len(sub.features), len(sub.src)
        per_epoch = 8 * sum_dims * 10 * (keep_n + m_k)
        commdir = Path(comm_root) / f"graphsc_{k}s"
        commdir.mkdir(parents=True, exist_ok=True)
        payload = {"sent_MB": per_epoch / 1e6, "recv_MB": per_epoch / 1e6,
                   "measured": False, "model": "graphsc-analytic",
                   "n": keep_n, "m": m_k, "sum_dims": sum_dims}
        for q in range(k):
            (commdir / f"{ds.name.lower()}_{q}.comm").write_text(
                json.dumps(payload) + "\n")
        print(f"graphsc model {k}s: n={keep_n} m={m_k} "
              f"{per_epoch / 1e9:.3f} GB/epoch (analytic)", flush=True)


EVALUATIONS = ("smallest_cognn_efficiency", "cognn_opt_accuracy",
               "cognn_unopt_accuracy", "cognn_opt_efficiency",
               "cognn_unopt_efficiency", "cognn_opt_inference",
               "cognn_unopt_inference", "fedgnn", "graphsc", "plaintext")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.run_cluster",
        description="the paper's evaluation matrix on the port")
    ap.add_argument("--_count-party", dest="count_party", nargs=5,
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--smallest-cognn-efficiency", action="store_true")
    ap.add_argument("--cognn-opt-accuracy", action="store_true")
    ap.add_argument("--cognn-unopt-accuracy", action="store_true")
    ap.add_argument("--cognn-opt-efficiency", action="store_true")
    ap.add_argument("--cognn-opt-inference", action="store_true")
    ap.add_argument("--cognn-unopt-inference", action="store_true",
                    help="original-gcn forward run with maxIters=2 "
                         "(reference tmp_run_cluster.py:417-435)")
    ap.add_argument("--cognn-unopt-efficiency", action="store_true",
                    help="scaler subsets with the unopt (2L) schedule")
    ap.add_argument("--fedgnn", action="store_true")
    ap.add_argument("--graphsc", action="store_true",
                    help="emit the GraphSC baseline's analytic comm rows "
                         "(see graphsc_rows)")
    ap.add_argument("--plaintext", action="store_true")
    ap.add_argument("--all", dest="run_all", action="store_true",
                    help="run every evaluation (reference --all)")
    ap.add_argument("--mpc", action="store_true",
                    help="secret-shared execution for the cognn evals")
    ap.add_argument("--dataset", default="cora",
                    choices=["cora", "citeseer", "pubmed", "cora_small"])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--parties", type=int, nargs="+", default=None)
    ap.add_argument("--aggregation", default="auto",
                    choices=["auto", "sparse", "dense", "bcsr"],
                    help="aggregation backend of the runs and of the "
                         "counted sharded deployment (auto: the engines' "
                         "rule, fitted to the card)")
    ap.add_argument("--reorder", action="store_true",
                    help="BFS-reorder local vertices (bcsr block locality)")
    ap.add_argument("--planetoid-root", default=None, metavar="DIR",
                    help="directory with real Planetoid raw files "
                         "(ind.<dataset>.*); else the synthetic "
                         "statistics-matched generator")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the runs execute (the card by default)")
    ap.add_argument("--log-root", default="log")
    ap.add_argument("--comm-root", default="comm")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.count_party:
        data, rank, world, port, out = args.count_party
        _count_party(data, int(rank), int(world), int(port), out)
        return 0
    if args.run_all:
        for f in EVALUATIONS:
            setattr(args, f, True)
    resolve_device(args.device)  # no card: raise before any work

    if args.planetoid_root:
        from cognn_tpu_torch.harness.datasets import load_planetoid_raw

        ds = load_planetoid_raw(args.planetoid_root, args.dataset)
        print(f"loaded real {args.dataset}: n={len(ds.features)} "
              f"m={len(ds.src)} f={ds.param.input_dim}")
    else:
        ds = synthetic_planetoid(args.dataset)

    def run(n_parties, epochs, variant, mpc, setting, data=None, **kw):
        return run_training(ds if data is None else data,
                            n_parties, epochs, variant, mpc, setting,
                            log_root=Path(args.log_root),
                            comm_root=Path(args.comm_root),
                            aggregation=args.aggregation,
                            reorder=args.reorder, device=args.device, **kw)

    # mpc evals write under their own setting roots, like the reference's
    # per-eval root paths (`tmp_run_cluster.py set_root_paths`)
    tag = "mpc_" if args.mpc else ""
    parties = args.parties or [2, 3, 4, 5]
    if args.smallest_cognn_efficiency:
        t0 = time.perf_counter()
        run(2, args.epochs or 2, "opt", args.mpc, tag + "smallest_efficiency")
        print(f"smallest test took {time.perf_counter() - t0:.1f}s "
              f"(reference: ~1 min)", flush=True)
    for flag, variant in (("cognn_opt_accuracy", "opt"),
                          ("cognn_unopt_accuracy", "unopt")):
        if getattr(args, flag):
            for p in parties:
                run(p, args.epochs or 90, variant, args.mpc,
                    f"{tag}{variant}_accuracy_{p}p")
    for flag, variant in (("cognn_opt_efficiency", "opt"),
                          ("cognn_unopt_efficiency", "unopt")):
        if getattr(args, flag):
            for k in parties:
                # scaler subset ks (the computation transform_by_parts
                # writes to files: same shuffle, blocks and party labels)
                sub, tid = scaler_subset(ds, k)
                t0 = time.perf_counter()
                run(k, args.epochs or 1, variant, args.mpc,
                    f"{tag}{variant}_efficiency_{k}s", data=sub, tid_map=tid)
                print(f"{variant} efficiency {k}s ({len(sub.features)} "
                      f"vertices, {k} parties): "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
    for flag, variant in (("cognn_opt_inference", "opt_inference"),
                          ("cognn_unopt_inference", "unopt_inference")):
        if getattr(args, flag):
            run(2, 1, variant, args.mpc, tag + variant)
    if args.fedgnn:
        # one run per party count, like the reference's fed-gcn sweep
        # (`tmp_run_cluster.py:309-331`); always plaintext
        for p in parties:
            run(p, args.epochs or 90, "opt", False, f"fedgnn_{p}p",
                fedgnn=True)
    if args.graphsc:
        graphsc_rows(ds, parties, Path(args.comm_root))
    if args.plaintext:
        run(1, args.epochs or 90, "opt", False, "plaintext")
    return 0


if __name__ == "__main__":
    sys.exit(main())
