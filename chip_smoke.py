"""Smoke run of the PyTorch/CUDA port (``cognn_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel from ``cognn_tpu_torch/csrc`` and prints the time.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the inference path gives it (the flat CSR of synthetic Cora with 2
   parties and PubMed with 4, at the hidden and the label width), and times
   kernel, plain version and one library call computing the same function
   (``torch.sparse.mm``, a yardstick the port never calls). A second edge
   list of the same size, with part of the edges repeated, checks the
   kernel's edge counts (above 1 there) and its empty rows.
4. Drives the port's main path, CoGNN-Opt full-graph inference
   (``GasEngine(..., "opt_inference").forward()``, parties stacked on the
   card), at the full width of the models the repo ships: GCN 1433->16->7 on
   Cora 2p and GCN 500->16->3 on PubMed 4p, three requests each, with random
   Glorot weights from a seed. It checks that every forward launched the
   kernel once per layer, that the logits match the plain-torch ``sparse``
   backend on the card, and that the metrics are finite; then profiles one
   more request (device time by kernel against wall time).

The line before the last is one JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is not 0; without a card the script exits 1 before printing a
result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order
# kernel vs plain sparse backend through two layers, as a share of the
# largest reference logit (PubMed's logits are near uniform and small)
LOGITS_TOL_OF_MAX = 1e-4
FORWARDS = 3  # requests per model
TIMED_CALLS = 100  # calls per timing window

# (cell, dataset, parties, TPU kernel that JAX aggregation="bcsr" runs
# there, which of the JAX package's backends its TPU "auto" policy picks).
# bcsr takes the one-block K2 below 1024 blocks and the supertiled K1 at or
# above; "auto" picks the dense matmul while (P*V)^2 <= 2^28
# (cognn_tpu/engine/gas.py:213), so on Cora 2p it runs no Pallas kernel,
# while the port's "auto" always takes the SpMM.
CELLS = (
    ("cora_2p", "cora", 2, "cognn_tpu/ops/pallas_spmm.py:27",
     "K2 under aggregation='bcsr'; JAX auto picks dense here"),
    ("pubmed_4p", "pubmed", 4, "cognn_tpu/ops/pallas_spmm.py:149",
     "K1 under aggregation='bcsr', which JAX auto picks here"),
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def device_ms(fn, calls: int = TIMED_CALLS) -> float:
    """Device time of one ``fn()``: CUDA events around ``calls`` back-to-back
    calls, queued behind a sleep kernel so host launch overhead leaves no
    gaps on the device. Inputs stay L2-resident (warm), as in the forward."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms: time to queue the calls
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def make_plan(dataset: str, parties: int):
    from cognn_tpu_torch.engine import build_device_plan
    from cognn_tpu_torch.graph import build_party_graph
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid

    ds = synthetic_planetoid(dataset)
    vids = np.arange(len(ds.features))
    tid = {v: v % parties for v in range(len(vids))}
    graphs = []
    for p in range(parties):
        g = build_party_graph(ds.src, ds.dst, None, tid, p, parties,
                              all_vids=vids)
        g.set_vertex_data(vids, ds.features, ds.labels)
        graphs.append(g)
    return build_device_plan(graphs), ds.param


def with_repeats(spmm):
    """An Spmm at ``spmm``'s shape over its edges with the first quarter
    appended twice more: those entries get counts of 3 (the synthetic
    graphs have no repeated edge), and the padding rows stay empty."""
    from cognn_tpu_torch.ops.spmm import Spmm

    indptr = spmm.indptr.cpu().numpy()
    src = np.repeat(spmm.indices.cpu().numpy(),
                    spmm.counts.cpu().numpy().astype(np.int64))
    dst = np.repeat(np.arange(spmm.n_dst), np.diff(indptr))
    k = len(src) // 4
    src = np.concatenate([src, src[:k], src[:k]])
    dst = np.concatenate([dst, dst[:k], dst[:k]])
    dup = Spmm(src, dst, spmm.n_src, spmm.n_dst, spmm.indptr.device)
    if not (dup.counts.max().item() > 1
            and (dup.indptr.diff() == 0).any().item()):
        raise AssertionError("repeated-edge check has no count above 1 "
                             "or no empty row")
    return dup


def kernel_phase(cell: str, spmm, widths) -> dict:
    """Kernel vs plain version (and the library yardstick) at each width;
    returns the per-forward sums of times and bounds. Also holds the kernel
    against its plain version on :func:`with_repeats`' edges."""
    from cognn_tpu_torch.ops.spmm import spmm_plain

    rng = np.random.default_rng(0)
    dup = with_repeats(spmm)
    a_csr = torch.sparse_csr_tensor(
        spmm.indptr.long(), spmm.indices.long(), spmm.counts,
        size=(spmm.n_dst, spmm.n_src), check_invariants=True)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0)
    bound_by = set()
    for D in widths:
        h = torch.from_numpy(
            rng.standard_normal((spmm.n_src, D), dtype=np.float32)).cuda()
        got = spmm(h)
        want = spmm_plain(spmm.indptr, spmm.indices, spmm.counts, h)
        lib = torch.sparse.mm(a_csr, h)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        torch.testing.assert_close(lib, want, **KERNEL_TOL)
        err = (got - want).abs().max().item()
        got_dup = dup(h)
        want_dup = spmm_plain(dup.indptr, dup.indices, dup.counts, h)
        torch.testing.assert_close(got_dup, want_dup, **KERNEL_TOL)
        err_dup = (got_dup - want_dup).abs().max().item()
        print(f"kernel {cell} D={D} repeated edges: nnz={dup.nnz} "
              f"max count={dup.counts.max().item()!r} "
              f"empty rows={(dup.indptr.diff() == 0).sum().item()} "
              f"max_abs_err={err_dup!r}", flush=True)
        ms = device_ms(lambda: spmm(h))
        plain_ms = device_ms(lambda: spmm_plain(spmm.indptr, spmm.indices,
                                                spmm.counts, h))
        library_ms = device_ms(lambda: torch.sparse.mm(a_csr, h))
        nbytes = 4 * ((spmm.n_dst + 1) + 2 * spmm.nnz
                      + (spmm.n_src + spmm.n_dst) * D)
        flops = 2 * spmm.nnz * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_by.add("bytes" if t_bytes >= t_ops else "operations")
        print(f"kernel {cell} D={D}: n={spmm.n_dst} nnz={spmm.nnz} "
              f"max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r} "
              f"library_ms={library_ms!r} bound_ms={max(t_bytes, t_ops)!r} "
              f"({nbytes} bytes, {flops} flops)", flush=True)
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["library_ms"] += library_ms
        tot["bound_ms"] += max(t_bytes, t_ops)
        tot["max_abs_err"] = max(tot["max_abs_err"], err, err_dup)
    tot["bound_by"] = "bytes" if bound_by == {"bytes"} else "operations"
    return tot


def forward_phase(cell: str, engine, reference) -> int:
    """The main path: FORWARDS inference requests. Returns the kernel
    launches they made."""
    engine.spmm.launches = 0
    times = []
    for _ in range(FORWARDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, prob, metrics = engine.forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = engine.spmm.launches

    P, V, C = engine.P, engine.plan.V, engine.param.num_labels
    if tuple(z.shape) != (P, V, C):
        raise AssertionError(f"{cell}: logits shape {tuple(z.shape)}")
    if launches != FORWARDS * engine.L:
        raise AssertionError(f"{cell}: {launches} kernel launches in "
                             f"{FORWARDS} forwards of {engine.L} layers")
    z_ref = reference.forward()[0]
    atol = LOGITS_TOL_OF_MAX * z_ref.abs().max().item()
    torch.testing.assert_close(z, z_ref, rtol=0, atol=atol)
    m = engine.metrics_host(metrics)
    for k, v in m.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{cell}: metric {k} not finite: {v}")
    print(f"forward {cell}: ms per request {times!r} launches={launches} "
          f"max|z - z_sparse|={(z - z_ref).abs().max().item()!r} "
          f"(atol {atol!r}) "
          f"loss={m['loss'].tolist()} test_acc={m['test_acc'].tolist()} "
          f"full_acc={m['full_acc'].tolist()}", flush=True)
    return launches


def profile_phase(cell: str, engine) -> None:
    """Where one request's time goes: the device time of every kernel and
    copy (torch.profiler, CUPTI) against the request's wall time, which the
    profiler itself inflates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"profile {cell}: wall_ms={wall_ms!r} device_busy_ms={busy_ms!r} "
          f"device_ops={sum(n for n, _ in by_name.values())} "
          f"idle_share={1 - busy_ms / wall_ms!r}", flush=True)
    for name, (n, us) in top:
        print(f"  {us / 1e3!r} ms x{n} {name[:110]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs "
                 "on a GPU")
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.ops import _build

    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = {name: _build.build(name) for name in _build.SOURCES}
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        print(f"nvcc {name}: " + " | ".join(log.split("\n")), flush=True)

    kernels = []
    for cell, dataset, parties, replaces, jax_path in CELLS:
        t0 = time.perf_counter()
        plan, param = make_plan(dataset, parties)
        engine = GasEngine(plan, param, "opt_inference", device="cuda")
        reference = GasEngine(plan, param, "opt_inference",
                              aggregation="sparse", device="cuda")
        print(f"setup {cell}: {time.perf_counter() - t0:.1f} s, "
              f"P={parties} V={plan.V} dims={param.layer_dims}", flush=True)
        widths = param.layer_dims[1:]
        numbers = kernel_phase(cell, engine.spmm, widths)
        launches = forward_phase(cell, engine, reference)
        profile_phase(cell, engine)
        kernels.append({
            "name": f"spmm_csr_f32[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": jax_path,
            "launches": launches,
            "shape": f"one forward: D in {list(widths)}, n={engine.spmm.n_dst}"
                     f", nnz={engine.spmm.nnz}",
            **numbers,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
