"""The port's per-phase breakdown (``cognn_tpu_torch/tools/profile_epoch.py``)
on the CPU, in three parts:

1. the classifier on a hand-built Chrome trace: nested Python frames,
   ``cuda_runtime`` / ``cuda_driver`` launches with correlations, kernels,
   a memset, an ``aten::randint`` and a kernel with no launch, each with a
   bucket known in advance, to the picosecond;
2. a real CPU profile of one secret-shared CoGNN-Opt epoch (P = 2,
   ``cora_small``) through the tool's CLI, classified on leaf ``cpu_op``
   events: the buckets sum to the total, the on-path buckets are filled,
   nothing is unlinked, and ``--parse-only`` reads the saved trace back to
   the same report;
3. agreement with the JAX tool (``tools/profile_mpc_epoch.py``, which
   imports ``jax`` only inside ``main``): the same ``REF_TAGS`` and
   protocol rules, the same ``report()`` text and breakdown log for the
   same buckets, and the log read back by
   ``tools/plot/plot_duration_breakdown_and_comm.breakdown`` to the same
   values.
"""

import gzip
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from cognn_tpu_torch.mpc.protocol import Protocol
from cognn_tpu_torch.tools import profile_epoch as pe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = "/src/cognn_tpu_torch/"


def load_tool(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frame(path, func, ts, dur, tid=10, line=1):
    return {"ph": "X", "cat": "python_function", "pid": 1, "tid": tid,
            "name": f"{path}({line}): {func}", "ts": ts, "dur": dur}


def op(name, ts, dur, tid=10):
    return {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": tid, "name": name,
            "ts": ts, "dur": dur}


def launch(corr, ts, name="cudaLaunchKernel", cat="cuda_runtime", tid=10):
    return {"ph": "X", "cat": cat, "pid": 1, "tid": tid, "name": name,
            "ts": ts, "dur": 2.0, "args": {"correlation": corr}}


def device(corr, name, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "pid": 0, "tid": 7, "name": name,
            "ts": 5000.0 + corr, "dur": dur, "args": {"correlation": corr}}


def hand_trace():
    """The events of one made-up epoch and the bucket of each device event
    (us)."""
    events = [
        frame(PKG + "mpc/engine.py", "run_epochs_scan", 0, 2000),
        frame(PKG + "mpc/engine.py", "_epoch_opt", 5, 1500),
        # reshare > share_split (a helper: looked through)
        frame(PKG + "mpc/protocol.py", "reshare", 10, 100),
        frame(PKG + "core/shares.py", "share_split", 20, 80),
        op("aten::randint", 30, 20), op("aten::random_", 32, 16),
        launch(1, 34),            # random kernel -> prng
        op("aten::sub", 60, 10),
        launch(2, 62),            # x - r in share_split -> trunc-reshare
        # the SpMM wrapper, a ctypes launch (no aten op around it)
        frame(PKG + "mpc/engine.py", "_aggregate", 150, 200),
        frame(PKG + "ops/spmm.py", "__call__", 200, 100),
        launch(3, 250),           # csr_gather_sum -> oga
        # matmul_prepped > ring_matmul: K3's zeroed output, then K3
        frame(PKG + "mpc/protocol.py", "matmul_prepped", 400, 200),
        frame(PKG + "ops/intmatmul.py", "ring_matmul", 420, 160),
        op("aten::zeros", 430, 20), op("aten::zero_", 432, 16),
        launch(4, 440, "cudaMemsetAsync"),   # memset -> matmul
        launch(5, 500, "cuLaunchKernel", "cuda_driver"),  # K3 -> matmul
        # a frame outside the package: the innermost package frame counts
        frame("torch/_tensor.py", "wrapped", 700, 50),
        launch(6, 710),           # -> <other:engine.py:_epoch_opt>
        # gcn_metrics' nested accuracy, then stack_epochs
        frame(PKG + "engine/gas.py", "gcn_metrics", 800, 100),
        frame(PKG + "ops/metrics.py", "acc", 820, 30),
        launch(7, 830),           # -> apply
        frame(PKG + "engine/gas.py", "stack_epochs", 1600, 50),
        launch(8, 1610),          # -> scan-overhead
        # another thread: no frame, no operator
        launch(9, 100, tid=11),   # -> <other:host>
        # a kernel launch whose device record the profiler lost, and a
        # runtime call that has none by nature
        launch(50, 1200),
        launch(51, 1210, "cudaStreamIsCapturing"),
        # the reshare of a scale: ring_mul in scale_rows, then trunc
        frame(PKG + "mpc/protocol.py", "scale_rows", 900, 100),
        frame(PKG + "core/ring.py", "ring_mul", 910, 20),
        launch(10, 915),          # -> scale
        frame(PKG + "mpc/protocol.py", "trunc", 940, 50),
        frame(PKG + "mpc/protocol.py", "reconstruct_ring", 945, 20),
        frame(PKG + "core/ring.py", "ring_add", 950, 10),
        launch(11, 952),          # -> reconstruct
        # a helper called straight from a function without a rule
        frame(PKG + "mpc/engine.py", "_sgd_step", 1100, 50),
        frame(PKG + "core/ring.py", "ring_sum", 1110, 10),
        launch(12, 1112),         # -> ring-helpers
    ]
    dev = [(1, "void at::native::distribution_kernel", 2.0, "prng"),
           (2, "void at::native::sub_kernel", 3.0, "trunc-reshare"),
           (3, "void csr_gather_sum<unsigned long, 2, 1, 8, 2>(int const*)",
            10.0, "oga"),
           (4, "Memset (Device)", 0.5, "matmul", "gpu_memset"),
           (5, "void ring_matmul_u8_mma<unsigned long>(unsigned long*)",
            20.0, "matmul"),
           (6, "void at::native::copy_kernel", 1.25,
            "<other:engine.py:_epoch_opt>"),
           (7, "void at::native::reduce_kernel", 0.75, "apply"),
           (8, "void at::native::cat_kernel", 0.25, "scan-overhead"),
           (9, "void at::native::fill_kernel", 4.0, "<other:host>"),
           (10, "void at::native::mul_kernel", 1.5, "scale"),
           (11, "void at::native::add_kernel", 0.125, "reconstruct"),
           (12, "void at::native::sum_kernel", 0.375, "ring-helpers"),
           (99, "void orphan_kernel", 7.0, pe.UNLINKED)]
    want = {}
    for corr, name, dur, bucket, *cat in dev:
        events.append(device(corr, name, dur, *cat))
        want[bucket] = want.get(bucket, 0) + round(dur * 1e6)
    return {"traceEvents": events, "deviceProperties": [{"name": "card"}]}, \
        want


def test_classifier_on_hand_built_trace(tmp_path):
    trace, want = hand_trace()
    result = pe.parse_trace(trace, "kernel")
    assert result.by_scope == want
    assert result.total == sum(want.values()) == 50_750_000
    assert result.lost == 1
    assert result.plane == "card (cuda:0)"
    assert result.kernels[
        "oga", "void csr_gather_sum<unsigned long, 2, 1, 8, 2>(int const*)"
    ] == 1
    assert result.kernels["matmul", "Memset (Device)"] == 1
    # saved gzipped and re-read: the same
    path = tmp_path / "x.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    assert pe.latest_trace(tmp_path) == path
    again = pe.parse_trace(pe.load_trace(path), "kernel")
    assert again.by_scope == want


def test_classifier_rules():
    assert pe.package_frame(
        "/a/cognn_tpu_torch/b/cognn_tpu_torch/ops/spmm.py(151): __call__"
    ) == ("ops/spmm.py", "__call__")
    assert pe.package_frame("torch/nn/functional.py(9): softmax") is None
    assert pe.package_frame("<built-in method add of Tensor>") is None
    cases = {("mpc/engine.py", "_aggregate"): "oga",
             ("engine/gas.py", "halo"): "oga",
             ("ops/aggregate.py", "segment_sum_rows"): "oga",
             ("ops/bcsr.py", "anything"): "oga",
             ("ops/intmatmul.py", "ring_matmul"): "matmul",
             ("mpc/engine.py", "_scale_rows"): "scale",
             ("mpc/engine.py", "weight_total"): "apply",
             ("engine/gas.py", "stack_epochs"): "scan-overhead",
             ("core/fixedpoint.py", "fp_encode"): "ring-helpers",
             ("utils/glibc_rand.py", "glorot_init"): "other",
             ("mpc/protocol.py", "less_mask"): "<other:protocol.py:"
                                               "less_mask>"}
    for f, bucket in cases.items():
        assert pe.classify(f, (), f) == bucket, f
    assert pe.classify(("core/ring.py", "ring_add"), (),
                       ("mpc/protocol.py", "sub")) == "share-linear"
    assert pe.classify(("mpc/engine.py", "_aggregate"),
                       ("aten::randint", "aten::random_")) == "prng"
    assert pe.classify(None, ("aten::copy_",)) == "<other:aten::copy_>"


def test_leaf_operators():
    ops = [op("a", 0, 10), op("b", 1, 4), op("c", 2, 1), op("d", 6, 2),
           op("e", 20, 1), op("f", 20, 0.5)]
    assert [e["name"] for e in pe._leaves(ops)] == ["c", "d", "f"]


def test_trace_window_follows_one_warmup_scan(tmp_path):
    """One untraced scan as the profiler's warm-up step, then ``on_start``,
    then the ``reps`` traced scans: a count reset in ``on_start`` sees the
    traced scans only, and the trace holds only them."""
    calls = []

    class Engine:
        def run_epochs_scan(self, n):
            calls.append(n)
            torch.ones(3).add_(1)  # one operator a scan

    path = tmp_path / "w.trace.json.gz"
    pe.trace_epochs(Engine(), 5, 3, path, torch.device("cpu"),
                    on_start=lambda: calls.append("start"))
    assert calls == [5, "start", 5, 5, 5]
    adds = [e for e in pe.load_trace(path)["traceEvents"]
            if e.get("cat") == "cpu_op" and e["name"] == "aten::add_"]
    assert len(adds) == 3


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("profile")
    log = tmp / "cora_small_mpc_2p.breakdown"
    argv = ["--dataset", "cora_small", "--parties", "2", "--variant", "opt",
            "--scan", "1", "--reps", "1", "--outdir", str(tmp),
            "--breakdown-log", str(log), "--device", "cpu"]
    return tmp, log, argv


def test_cpu_profile_of_one_epoch(cpu_run, capsys):
    tmp, log, argv = cpu_run
    assert pe.main(argv) == 0
    text = capsys.readouterr().out
    path = pe.latest_trace(tmp)
    assert path.name == "cora_small_2p_opt.trace.json.gz"
    result = pe.parse_trace(pe.load_trace(path), "cpu_op")
    assert sum(result.by_scope.values()) == result.total > 0
    assert result.lost == 0
    for bucket in ("oga", "matmul", "trunc-reshare", "prng", "apply",
                   "nonlinear", "scale", "reconstruct", "share-linear"):
        assert result.by_scope.get(bucket, 0) > 0, (bucket, result.by_scope)
    assert pe.UNLINKED not in result.by_scope
    assert text.startswith("# trace plane: host (leaf cpu_op events)\n"
                           "# 1 epochs; device total ")
    assert "  ::Scatter_Merge_Gather took " in text
    lines = log.read_text().splitlines()
    assert [x.split()[0] for x in lines] == [f"::{t}" for t in pe.REF_TAGS] \
        + ["::other_device"]
    # the saved trace, parsed again without a run
    assert pe.main(argv + ["--parse-only"]) == 0
    assert capsys.readouterr().out == text


def test_report_and_log_agree_with_jax_tool(tmp_path, capsys):
    jax_tool = load_tool("jax_profile_mpc_epoch",
                         ROOT / "tools" / "profile_mpc_epoch.py")
    plot = load_tool("jax_plot_breakdown", ROOT / "tools" / "plot"
                     / "plot_duration_breakdown_and_comm.py")
    assert "jax" not in getattr(jax_tool, "__dict__", {})
    assert pe.REF_TAGS == jax_tool.REF_TAGS
    # every protocol rule of JAX's table that the port's Protocol has
    for (f, func), bucket in jax_tool._FUNC_RULES.items():
        if f == "protocol.py" and hasattr(Protocol, func):
            assert pe._FUNC_RULES["mpc/protocol.py", func] == bucket, func

    _, want = hand_trace()
    n_epochs = 4
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    pe.report("card", want, sum(want.values()), n_epochs,
              str(ours / "cora_mpc_2p.breakdown"))
    port_text = capsys.readouterr().out
    jax_tool.report("card", want, sum(want.values()), n_epochs,
                    str(theirs / "cora_mpc_2p.breakdown"))
    assert port_text == capsys.readouterr().out
    assert (ours / "cora_mpc_2p.breakdown").read_text() == \
        (theirs / "cora_mpc_2p.breakdown").read_text()

    read = plot.breakdown(ours, "cora", 6)
    for tag, scopes in pe.REF_TAGS.items():
        ps = sum(want.get(s, 0) for s in scopes)
        assert read[tag] == pytest.approx(ps / 1e12 / n_epochs, abs=5e-7)
    other = sum(v for k, v in want.items() if k.startswith("<other"))
    assert read["other_device"] == pytest.approx(other / 1e12 / n_epochs,
                                                 abs=5e-7)
