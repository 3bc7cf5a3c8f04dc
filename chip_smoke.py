"""Smoke run of the PyTorch/CUDA port (``cognn_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel from ``cognn_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints the time and the compiler's
   register counts.
3. Checks once that int64 ``+``, ``-``, ``*``, ``sum`` and ``index_add_`` on
   the card wrap like numpy uint64 (the plain versions, the share
   arithmetic and the ``sparse`` backend rely on it).
4. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (the flat CSR of synthetic Cora with 2
   parties and PubMed with 4, at the hidden and the label width, and the
   secret-shared PreScatter matmuls), and times kernel, plain version and
   one library call computing the same function where PyTorch has one (a
   yardstick the port never calls). A second edge list of the same size,
   with part of the edges repeated, checks the SpMM kernels' edge counts
   (above 1 there) and their empty rows. The integer kernels are held to
   ``torch.equal`` on random full-range 64-bit inputs; the ring matmul also
   on a ragged shape that is no multiple of its tiles, and on all -1
   operands (every byte 0xFF, the worst case of its int32 shift sums) at
   K = 4096, 4097 and 5000, small and, at K = 5000, with enough rows that
   one block walks all of K (its uint64 flush inside the block). Each ring
   matmul shape is also timed with a 64 MB buffer written before each call
   (cold L2).
5. Drives the port's main paths at the full width of the models the repo
   ships (GCN 1433->16->7 on Cora 2p, GCN 500->16->3 on PubMed 4p), three
   requests each, with random Glorot weights from a seed:
   plaintext CoGNN-Opt inference (``GasEngine(..., "opt_inference")``) and
   secret-shared inference (``MpcGasEngine(..., "opt_inference")``, shares
   in Z_2^64). Every kernel count is set to 0 just before each path and
   read just after: each forward must launch each of its kernels once per
   layer, and no other kernel. The plaintext logits must match the
   plain-torch ``sparse`` backend; the secret-shared logits must equal the
   ``sparse`` secret-shared backend's bit for bit and lie within 2e-2 of
   the plaintext port's and within 1e-2 of its largest logit; metrics must
   be finite. One more request of each
   is profiled (device time by kernel against wall time).
6. Holds the block-merged tensor-core SpMM (K4) and the SDDMM (K5) against
   their plain versions on each cell's flat edges at both widths (K4 also
   on the repeated edges) and times them, with ``torch.sparse.mm`` on the
   bf16-rounded CSR and ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM) as
   the library calls.
7. Drives the slice-3 path: the aggregation-kernel microbenchmark
   (``cognn_tpu_torch.tools.bench_spmm``) at its defaults (V = 32768,
   E = 131072, D = 16, band 2048). The CSR kernel's, K4's and K5's counts
   are set to 0 just before and read just after: each must have launched
   exactly as often as the tool called it, and the tool raises unless each
   output lies within 1e-5 (CSR, K5) or 5e-3 (K4, bf16 operands) of its
   float64 oracle. Then the tool's own K4 and K5 are held and timed as in
   step 6 (K5 on the tool's edges, duplicates and order as they come, and
   on its ``h`` as both operands). K4 is also held on a graph of two full
   16x16 tiles whose counts reach 300, so bf16 rounds some of them.

The line before the last is one JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is not 0; without a card the script exits 1 before printing a
result.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cognn_tpu_torch.utils.timing import HBM_BYTES_PER_S, device_ms

F32_FLOPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
INT8_TC_OPS_PER_S = 1979e12  # H100 SXM dense int8 on the tensor cores
LIMB_PAIRS = 36  # byte-limb products of one 64-bit multiply-add in K3
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order
# K4 and K5: the same exact products (bf16 x bf16 on the tensor cores, or
# f32 FMAs) summed in f32 in another order; atol as a share of max|plain|
SUM_ORDER_TOL = dict(rtol=1e-5, atol_of_max=1e-5)
SPMM_MERGED_REPLACES = "cognn_tpu/ops/pallas_spmm.py:348"
SDDMM_REPLACES = "cognn_tpu/ops/pallas_sddmm.py:29"
# kernel vs plain sparse backend through two layers, as a share of the
# largest reference logit (PubMed's logits are near uniform and small)
LOGITS_TOL_OF_MAX = 1e-4
# the IMAD pipe's issue rate on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table)
IMAD_PER_CLOCK_PER_SM = 64
# 32-bit multiplies of one 64-bit multiply-add on the IMAD pipe (the wide
# lo*lo and the two cross terms; the adds into the high word uncounted):
# the ring SpMM's operation bound
MULTIPLIES_PER_MAC = 3
FLUSH_BYTES = 64 << 20  # written before each cold-L2 call: above the 50 MB L2
MPC_LOGITS_TOL = 2e-2  # secret-shared vs plaintext, tests/test_mpc.py:90
# ... and as a share of the largest plaintext logit (PubMed's are small)
MPC_LOGITS_TOL_OF_MAX = 1e-2
FORWARDS = 3  # requests per model
TIMED_CALLS = 100  # calls per timing window
PLAIN_CALLS = 20  # the integer plain versions are slow
RAGGED_MATMUL = (3, 1001, 777, 19)  # B, N, K, M: no multiple of any tile
# all -1 operands: K around K_CHUNK = 4096 at small N, M (and K = 5000 with
# rows enough that k_slice keeps all of K in one block, all_ones_check)
ALL_ONES_MATMULS = ((1, 33, 4096, 5), (1, 33, 4097, 5), (2, 70, 5000, 19))

# (cell, dataset, parties, TPU kernel that JAX aggregation="bcsr" runs
# there, which of the JAX package's backends its TPU "auto" policy picks).
# bcsr takes the one-block K2 below 1024 blocks and the supertiled K1 at or
# above; "auto" picks the dense matmul while (P*V)^2 <= 2^28
# (cognn_tpu/engine/gas.py:213), so on Cora 2p it runs no Pallas kernel,
# while the port's "auto" always takes the SpMM.
# The secret-shared engine's "auto" (cognn_tpu/mpc/engine.py:57) picks the
# same backends at these sizes; its bcsr runs the kernels on byte planes of
# the shares (_bcsr_agg_shares, cognn_tpu/mpc/engine.py:269).
CELLS = (
    ("cora_2p", "cora", 2, "cognn_tpu/ops/pallas_spmm.py:27",
     "K2 under aggregation='bcsr'; JAX auto picks dense here"),
    ("pubmed_4p", "pubmed", 4, "cognn_tpu/ops/pallas_spmm.py:149",
     "K1 under aggregation='bcsr', which JAX auto picks here"),
)
RING_MATMUL_REPLACES = "cognn_tpu/ops/intmatmul.py:147"
RING_MATMUL_JAX_PATH = ("ring_matmul_small_prepped (24 int8 MXU dots) "
                        "through Protocol.matmul / matmul_prepped, "
                        "cognn_tpu/mpc/protocol.py:129-174")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip()) * 1e6


def wrap_check() -> None:
    """int64 ``+``, ``-``, ``*``, ``sum`` and ``index_add_`` on the card
    against numpy uint64: the plain versions, the share arithmetic and the
    sparse backend assume they wrap."""
    from cognn_tpu_torch.core.ring import ring_from_u64, ring_to_u64

    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    idx = rng.integers(0, 50, 4096)
    ta = ring_from_u64(a, device="cuda")
    tb = ring_from_u64(b, device="cuda")
    want_add = np.zeros(50, np.uint64)
    np.add.at(want_add, idx, a)
    got_add = torch.zeros(50, dtype=torch.int64, device="cuda").index_add_(
        0, torch.from_numpy(idx).cuda(), ta)
    checks = {
        "+": (ta + tb, a + b),
        "-": (ta - tb, a - b),
        "*": (ta * tb, a * b),
        "sum": (ta.reshape(64, 64).sum(1), a.reshape(64, 64).sum(1)),
        "index_add_": (got_add, want_add),
    }
    for name, (got, want) in checks.items():
        if not np.array_equal(ring_to_u64(got), want):
            raise AssertionError(f"int64 {name} on the card does not wrap "
                                 "like numpy uint64")
    print(f"wrap check: int64 {', '.join(checks)} on the card equal numpy "
          "uint64", flush=True)


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


def csr_edges(spmm):
    """The edges of ``spmm``'s CSR, destination-major with sources
    ascending, each as often as its count."""
    indptr = spmm.indptr.cpu().numpy()
    src = spmm.indices.cpu().numpy().astype(np.int64)
    dst = np.repeat(np.arange(spmm.n_dst), np.diff(indptr))
    counts = spmm.counts.cpu().numpy().astype(np.int64)
    return np.repeat(src, counts), np.repeat(dst, counts)


def with_repeats(spmm):
    """An Spmm at ``spmm``'s shape over its edges with the first quarter
    appended twice more: those entries get counts of 3 (the synthetic
    graphs have no repeated edge), and the padding rows stay empty."""
    from cognn_tpu_torch.ops.spmm import Spmm

    src, dst = csr_edges(spmm)
    k = len(src) // 4
    src = np.concatenate([src, src[:k], src[:k]])
    dst = np.concatenate([dst, dst[:k], dst[:k]])
    dup = Spmm(src, dst, spmm.n_src, spmm.n_dst, spmm.indptr.device)
    if not (dup.counts.max().item() > 1
            and (dup.indptr.diff() == 0).any().item()):
        raise AssertionError("repeated-edge check has no count above 1 "
                             "or no empty row")
    return dup


def held(what: str, got, want, tol) -> float:
    """Raises unless ``got`` equals ``want`` (``tol`` None: ``torch.equal``,
    for the integer kernels) or is close to it (``assert_close(**tol)``,
    where ``atol_of_max`` stands for an atol of that share of max|want|);
    returns max |got - want|."""
    err = float((got - want).abs().max().item()) if want.numel() else 0.0
    if tol is None:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from its plain version "
                                 f"by up to {err!r}")
    else:
        tol = dict(tol)
        if "atol_of_max" in tol:
            scale = want.abs().max().item() if want.numel() else 0.0
            tol["atol"] = tol.pop("atol_of_max") * scale
        torch.testing.assert_close(got, want, **tol)
    return err


def measure(label: str, cases, tol, plain_calls: int = TIMED_CALLS) -> dict:
    """One kernel at each shape of ``cases``, an iterable of (shape, kernel
    fn, plain fn, library, bytes, operation ms); ``library`` is None, a
    library fn, or a pair (library fn, map of its output onto the plain
    version's layout, applied outside the timed call). Holds the kernel
    and the library call against the plain version (:func:`held`), times all
    three and takes the bound as the larger of bytes over the memory rate
    and the operation time. Returns the per-forward sums; ``library_ms`` is
    None, with the refusal in ``library_error``, when PyTorch refuses the
    library call (it is not tried again at later shapes)."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0,
               check="torch.equal" if tol is None else f"assert_close {tol}")
    library_error = None
    bound_by = set()
    for shape, kernel, plain, library, nbytes, t_ops in cases:
        library, view = (library if isinstance(library, tuple)
                         else (library, lambda out: out))
        want = plain()
        err = held(f"{label} {shape}", kernel(), want, tol)
        library_ms = None
        if library is not None and library_error is None:
            try:
                lib = library()
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError) as e:
                library_error = str(e).strip().splitlines()[0]
            else:
                held(f"{label} {shape} library", view(lib), want, tol)
                library_ms = device_ms(library, TIMED_CALLS)
        ms = device_ms(kernel, TIMED_CALLS)
        plain_ms = device_ms(plain, plain_calls)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_by.add("bytes" if t_bytes >= t_ops else "operations")
        print(f"{label} {shape}: max_abs_err={err!r} kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r} library_ms={library_ms!r} "
              f"bound_ms={max(t_bytes, t_ops)!r} (bytes {t_bytes!r} ms for "
              f"{nbytes} B, operations {t_ops!r} ms)", flush=True)
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["library_ms"] += library_ms or 0.0
        tot["bound_ms"] += max(t_bytes, t_ops)
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    if library_error is not None:
        print(f"{label}: no library yardstick: {library_error}", flush=True)
        tot["library_ms"] = None
        tot["library_error"] = library_error
    tot["bound_by"] = "bytes" if bound_by == {"bytes"} else "operations"
    return tot


def kernel_phase(cell: str, spmm, dup, widths) -> dict:
    """The f32 SpMM at each width, measured with ``torch.sparse.mm`` as the
    library call; also held against its plain version on
    :func:`with_repeats`' edges (``dup``)."""
    from cognn_tpu_torch.ops.spmm import spmm_plain

    rng = np.random.default_rng(0)
    a_csr = torch.sparse_csr_tensor(
        spmm.indptr.long(), spmm.indices.long(), spmm.counts,
        size=(spmm.n_dst, spmm.n_src), check_invariants=True)
    errs = []

    def cases():
        for D in widths:
            h = torch.from_numpy(rng.standard_normal(
                (spmm.n_src, D), dtype=np.float32)).cuda()
            errs.append(held(
                f"kernel {cell} D={D} repeated edges", dup(h),
                spmm_plain(dup.indptr, dup.indices, dup.counts, h),
                KERNEL_TOL))
            print(f"kernel {cell} D={D} repeated edges: nnz={dup.nnz} "
                  f"max count={dup.counts.max().item()!r} "
                  f"empty rows={(dup.indptr.diff() == 0).sum().item()} "
                  f"max_abs_err={errs[-1]!r}", flush=True)
            yield (f"D={D} n={spmm.n_dst} nnz={spmm.nnz}",
                   lambda: spmm(h),
                   lambda: spmm_plain(spmm.indptr, spmm.indices, spmm.counts,
                                      h),
                   lambda: torch.sparse.mm(a_csr, h),
                   4 * ((spmm.n_dst + 1) + 2 * spmm.nnz
                        + (spmm.n_src + spmm.n_dst) * D),
                   2 * spmm.nnz * D / F32_FLOPS_PER_S * 1e3)

    tot = measure(f"kernel {cell}", cases(), KERNEL_TOL)
    tot["max_abs_err"] = max(tot["max_abs_err"], *errs)
    return tot


def ring_spmm_phase(cell: str, spmm, dup, widths, mac_ms: float) -> dict:
    """The ring SpMM on both shares of random full-range int64 rows at each
    width, measured with ``torch.sparse.mm`` on the int64 CSR (both shares
    side by side) as the library call; also held against its plain version
    on ``dup``'s edges. ``mac_ms`` is the operation time of one 64-bit
    multiply-add."""
    from cognn_tpu_torch.core.ring import ring_from_u64
    from cognn_tpu_torch.ops.spmm import spmm_plain

    rng = np.random.default_rng(1)
    S, n_src, n_dst = 2, spmm.n_src, spmm.n_dst
    a_csr = torch.sparse_csr_tensor(
        spmm.indptr.long(), spmm.indices.long(), spmm.counts_i64,
        size=(n_dst, n_src), check_invariants=True)

    def cases():
        for D in widths:
            h = ring_from_u64(rng.integers(0, 1 << 64, (S, n_src, D),
                                           dtype=np.uint64), device="cuda")
            h2 = h.transpose(0, 1).reshape(n_src, S * D)
            held(f"ring kernel {cell} D={D} repeated edges", dup.ring(h),
                 spmm_plain(dup.indptr, dup.indices, dup.counts_i64, h), None)
            print(f"ring kernel {cell} D={D}: equal to plain on repeated "
                  f"edges nnz={dup.nnz} (max count "
                  f"{dup.counts_i64.max().item()})", flush=True)
            yield (f"2 shares D={D} n={n_dst} nnz={spmm.nnz}",
                   lambda: spmm.ring(h),
                   lambda: spmm_plain(spmm.indptr, spmm.indices,
                                      spmm.counts_i64, h),
                   lambda: torch.sparse.mm(a_csr, h2).reshape(
                       n_dst, S, D).transpose(0, 1),
                   4 * (n_dst + 1) + 12 * spmm.nnz
                   + 8 * S * (n_src + n_dst) * D,
                   S * spmm.nnz * D * mac_ms)

    return measure(f"ring kernel {cell}", cases(), None, PLAIN_CALLS)


def ring_matmul_operands(shape, rng) -> tuple:
    """Random full-range int64 operands of ``shape`` = (B, N, K, M)."""
    from cognn_tpu_torch.core.ring import ring_from_u64

    B, N, K, M = shape
    return (ring_from_u64(rng.integers(0, 1 << 64, (B, N, K),
                                       dtype=np.uint64), device="cuda"),
            ring_from_u64(rng.integers(0, 1 << 64, (B, K, M),
                                       dtype=np.uint64), device="cuda"))


def cold_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` with the L2 cache cold: a FLUSH_BYTES
    buffer is written before each call and CUDA events bracket the call
    alone, all queued behind a sleep kernel so that no host gap falls
    inside a bracket."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms: time to queue the calls
    for start, end in events:
        flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / calls


def ring_matmul_phase(cell: str, shapes) -> dict:
    """K3 at the secret-shared forward's PreScatter shapes on random
    full-range operands, measured with ``torch.bmm`` on int64 CUDA tensors
    as the library call, and timed once more with the L2 cold
    (:func:`cold_ms`; ``cold_ms`` is their sum). The bound is the larger of
    A, B and C once at 3.35 TB/s and the kernel's 36 byte-limb products a
    multiply-add at the int8 tensor-core rate."""
    from cognn_tpu_torch.ops.intmatmul import ring_matmul, ring_matmul_plain

    rng = np.random.default_rng(2)
    operands = [ring_matmul_operands(shape, rng) for shape in shapes]

    def cases():
        for (B, N, K, M), (a, b) in zip(shapes, operands):
            yield (f"[{B},{N},{K}]@[{B},{K},{M}]",
                   lambda: ring_matmul(a, b),
                   lambda: ring_matmul_plain(a, b),
                   lambda: torch.bmm(a, b),
                   8 * (B * N * K + B * K * M + B * N * M),
                   2 * LIMB_PAIRS * B * N * K * M / INT8_TC_OPS_PER_S * 1e3)

    tot = measure(f"ring matmul {cell}", cases(), None, PLAIN_CALLS)
    tot["cold_ms"] = 0.0
    for shape, (a, b) in zip(shapes, operands):
        ms = cold_ms(lambda: ring_matmul(a, b))
        print(f"ring matmul {cell} {shape} cold L2: kernel_ms={ms!r}",
              flush=True)
        tot["cold_ms"] += ms
    return tot


def all_ones_check() -> None:
    """K3 ``torch.equal`` to its plain version on all -1 operands (every
    byte 0xFF: each int32 shift sum reaches 8 * 255^2 * K of its K chunk)
    at each of ALL_ONES_MATMULS, and at K = 5000 with as many 64-row blocks
    as the card holds at once, so one block walks all of K (above K_CHUNK,
    its flush inside the block)."""
    from cognn_tpu_torch.ops import intmatmul

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    whole = (1, intmatmul.BLOCK_ROWS * intmatmul.BLOCKS_PER_SM * sms, 5000, 3)
    if intmatmul.k_slice(*whole, sms) < whole[2]:
        raise AssertionError("the whole-K all -1 shape splits K")
    for B, N, K, M in ALL_ONES_MATMULS + (whole,):
        a = torch.full((B, N, K), -1, dtype=torch.int64, device="cuda")
        b = torch.full((B, K, M), -1, dtype=torch.int64, device="cuda")
        held(f"ring matmul all -1 {(B, N, K, M)}", intmatmul.ring_matmul(a, b),
             intmatmul.ring_matmul_plain(a, b), None)
        print(f"ring matmul all -1 (B, N, K, M) = {(B, N, K, M)}: equal to "
              f"plain (k_slice {intmatmul.k_slice(B, N, K, M, sms)})",
              flush=True)


def full_tile_check() -> None:
    """K4 held (SUM_ORDER_TOL) to its plain version on two full 16x16 tiles
    (every source of blocks 1 and 2 into every destination of block 0,
    counts 1..300, so bf16 rounds the odd ones above 256) at D = 16 and 7."""
    from cognn_tpu_torch.ops.spmm_merged import SpmmMerged, spmm_merged_plain

    s, d = np.meshgrid(np.arange(16, 48), np.arange(16), indexing="ij")
    reps = 1 + np.arange(s.size) % 300
    k = SpmmMerged(np.repeat(s.reshape(-1), reps),
                   np.repeat(d.reshape(-1), reps), 48, 40, "cuda")
    if k.n_tiles != 2 or k.nnz != 512 or k.counts.max().item() != 300:
        raise AssertionError("full-tile graph is not two full tiles")
    rng = np.random.default_rng(6)
    for D in (16, 7):
        h = torch.from_numpy(rng.standard_normal((48, D),
                                                 dtype=np.float32)).cuda()
        err = held(f"merged kernel full tiles D={D}", k(h),
                   spmm_merged_plain(k.indptr, k.indices, k.counts, h),
                   SUM_ORDER_TOL)
        print(f"merged kernel full tiles D={D}: 2 tiles of 256 entries, "
              f"counts to 300, max_abs_err={err!r}", flush=True)


def merged_phase(label: str, k, widths, dup=None) -> dict:
    """K4 (``k``, a SpmmMerged on the card) at each width, measured with
    ``torch.sparse.mm`` on the f32 CSR of the bf16-rounded counts and rows
    (rounded outside the timed call) as the library call; also held against
    its plain version on the edges of ``dup`` (a SpmmMerged at ``k``'s
    shape, or None). The bound is the function's, as for the CSR kernel:
    the CSR of the counts, H and out once, 2·nnz·D bf16 tensor-core
    operations; the bytes of K4's own tiles (``tile_stream_bytes``) are a
    cost of its design, reported beside it."""
    from cognn_tpu_torch.ops.spmm_merged import spmm_merged_plain

    rng = np.random.default_rng(4)
    a_csr = torch.sparse_csr_tensor(
        k.indptr.long(), k.indices.long(), k.counts.to(torch.bfloat16).float(),
        size=(k.n_dst, k.n_src), check_invariants=True)
    errs = []

    def cases():
        for D in widths:
            h = torch.from_numpy(rng.standard_normal(
                (k.n_src, D), dtype=np.float32)).cuda()
            h16 = h.to(torch.bfloat16).float()
            if dup is not None:
                errs.append(held(
                    f"merged kernel {label} D={D} repeated edges", dup(h),
                    spmm_merged_plain(dup.indptr, dup.indices, dup.counts,
                                      h), SUM_ORDER_TOL))
                print(f"merged kernel {label} D={D} repeated edges: "
                      f"nnz={dup.nnz} tiles={dup.n_tiles} max count="
                      f"{dup.counts.max().item()!r} empty rows="
                      f"{(dup.indptr.diff() == 0).sum().item()} "
                      f"max_abs_err={errs[-1]!r}", flush=True)
            yield (f"D={D} n={k.n_dst} nnz={k.nnz} tiles={k.n_tiles} "
                   f"tile stream={k.tile_bytes} B",
                   lambda: k(h),
                   lambda: spmm_merged_plain(k.indptr, k.indices, k.counts,
                                             h),
                   lambda: torch.sparse.mm(a_csr, h16),
                   4 * ((k.n_dst + 1) + 2 * k.nnz + (k.n_src + k.n_dst) * D),
                   2 * k.nnz * D / BF16_TC_FLOPS_PER_S * 1e3)

    tot = measure(f"merged kernel {label}", cases(), SUM_ORDER_TOL)
    tot["max_abs_err"] = max(tot["max_abs_err"], *errs, 0.0)
    tot["tile_stream_bytes"] = k.tile_bytes * len(widths)
    return tot


def sddmm_phase(label: str, k, operands) -> dict:
    """K5 (``k``, an Sddmm on the card) on each (a, b) of ``operands``,
    measured with ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM) as the
    library call: it takes a CSR pattern, so it runs on k's distinct edges
    sorted by destination, then source, and its scores are held against
    the plain version's through each edge's place in that pattern. The
    bytes count both index arrays, the scores, and each distinct row
    tensor once (``a is b`` on the microbenchmark)."""
    from cognn_tpu_torch.ops.sddmm import sddmm_plain

    src = k.src.cpu().numpy().astype(np.int64)
    dst = k.dst.cpu().numpy().astype(np.int64)
    keys, pos = np.unique(dst * k.n_src + src, return_inverse=True)
    indptr = np.zeros(k.n_dst + 1, np.int64)
    np.cumsum(np.bincount(keys // k.n_src, minlength=k.n_dst),
              out=indptr[1:])
    pattern = torch.sparse_csr_tensor(
        torch.from_numpy(indptr).cuda(),
        torch.from_numpy(keys % k.n_src).cuda(),
        torch.ones(len(keys), device="cuda"), size=(k.n_dst, k.n_src),
        check_invariants=True)
    pos = torch.from_numpy(pos.reshape(-1)).cuda()

    def cases():
        for a, b in operands:
            D = a.shape[1]
            at = a.t().contiguous()
            rows = a.numel() + (0 if b is a else b.numel())
            yield (f"D={D} n={k.n_dst} edges={k.n_edges} "
                   f"distinct={len(keys)}",
                   lambda: k(a, b),
                   lambda: sddmm_plain(k.src, k.dst, a, b),
                   (lambda: torch.sparse.sampled_addmm(pattern, b, at,
                                                       beta=0.0).values(),
                    lambda vals: vals[pos]),
                   12 * k.n_edges + 4 * rows,
                   2 * k.n_edges * D / F32_FLOPS_PER_S * 1e3)

    return measure(f"sddmm kernel {label}", cases(), SUM_ORDER_TOL)


def random_operands(k, widths, seed: int):
    """Random f32 (a [n_src, D], b [n_dst, D]) on the card, one pair per
    width."""
    rng = np.random.default_rng(seed)
    for D in widths:
        yield tuple(torch.from_numpy(rng.standard_normal(
            (n, D), dtype=np.float32)).cuda() for n in (k.n_src, k.n_dst))


def bench_phase():
    """The slice's path: the aggregation-kernel microbenchmark
    (``cognn_tpu_torch.tools.bench_spmm``) at its defaults, with the three
    kernels' counts set to 0 just before and read just after. Each must
    have launched exactly as often as the tool called it; the tool itself
    raises when an output lies beyond its bound of the float64 oracle.
    Returns the tool's case and the counts."""
    from cognn_tpu_torch.tools import bench_spmm

    t0 = time.perf_counter()
    case = bench_spmm.setup(device="cuda")
    print(f"setup bench: {time.perf_counter() - t0:.1f} s, V={case.v} "
          f"E={len(case.src)} D={case.h.shape[1]} distinct edges="
          f"{case.spmm.nnz} 16x16 tiles={case.merged.n_tiles}", flush=True)
    kernels = {"spmm_csr_f32": case.spmm, "spmm_merged_bf16": case.merged,
               "sddmm_f32": case.sddmm}
    for k in kernels.values():
        k.launches = 0
    report = bench_spmm.run(case)
    counts = {name: k.launches for name, k in kernels.items()}
    if counts != report["calls"] or not all(counts.values()):
        raise AssertionError(f"bench: kernel launches {counts}, the tool "
                             f"called {report['calls']}")
    print(f"bench: launches={counts} rel_err={report['rel_err']}",
          flush=True)
    return case, counts


def reset_counts(spmms) -> None:
    from cognn_tpu_torch.ops import intmatmul

    intmatmul.launches = 0
    for k in spmms:
        k.launches = k.ring_launches = 0


def read_counts(spmms) -> dict:
    from cognn_tpu_torch.ops import intmatmul

    return {"spmm_csr_f32": sum(k.launches for k in spmms),
            "spmm_csr_i64": sum(k.ring_launches for k in spmms),
            "ring_matmul_i64": intmatmul.launches}


def timed_forwards(engine):
    """FORWARDS requests; returns the last one's output and the ms of
    each."""
    times = []
    for _ in range(FORWARDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def check_metrics(cell: str, engine, metrics) -> dict:
    m = engine.metrics_host(metrics)
    for k, v in m.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{cell}: metric {k} not finite: {v}")
    return m


def forward_phase(cell: str, engine, reference, spmms):
    """The plaintext main path: FORWARDS inference requests, with every
    kernel count set to 0 just before and read just after. Returns the f32
    kernel's launches and the logits."""
    reset_counts(spmms)
    (z, prob, metrics), times = timed_forwards(engine)
    counts = read_counts(spmms)

    P, V, C = engine.P, engine.plan.V, engine.param.num_labels
    if tuple(z.shape) != (P, V, C):
        raise AssertionError(f"{cell}: logits shape {tuple(z.shape)}")
    want = {"spmm_csr_f32": FORWARDS * engine.L, "spmm_csr_i64": 0,
            "ring_matmul_i64": 0}
    if counts != want:
        raise AssertionError(f"{cell}: kernel launches {counts} in "
                             f"{FORWARDS} forwards of {engine.L} layers, "
                             f"want {want}")
    z_ref = reference.forward()[0]
    atol = LOGITS_TOL_OF_MAX * z_ref.abs().max().item()
    torch.testing.assert_close(z, z_ref, rtol=0, atol=atol)
    m = check_metrics(cell, engine, metrics)
    print(f"forward {cell}: ms per request {times!r} launches={counts} "
          f"max|z - z_sparse|={(z - z_ref).abs().max().item()!r} "
          f"(atol {atol!r}) "
          f"loss={m['loss'].tolist()} test_acc={m['test_acc'].tolist()} "
          f"full_acc={m['full_acc'].tolist()}", flush=True)
    return counts["spmm_csr_f32"], z


def n0_fp_check(cell: str, mpc) -> None:
    """How many encoded normalizers the card's rsqrt moves by a ring unit
    against the CPU's: on this cell's in-degrees and on every degree
    0..199,999. More than one unit fails."""
    from cognn_tpu_torch.engine.gas import norm0

    enc = mpc.proto.encode_public
    for name, deg in (("cell", mpc.arr.in_deg),
                      ("0..199999", torch.arange(200_000, dtype=torch.float32,
                                                 device="cuda"))):
        diff = enc(norm0(deg)).cpu() - enc(norm0(deg.cpu()))
        worst = diff.abs().max().item()
        print(f"n0_fp {cell} {name}: {(diff != 0).sum().item()} of "
              f"{diff.numel()} differ card vs CPU, max {worst} unit(s)",
              flush=True)
        if worst > 1:
            raise AssertionError(f"{cell}: n0_fp card vs CPU off by {worst}")


def mpc_forward_phase(cell: str, mpc, mpc_sparse, z_plain, spmms) -> dict:
    """The secret-shared main path: FORWARDS inference requests, with every
    kernel count set to 0 just before and read just after. Returns the
    counts."""
    reset_counts(spmms)
    torch.cuda.reset_peak_memory_stats()
    (z, prob, metrics), times = timed_forwards(mpc)
    counts = read_counts(spmms)
    peak = torch.cuda.max_memory_allocated()

    P, V, C = mpc.P, mpc.plan.V, mpc.param.num_labels
    if tuple(z.shape) != (P, V, C) or z.dtype != torch.float32:
        raise AssertionError(f"{cell}: mpc logits {z.dtype} "
                             f"{tuple(z.shape)}")
    want = {"spmm_csr_f32": 0, "spmm_csr_i64": FORWARDS * mpc.L,
            "ring_matmul_i64": FORWARDS * mpc.L}
    if counts != want:
        raise AssertionError(f"{cell}: mpc kernel launches {counts} in "
                             f"{FORWARDS} forwards of {mpc.L} layers, "
                             f"want {want}")
    z_sparse = mpc_sparse.forward()[0]
    if not torch.equal(z, z_sparse):
        raise AssertionError(f"{cell}: mpc kernel path differs from the "
                             f"sparse path by "
                             f"{(z - z_sparse).abs().max().item()}")
    err = (z - z_plain).abs().max().item()
    tol = min(MPC_LOGITS_TOL,
              MPC_LOGITS_TOL_OF_MAX * z_plain.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{cell}: mpc logits {err} from plaintext, "
                             f"tolerance {tol}")
    m = check_metrics(cell, mpc, metrics)
    print(f"mpc forward {cell}: ms per request {times!r} launches={counts} "
          f"equal to sparse; max|z - z_plain|={err!r} (tol {tol!r}) "
          f"peak device memory {peak} B "
          f"loss={m['loss'].tolist()} test_acc={m['test_acc'].tolist()} "
          f"full_acc={m['full_acc'].tolist()}", flush=True)
    return counts


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
    from cognn_tpu_torch.mpc import MpcGasEngine
    from cognn_tpu_torch.ops import _build
    from cognn_tpu_torch.ops.intmatmul import ring_matmul, ring_matmul_plain
    from cognn_tpu_torch.ops.sddmm import Sddmm
    from cognn_tpu_torch.ops.spmm_merged import SpmmMerged

    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:  # one nvcc each
        logs = dict(zip(_build.SOURCES, pool.map(_build.build,
                                                 _build.SOURCES)))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        print(f"nvcc {name}: " + " | ".join(log.split("\n")), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    int_rate = IMAD_PER_CLOCK_PER_SM * sms * clock
    mac_ms = MULTIPLIES_PER_MAC / int_rate * 1e3
    print(f"integer multiply rate: {IMAD_PER_CLOCK_PER_SM} IMAD/clock/SM x "
          f"{sms} SMs x {clock / 1e6:.0f} MHz = {int_rate!r} /s; one 64-bit "
          f"multiply-add {mac_ms!r} ms", flush=True)
    wrap_check()
    a, b = ring_matmul_operands(RAGGED_MATMUL, np.random.default_rng(3))
    held(f"ring matmul {RAGGED_MATMUL}", ring_matmul(a, b),
         ring_matmul_plain(a, b), None)
    print(f"ring matmul (B, N, K, M) = {RAGGED_MATMUL}: equal to plain on "
          "full-range operands", flush=True)
    del a, b
    all_ones_check()

    kernels = []
    for cell, dataset, parties, replaces, jax_path in CELLS:
        t0 = time.perf_counter()
        plan, param = make_plan(dataset, parties)
        engine = GasEngine(plan, param, "opt_inference", device="cuda")
        reference = GasEngine(plan, param, "opt_inference",
                              aggregation="sparse", device="cuda")
        mpc = MpcGasEngine(plan, param, "opt_inference", device="cuda")
        mpc_sparse = MpcGasEngine(plan, param, "opt_inference",
                                  aggregation="sparse", device="cuda")
        print(f"setup {cell}: {time.perf_counter() - t0:.1f} s, "
              f"P={parties} V={plan.V} dims={param.layer_dims}", flush=True)
        dims, L = param.layer_dims, param.num_layers
        widths = dims[1:]
        dup = with_repeats(engine.spmm)
        spmms = (engine.spmm, mpc.spmm, dup)
        f32 = kernel_phase(cell, engine.spmm, dup, widths)
        ring = ring_spmm_phase(cell, mpc.spmm, dup, widths, mac_ms)
        shapes = [(parties, plan.V, dims[l], dims[l + 1]) for l in range(L)]
        k3 = ring_matmul_phase(cell, shapes)

        f32_launches, z_plain = forward_phase(cell, engine, reference, spmms)
        profile_phase(cell, engine)
        n0_fp_check(cell, mpc)
        counts = mpc_forward_phase(cell, mpc, mpc_sparse, z_plain, spmms)
        profile_phase(f"{cell} mpc", mpc)
        n_src, n_dst = engine.spmm.n_src, engine.spmm.n_dst
        src, dst = csr_edges(engine.spmm)
        merged_phase(cell, SpmmMerged(src, dst, n_src, n_dst, "cuda"), widths,
                     SpmmMerged(*csr_edges(dup), n_src, n_dst, "cuda"))
        k5 = Sddmm(src, dst, n_src, n_dst, "cuda")
        sddmm_phase(cell, k5, random_operands(k5, widths, 5))

        csr = f"n={engine.spmm.n_dst}, nnz={engine.spmm.nnz}"
        kernels += [{
            "name": f"spmm_csr_f32[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": jax_path,
            "launches": f32_launches,
            "shape": f"one forward: D in {list(widths)}, {csr}",
            **f32,
        }, {
            "name": f"spmm_csr_i64[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": f"share instantiation (_bcsr_agg_shares, "
                        f"cognn_tpu/mpc/engine.py:269): {jax_path}",
            "launches": counts["spmm_csr_i64"],
            "shape": f"one secret-shared forward: 2 shares, D in "
                     f"{list(widths)}, {csr}",
            **ring,
        }, {
            "name": f"ring_matmul_i64[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
            "replaces": RING_MATMUL_REPLACES,
            "jax_path": RING_MATMUL_JAX_PATH,
            "launches": counts["ring_matmul_i64"],
            "shape": "one secret-shared forward: " + ", ".join(
                f"[{b},{n},{k}]@[{b},{k},{m}]" for b, n, k, m in shapes),
            **k3,
        }]

    case, bench_counts = bench_phase()
    full_tile_check()
    v, d = case.v, case.h.shape[1]
    k4 = merged_phase("bench", case.merged, (d,))
    k5 = sddmm_phase("bench", case.sddmm, [(case.h, case.h)])
    bench_shape = (f"the tool's graph: V={v} E={len(case.src)} band 2048 "
                   f"({case.spmm.nnz} distinct edges), D={d}")
    kernels += [{
        "name": "spmm_merged_bf16[bench]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/spmm_merged.cu",
        "replaces": SPMM_MERGED_REPLACES,
        "jax_path": "tools/bench_spmm.py:210-227 (--merged)",
        "launches": bench_counts["spmm_merged_bf16"],
        "shape": f"{bench_shape}, {case.merged.n_tiles} 16x16 tiles "
                 f"stored as {case.merged.nnz} entries",
        **k4,
    }, {
        "name": "sddmm_f32[bench]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/sddmm.cu",
        "replaces": SDDMM_REPLACES,
        "jax_path": "tools/bench_spmm.py:252-263",
        "launches": bench_counts["sddmm_f32"],
        "shape": f"{bench_shape}; scores of the tool's {len(case.src)} "
                 f"edges in its order, on (h, h); sampled_addmm on the "
                 f"{case.spmm.nnz} distinct ones",
        **k5,
    }]

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
