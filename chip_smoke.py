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
   (cold L2). The two CSR SpMM kernels are also held on a graph of edge
   cases (``edge_case_check``): a hub row of 1500 entries, rows one below,
   at and one above every batch size, empty first, middle and last rows,
   an odd source count (the ring's share 1 misaligned at odd D), at
   D = 1, 3, 7, 16, 33, 64, 500, 1433, and on ``h`` one element into its
   storage (the scalar path). The SDDMM (K5) is held on its own edge cases
   (``sddmm_edge_check``): every D from 1 to 64, edge counts of 0, 1 and
   one below, at and one above every power of two to 1024 (its batch,
   warp and block sizes), repeated edges and edges on the last rows,
   n_src != n_dst, and ``a`` one element into its storage (the scalar
   path); ``torch.equal`` on integer-valued rows. A one-element ``zero_``
   is timed as the kernels are: the launch floor. Each cell's in-degree
   profile is printed.
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
   is profiled (device time by kernel against wall time). Between the two,
   ``n0_fp_check``: the secret-shared engine's encoded normalizers (from
   the host's float64 rsqrt) equal on the card and on the CPU, on the
   cell's degrees and on every degree 0..199,999.
6. Holds the block-merged tensor-core SpMM (K4) and the SDDMM (K5) against
   their plain versions on each cell's flat edges at both widths (K4 also
   on the repeated edges) and times them, with ``torch.sparse.mm`` on the
   bf16-rounded CSR and ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM) as
   the library calls. K5 at the cells' shapes is on the kernels line
   (``sddmm_f32[cell]``, shape only), with its launches counted in step
   5's forwards like every other kernel's: no engine launches it, so 0.
7. Drives the training main path of each cell (``variant="opt"``, fresh
   engines), plaintext and secret-shared (``train_phase``): every kernel
   count set to 0, EPOCHS_CHECKED epochs through ``run_epochs_scan``, the
   counts read; each epoch must launch 3L - 2 SpMMs (f32 or ring) and, in
   the secret-shared epoch, 3L - 1 share matmuls (K3; ``epoch_counts``).
   The same epochs on the ``sparse`` backend must give equal revealed
   weights and metrics (secret-shared) or weights within
   TRAIN_WEIGHTS_TOL_OF_MAX of the largest (plaintext); the secret-shared
   weights must lie within MPC_WEIGHTS_TOL of the plaintext port's. Then
   EPOCHS_TIMED epochs through ``run_epochs`` and ``run_epochs_scan``
   (ms an epoch, edge-iterations/s), one profiled epoch, K3 at the
   epoch's backward shapes held ``torch.equal`` and timed warm and cold
   (``ring_matmul_phase``, ``ring_matmul_i64[cell train]`` on the kernels
   line), and the accuracy run (``accuracy_phase``): ACCURACY_EPOCHS epochs
   from fresh engines, the loss must fall and the two engines' final test
   accuracies agree within ACC_AGREE; the rows of
   results/matrix/SUMMARY.md at the same settings are printed beside them.
8. Drives the CoGNN (unopt) paths of each cell, whose layer-0
   aggregation runs at the full input width (1433 on Cora, 500 on
   PubMed): the f32 SpMM held ``torch.equal`` to its plain version on
   integer-valued rows at that width (``integer_rows_check``), both SpMMs
   measured at one unopt forward's widths (input and hidden) as in step 4;
   then ``unopt_forward_phase``: FORWARDS ``unopt_inference`` requests of
   the plaintext engine (logits against ``sparse`` as in step 5), of the
   secret-shared engine with the hoisted agg(x0) and without it (each
   logits ``torch.equal`` to the hoisted ``sparse`` engine's, within
   MPC_LOGITS_TOL of the plaintext port's), the counts read around each: a
   forward launches 2 SpMMs plaintext, 1 ring SpMM and 2 K3 hoisted, 2 ring
   SpMMs and 2 K3 not hoisted (``forward_counts``), one more request of
   each profiled; ``unopt_train_phase``: EPOCHS_CHECKED ``unopt`` epochs of
   fresh engines, plaintext, hoisted and not hoisted, each held to its
   ``sparse`` twin as in step 7, the hoisted and not hoisted revealed
   weights and metrics ``torch.equal``; an epoch launches 3 SpMMs, or 2
   ring SpMMs (3 not hoisted) and 5 K3 (``epoch_counts``); then
   EPOCHS_TIMED_UNOPT epochs of each timed and one profiled; and the
   accuracy run for unopt beside its matrix rows. The kernels line gains
   the unopt SpMMs (``[cell unopt]``, one unopt forward's widths) and K3
   (the opt forward's shapes, timed once) with their unopt launches.
9. Drives the slice-3 path: the aggregation-kernel microbenchmark
   (``cognn_tpu_torch.tools.bench_spmm``) at its defaults (V = 32768,
   E = 131072, D = 16, band 2048). The CSR kernel's, K4's and K5's counts
   are set to 0 just before and read just after: each must have launched
   exactly as often as the tool called it, and the tool raises unless each
   output lies within 1e-5 (CSR, K5) or 5e-3 (K4, bf16 operands) of its
   float64 oracle. Then the CSR kernel (on random rows), the tool's own
   K4 and K5 are held and timed as in steps 4 and 6 (K5 on the tool's
   edges, duplicates and order as they come, and on its ``h`` as both
   operands). K4 is also held on a graph of two full 16x16 tiles whose
   counts reach 300, so bf16 rounds some of them.

The line before the last is one JSON object with each kernel's numbers
(the engines' kernels also with their ``training_launches`` and
``launches_per_epoch``); the
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
EPOCHS_CHECKED = 2  # training epochs held to the sparse path, per engine
EPOCHS_TIMED = 5  # epochs per timing window
# the unopt epochs' timing window: at 5 epochs the host's noise moved ms an
# epoch by up to 56% within one call (PERF.md §6)
EPOCHS_TIMED_UNOPT = 20
ACCURACY_EPOCHS = 90  # the epochs of results/matrix/SUMMARY.md's runs
# plaintext kernel vs sparse weights after EPOCHS_CHECKED epochs, as a share
# of the largest weight (f32 sums in another order; a ReLU' mask can flip)
TRAIN_WEIGHTS_TOL_OF_MAX = 1e-4
MPC_WEIGHTS_TOL = 5e-3  # secret-shared vs plaintext weights, test_mpc.py:104
ACC_AGREE = 0.01  # secret-shared vs plaintext final test accuracy
# (cell, secret-shared, variant) -> the row of results/matrix/SUMMARY.md at
# the same settings (synthetic Planetoid, vertex v to party v mod P, seed
# 42, exact truncation; tools/run_cluster.py:433-436): name, final loss and
# test accuracy of the JAX package's 90-epoch run. Printed, not gated.
MATRIX_ROWS = {
    ("cora_2p", False, "opt"): ("opt_accuracy_2p cora (:74)", 0.2924,
                                0.8956),
    ("cora_2p", True, "opt"): ("mpc_opt_accuracy_2p cora (:20)", 0.2922,
                               0.8962),
    ("pubmed_4p", False, "opt"): ("opt_accuracy_4p pubmed (:81)", 0.0520,
                                  0.9814),
    ("pubmed_4p", True, "opt"): ("mpc_opt_accuracy_4p pubmed (:27)",
                                 0.0517, 0.9815),
    ("cora_2p", False, "unopt"): ("unopt_accuracy_2p cora (:105)", 0.2746,
                                  0.8925),
    ("cora_2p", True, "unopt"): ("mpc_unopt_accuracy_2p cora (:47)",
                                 0.2748, 0.8925),
    ("pubmed_4p", False, "unopt"): ("unopt_accuracy_4p pubmed (:112)",
                                    0.0444, 0.9839),
    ("pubmed_4p", True, "unopt"): ("mpc_unopt_accuracy_4p pubmed (:54)",
                                   0.0443, 0.9840),
}
TIMED_CALLS = 100  # calls per timing window
PLAIN_CALLS = 20  # the integer plain versions are slow
RAGGED_MATMUL = (3, 1001, 777, 19)  # B, N, K, M: no multiple of any tile
# all -1 operands: K around K_CHUNK = 4096 at small N, M (and K = 5000 with
# rows enough that k_slice keeps all of K in one block, all_ones_check)
ALL_ONES_MATMULS = ((1, 33, 4096, 5), (1, 33, 4097, 5), (2, 70, 5000, 19))
# the SpMM edge cases: a hub row above 1024 entries, and rows one below, at
# and one above 4, 8, 16 and 32 entries (a row's batch in csrc/spmm.cu is
# kBatch x slots: 8 as shipped, 4 to 16 in the variants sweep_spmm builds);
# widths from 1 to past one 32-lane chunk of 16-byte loads, and the cells'
# input widths, which the unopt layer-0 aggregation runs at (column chunks
# of 32 lanes: f32 4 and 45, ring 8 and 45)
EDGE_DEGREES = (3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 1500)
EDGE_WIDTHS = (1, 3, 7, 16, 33, 64, 500, 1433)
EDGE_N_SRC = 3001
# K5's edge cases: every D from 1 to 64 (1 to 16 lanes an edge, float4 and
# scalar loads, one chunk and more); edge counts of 0, 1, and one below, at
# and one above every power of two to 1024 (a lane group's batch of 4
# edges, a warp's 32 / lanes x 4 and a block's 4 warps at every lane count,
# and the sweep's batches of 1, 2 and 8), and SDDMM_EDGES; n_src != n_dst
SDDMM_WIDTHS = range(1, 65)
SDDMM_EDGES = 5003
SDDMM_EDGE_COUNTS = (0, 1) + tuple(sorted(
    {(1 << i) + k for i in range(1, 11) for k in (-1, 0, 1)} - {1})) + (
        SDDMM_EDGES,)
SDDMM_N_SRC, SDDMM_N_DST = 1001, 700

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


def with_repeats(spmm):
    """An Spmm at ``spmm``'s shape over its edges with the first quarter
    appended twice more: those entries get counts of 3 (the synthetic
    graphs have no repeated edge), and the padding rows stay empty."""
    from cognn_tpu_torch.ops.spmm import Spmm

    src, dst = spmm.edge_list()
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


def edge_graph():
    """Edges for :func:`edge_case_check`: EDGE_N_SRC sources (odd, so the
    ring's share 1 starts misaligned at odd D) into one destination row for
    each of EDGE_DEGREES, the first and the last row and one in the middle
    empty; the hub's first 100 edges and every row's first edge repeated
    (counts of 2 and 3)."""
    rng = np.random.default_rng(7)
    degrees = (0,) + EDGE_DEGREES[:len(EDGE_DEGREES) // 2] + (0,) + \
        EDGE_DEGREES[len(EDGE_DEGREES) // 2:] + (0,)
    src, dst = [], []
    for row, deg in enumerate(degrees):
        s = rng.choice(EDGE_N_SRC, deg, replace=False)
        s = np.concatenate([s, s[:1], s[:100 if deg >= 1024 else 0]])
        src.append(s)
        dst.append(np.full(len(s), row))
    return np.concatenate(src), np.concatenate(dst), len(degrees)


def offset_view(values: torch.Tensor, offset: int) -> torch.Tensor:
    """``values`` copied into a fresh storage ``offset`` elements in: a
    contiguous view whose data pointer is no longer 16-byte aligned."""
    buf = torch.empty(values.numel() + offset, dtype=values.dtype,
                      device=values.device)
    buf[offset:] = values.flatten()
    return buf[offset:].view(values.shape)


def edge_case_check() -> None:
    """Both SpMM kernels on :func:`edge_graph`'s rows (a hub of in-degree
    EDGE_DEGREES[-1]; rows one below, at and one above every batch size of
    4, 8, 16, 32; empty first, middle and last rows) at each width of
    EDGE_WIDTHS, and once more with ``h`` one element into its storage,
    which must take the scalar path. The ring kernel is held to its plain
    version with ``torch.equal`` on random full-range int64 shares. The
    f32 kernel's gate is its plain version (KERNEL_TOL) on integer-valued
    rows, whose sums are exact in f32 in any order, so a wrong entry shows
    at any degree (on normal rows two orders of the hub's 1500 terms differ
    by more than 1e-5 where they cancel). Beside it runs a rounding sanity
    check, not a gate for a wrong entry at the hub (its slack there is
    ~1.8e-4 of sum |h|): on standard normal rows the f32 sum must lie
    within gamma_n * sum |count * h| of the float64 sum, gamma_n =
    n u / (1 - n u), u = 2^-24, n = 2 roundings (product and add) for each
    entry of the row."""
    from cognn_tpu_torch.core.ring import ring_from_u64
    from cognn_tpu_torch.ops.spmm import Spmm, launch_shape, spmm_plain

    src, dst, n_dst = edge_graph()
    k = Spmm(src, dst, EDGE_N_SRC, n_dst, "cuda")
    empty = (k.indptr.diff() == 0).nonzero().flatten().tolist()
    if empty != [0, 1 + len(EDGE_DEGREES) // 2, n_dst - 1] or \
            k.counts.max().item() < 3:
        raise AssertionError(f"edge graph: empty rows {empty}, max count "
                             f"{k.counts.max().item()}")
    nu = 2 * k.indptr.diff().double()[:, None] * 2.0 ** -24
    gamma = nu / (1 - nu)
    counts64 = k.counts.double()
    rng = np.random.default_rng(8)
    for D, offset in [(D, 0) for D in EDGE_WIDTHS] + [(16, 1), (7, 1)]:
        h = offset_view(torch.from_numpy(rng.integers(
            -8, 9, (EDGE_N_SRC, D)).astype(np.float32)).cuda(), offset)
        hn = offset_view(torch.from_numpy(rng.standard_normal(
            (EDGE_N_SRC, D), dtype=np.float32)).cuda(), offset)
        hr = offset_view(ring_from_u64(rng.integers(
            0, 1 << 64, (2, EDGE_N_SRC, D), dtype=np.uint64), device="cuda"),
            offset)
        # the path the wrappers take (their outputs come from the allocator,
        # 16-byte aligned)
        path = launch_shape(D, 4, (h.data_ptr(),))
        ring_path = launch_shape(D, 8, (hr.data_ptr(),),
                                 (EDGE_N_SRC * D, n_dst * D))
        if offset and (path[0], ring_path[0]) != (1, 1):
            raise AssertionError(f"offset view D={D} takes a vector path")
        launches = (k.launches, k.ring_launches)
        err = held(f"edge cases D={D} offset={offset}", k(h),
                   spmm_plain(k.indptr, k.indices, k.counts, h), KERNEL_TOL)
        held(f"ring edge cases D={D} offset={offset}", k.ring(hr),
             spmm_plain(k.indptr, k.indices, k.counts_i64, hr), None)
        exact = spmm_plain(k.indptr, k.indices, counts64, hn.double())
        bound = gamma * spmm_plain(k.indptr, k.indices, counts64,
                                   hn.double().abs())
        dev = (k(hn).double() - exact).abs()
        if not (dev <= bound).all():
            raise AssertionError(f"edge cases D={D} offset={offset}: f32 sum "
                                 f"off the float64 one beyond the rounding "
                                 f"bound (sanity check), by "
                                 f"{(dev - bound).max().item()}")
        if (k.launches, k.ring_launches) != (launches[0] + 2,
                                             launches[1] + 1):
            raise AssertionError("edge cases: a kernel did not launch")
        print(f"edge cases D={D} h offset={offset} element(s): nnz={k.nnz} "
              f"degrees={list(EDGE_DEGREES)} f32 (vec, lanes)={path} "
              f"max_abs_err={err!r} (integer rows, the check), normal rows "
              f"max|f32 - f64|={dev.max().item()!r}, at most "
              f"{(dev / bound.clamp_min(1e-30)).max().item()!r} of its "
              f"rounding bound (sanity check); ring (vec, lanes)={ring_path} "
              f"equal to plain (max_abs_err 0)", flush=True)


def sddmm_edges():
    """SDDMM_EDGES edges from SDDMM_N_SRC sources to SDDMM_N_DST
    destinations: the first three touch the last source row, the last
    destination row or both; every fourth edge from the fourth on repeats
    an earlier one (so even 4 edges hold a duplicate)."""
    rng = np.random.default_rng(9)
    src = rng.integers(0, SDDMM_N_SRC, SDDMM_EDGES)
    dst = rng.integers(0, SDDMM_N_DST, SDDMM_EDGES)
    src[:3] = SDDMM_N_SRC - 1, SDDMM_N_SRC - 1, 0
    dst[:3] = SDDMM_N_DST - 1, 0, SDDMM_N_DST - 1
    copies = np.arange(len(src[3::4]))
    src[3::4], dst[3::4] = src[copies].copy(), dst[copies].copy()
    return src, dst


def sddmm_edge_check() -> None:
    """K5 on the first n of :func:`sddmm_edges` for every n of
    SDDMM_EDGE_COUNTS at every D of SDDMM_WIDTHS, and again with ``a`` one
    element into its storage (the scalar path). The gate is integer-valued
    rows, whose f32 dot products are exact in any order: ``torch.equal`` to
    the plain version. On standard normal rows, every D at the full count,
    the kernel is held to SUM_ORDER_TOL."""
    from cognn_tpu_torch.ops.sddmm import Sddmm, launch_shape, sddmm_plain

    src, dst = sddmm_edges()
    ks = [Sddmm(src[:n], dst[:n], SDDMM_N_SRC, SDDMM_N_DST, "cuda")
          for n in SDDMM_EDGE_COUNTS]
    rng = np.random.default_rng(10)
    shapes, worst = set(), 0.0
    for D in SDDMM_WIDTHS:
        a, b = (torch.from_numpy(rng.integers(-8, 9, (n, D)).astype(
            np.float32)).cuda() for n in (SDDMM_N_SRC, SDDMM_N_DST))
        a_off = offset_view(a, 1)
        if launch_shape(D, 4, (a_off.data_ptr(), b.data_ptr()))[0] != 1:
            raise AssertionError(f"sddmm offset view D={D} takes a vector "
                                 "path")
        shapes.add(launch_shape(D, 4, (a.data_ptr(), b.data_ptr())))
        for k in ks:
            launches = k.launches
            for x in (a, a_off):
                held(f"sddmm edge cases D={D} edges={k.n_edges} "
                     f"offset={x is a_off:d}", k(x, b),
                     sddmm_plain(k.src, k.dst, x, b), None)
            if k.launches != launches + 2 * (k.n_edges > 0):
                raise AssertionError(f"sddmm edge cases D={D} edges="
                                     f"{k.n_edges}: the kernel did not "
                                     "launch")
        an, bn = (torch.from_numpy(rng.standard_normal(
            (n, D), dtype=np.float32)).cuda() for n in (SDDMM_N_SRC,
                                                        SDDMM_N_DST))
        worst = max(worst, held(f"sddmm edge cases D={D} normal rows",
                                ks[-1](an, bn),
                                sddmm_plain(ks[-1].src, ks[-1].dst, an, bn),
                                SUM_ORDER_TOL))
    print(f"sddmm edge cases: D={SDDMM_WIDTHS.start}..{SDDMM_WIDTHS.stop - 1} "
          f"x edge counts {list(SDDMM_EDGE_COUNTS)} (n_src={SDDMM_N_SRC}, "
          f"n_dst={SDDMM_N_DST}, last rows, repeats), aligned and a one "
          f"element into its storage: equal to plain on integer rows; "
          f"(vec, lanes) taken {sorted(shapes)}; normal rows max_abs_err="
          f"{worst!r} ({SUM_ORDER_TOL})", flush=True)


def launch_floor() -> None:
    """Device time of a one-element ``zero_``, timed as the kernels are
    (``device_ms``): the part of a µs kernel's time no design removes."""
    x = torch.zeros(1, device="cuda")
    ms = device_ms(x.zero_, TIMED_CALLS)
    print(f"launch_floor_ms={ms!r} (one-element zero_, device_ms over "
          f"{TIMED_CALLS} calls; {card_line()})", flush=True)


def degree_line(cell: str, spmm) -> None:
    """The in-degree profile of ``spmm``'s rows, which sets the CSR
    kernels' batches."""
    deg = spmm.indptr.diff().cpu().numpy()
    print(f"rows {cell}: n={spmm.n_dst} entries={spmm.nnz} mean in-degree="
          f"{deg.mean()!r} max={deg.max()} p99={np.percentile(deg, 99)!r} "
          f"empty={(deg == 0).sum()} max count="
          f"{spmm.counts.max().item()!r} above 32={(deg > 32).sum()}",
          flush=True)


def kernel_phase(cell: str, spmm, dup, widths) -> dict:
    """The f32 SpMM at each width, measured with ``torch.sparse.mm`` as the
    library call; also held against its plain version on
    :func:`with_repeats`' edges (``dup``)."""
    from cognn_tpu_torch.ops.spmm import launch_shape, spmm_plain

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
            path = launch_shape(D, 4, (h.data_ptr(),))
            yield (f"D={D} n={spmm.n_dst} nnz={spmm.nnz} "
                   f"(vec, lanes)={path}",
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
    from cognn_tpu_torch.ops.spmm import launch_shape, spmm_plain

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
            path = launch_shape(D, 8, (h.data_ptr(),),
                                (n_src * D, n_dst * D))
            yield (f"2 shares D={D} n={n_dst} nnz={spmm.nnz} "
                   f"(vec, lanes)={path}",
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
    """K3 at ``shapes`` (B, N, K, M) on random full-range operands,
    measured with ``torch.bmm`` on int64 CUDA tensors as the library call,
    and timed once more with the L2 cold
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
    from cognn_tpu_torch.ops.sddmm import launch_shape, sddmm_plain

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
            path = launch_shape(D, 4, (a.data_ptr(), b.data_ptr()))
            yield (f"D={D} n={k.n_dst} edges={k.n_edges} "
                   f"distinct={len(keys)} (vec, lanes)={path}",
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
    from cognn_tpu_torch.ops import intmatmul, sddmm

    intmatmul.launches = sddmm.launches = 0
    for k in spmms:
        k.launches = k.ring_launches = 0


def read_counts(spmms) -> dict:
    from cognn_tpu_torch.ops import intmatmul, sddmm

    return {"spmm_csr_f32": sum(k.launches for k in spmms),
            "spmm_csr_i64": sum(k.ring_launches for k in spmms),
            "ring_matmul_i64": intmatmul.launches,
            "sddmm_f32": sddmm.launches}


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


def forward_counts(engine) -> dict:
    """Kernel launches of one forward: an aggregation a layer (f32 SpMM, or
    the ring SpMM on shares) less layer 0's where the secret-shared unopt
    engine hoists agg(x0), and on shares a K3 a layer."""
    mpc = hasattr(engine, "weights_sh")
    agg = engine.L - (mpc and engine.unopt and engine.hoist_agg)
    return {"spmm_csr_f32": 0 if mpc else agg,
            "spmm_csr_i64": agg if mpc else 0,
            "ring_matmul_i64": engine.L if mpc else 0, "sddmm_f32": 0}


def forward_phase(cell: str, engine, reference, spmms):
    """The plaintext main path: FORWARDS inference requests, with every
    kernel count set to 0 just before and read just after, which must be
    FORWARDS times :func:`forward_counts`. Returns the counts and the
    logits."""
    reset_counts(spmms)
    (z, prob, metrics), times = timed_forwards(engine)
    counts = read_counts(spmms)

    P, V, C = engine.P, engine.plan.V, engine.param.num_labels
    if tuple(z.shape) != (P, V, C):
        raise AssertionError(f"{cell}: logits shape {tuple(z.shape)}")
    want = {k: FORWARDS * v for k, v in forward_counts(engine).items()}
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
    return counts, z


def n0_fp_check(cell: str, mpc) -> None:
    """The encoded normalizers on the card against the CPU's: the engine's
    own ``n0_fp`` (the host's float64 rsqrt, encoded on the card) and the
    encode of every degree 0..199,999, each against the same encode on the
    CPU. Any difference fails."""
    from cognn_tpu_torch.engine.gas import norm0_host

    enc = mpc.proto.encode_public
    for name, deg in (("cell", mpc.plan.in_deg),
                      ("0..199999", np.arange(200_000, dtype=np.float32))):
        host = torch.from_numpy(norm0_host(deg))
        got = (mpc.n0_fp if name == "cell" else enc(host.cuda())).cpu()
        diff = got - enc(host)
        print(f"n0_fp {cell} {name}: {(diff != 0).sum().item()} of "
              f"{diff.numel()} differ card vs CPU", flush=True)
        if (diff != 0).any():
            raise AssertionError(f"{cell}: n0_fp card vs CPU off by "
                                 f"{diff.abs().max().item()}")


def mpc_forward_phase(cell: str, mpc, mpc_sparse, z_plain, spmms) -> dict:
    """The secret-shared main path: FORWARDS inference requests, with every
    kernel count set to 0 just before and read just after, which must be
    FORWARDS times :func:`forward_counts`. The logits must equal
    ``mpc_sparse``'s. Returns the counts."""
    reset_counts(spmms)
    torch.cuda.reset_peak_memory_stats()
    (z, prob, metrics), times = timed_forwards(mpc)
    counts = read_counts(spmms)
    peak = torch.cuda.max_memory_allocated()

    P, V, C = mpc.P, mpc.plan.V, mpc.param.num_labels
    if tuple(z.shape) != (P, V, C) or z.dtype != torch.float32:
        raise AssertionError(f"{cell}: mpc logits {z.dtype} "
                             f"{tuple(z.shape)}")
    want = {k: FORWARDS * v for k, v in forward_counts(mpc).items()}
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


def profile_phase(label: str, fn) -> None:
    """Where one call of ``fn`` (a request, an epoch) spends its time: the
    device time of every kernel and copy (torch.profiler, CUPTI) against
    the call's wall time, which the profiler itself inflates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"profile {label}: wall_ms={wall_ms!r} device_busy_ms={busy_ms!r} "
          f"device_ops={sum(n for n, _ in by_name.values())} "
          f"idle_share={1 - busy_ms / wall_ms!r}", flush=True)
    for name, (n, us) in top:
        print(f"  {us / 1e3!r} ms x{n} {name[:110]}", flush=True)


def epoch_counts(engine) -> dict:
    """Kernel launches of one training epoch of the engine's L layers.
    Aggregations: opt, L forward and 2L backward phases less the two
    Apply-only ones (phase % L == 0); unopt, L forward and L - 1 between
    the backward layers, less layer 0's where the secret-shared engine
    hoists agg(x0). Secret-shared share matmuls (K3): L forward, L - 1
    delta @ W^T (the engines skip layer 0's, which nothing reads), L weight
    gradients."""
    L, mpc = engine.L, hasattr(engine, "weights_sh")
    if engine.unopt:
        agg = 2 * L - 1 - (mpc and engine.hoist_agg)
    else:
        agg = 3 * L - 2
    return {"spmm_csr_f32": 0 if mpc else agg,
            "spmm_csr_i64": agg if mpc else 0,
            "ring_matmul_i64": 3 * L - 1 if mpc else 0, "sddmm_f32": 0}


def train_shapes(parties: int, V: int, dims) -> list:
    """(B, N, K, M) of the secret-shared epoch's K3 launches that its
    forward does not make, in the order they run: delta @ W^T for layers
    L-1..1, then the weight gradients h_in^T @ delta for layers L-1..0
    (layer 0's on the prepped x0^T)."""
    dims = [int(d) for d in dims]
    L = len(dims) - 1
    return ([(parties, V, dims[l + 1], dims[l]) for l in range(L - 1, 0, -1)]
            + [(parties, dims[l], V, dims[l + 1])
               for l in range(L - 1, -1, -1)])


def weights_of(engine) -> list:
    """The engine's (revealed) weights, one [P, d_in, d_out] per layer."""
    if hasattr(engine, "weights_sh"):
        return engine.reveal_weights()
    return list(engine.weights)


def train_phase(label: str, engine, reference, spmms, plain_weights=None):
    """The training main path: EPOCHS_CHECKED epochs of ``engine`` (kernel
    path) with every kernel count set to 0 just before and read just after,
    which must be EPOCHS_CHECKED times :func:`epoch_counts`; then the same
    epochs of ``reference`` (``sparse``, built alike). Secret-shared: the
    revealed weights and every epoch's metrics ``torch.equal`` to the
    reference's, and the weights within MPC_WEIGHTS_TOL of
    ``plain_weights`` (the plaintext port's after the same epochs);
    plaintext: weights within TRAIN_WEIGHTS_TOL_OF_MAX of the reference's
    largest. Returns the counts, the revealed weights and the metrics."""
    mpc = plain_weights is not None
    want = {k: EPOCHS_CHECKED * v for k, v in epoch_counts(engine).items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(spmms)
    metrics = engine.run_epochs_scan(EPOCHS_CHECKED)
    counts = read_counts(spmms)
    peak = torch.cuda.max_memory_allocated()
    if counts != want:
        raise AssertionError(f"{label}: kernel launches {counts} in "
                             f"{EPOCHS_CHECKED} epochs of {engine.L} layers, "
                             f"want {want}")
    m_ref = reference.run_epochs_scan(EPOCHS_CHECKED)
    w, w_ref = weights_of(engine), weights_of(reference)
    m = check_metrics(label, engine, metrics)
    if mpc:
        for k in metrics:
            if not torch.equal(metrics[k], m_ref[k]):
                raise AssertionError(f"{label}: metric {k} differs from the "
                                     "sparse path")
        if not all(torch.equal(a, b) for a, b in zip(w, w_ref)):
            raise AssertionError(f"{label}: weights differ from the sparse "
                                 "path")
        err = max((a - b).abs().max().item()
                  for a, b in zip(w, plain_weights))
        if not err <= MPC_WEIGHTS_TOL:
            raise AssertionError(f"{label}: weights {err} from the "
                                 f"plaintext port's, tolerance "
                                 f"{MPC_WEIGHTS_TOL}")
        held_line = (f"weights and metrics equal to sparse; max|W - "
                     f"W_plain|={err!r} (tol {MPC_WEIGHTS_TOL})")
    else:
        err = max((a - b).abs().max().item() for a, b in zip(w, w_ref))
        tol = TRAIN_WEIGHTS_TOL_OF_MAX * max(b.abs().max().item()
                                             for b in w_ref)
        if not err <= tol:
            raise AssertionError(f"{label}: weights {err} from the sparse "
                                 f"path, tolerance {tol}")
        held_line = f"max|W - W_sparse|={err!r} (tol {tol!r})"
    print(f"train {label}: {EPOCHS_CHECKED} epochs, launches={counts} "
          f"{held_line}; peak device memory {peak} B ({resident} B resident "
          f"before) loss={m['loss'].tolist()}", flush=True)
    return counts, w, metrics


def time_epochs(label: str, engine, n_edges: int,
                epochs: int = EPOCHS_TIMED) -> None:
    """``epochs`` epochs through ``run_epochs`` and again through
    ``run_epochs_scan``, each ending in ``torch.cuda.synchronize()``: ms an
    epoch and edge-iterations/s (``bench.py``'s definition: epoch_layers x
    edges / s an epoch)."""
    for name in ("run_epochs", "run_epochs_scan"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(engine, name)(epochs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / epochs
        print(f"epoch {label} {name}({epochs}): ms_per_epoch={ms!r} "
              f"edge_iters_per_s={engine.epoch_layers * n_edges / ms * 1e3!r}"
              f" (epoch_layers {engine.epoch_layers}, edges {n_edges})",
              flush=True)


def accuracy_phase(cell: str, plan, param, variant: str = "opt") -> None:
    """ACCURACY_EPOCHS epochs of ``run_epochs_scan`` from fresh kernel-path
    engines of ``variant``, plaintext and secret-shared (unopt: hoisted).
    Fails unless the loss (mean over
    parties) falls from the first epoch to the last in both, and the two
    final test accuracies (mean over parties) agree within ACC_AGREE.
    Prints each beside its row of results/matrix/SUMMARY.md (the JAX
    package's 90-epoch run at the same settings: test accuracy the mean over
    parties, loss the last party's, as tools/summarize_matrix.py reads its
    logs), which is not a gate."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.mpc import MpcGasEngine

    final = {}
    for mpc in (False, True):
        label = " ".join([cell] + ["unopt"] * (variant == "unopt")
                         + ["mpc"] * mpc)
        engine = (MpcGasEngine if mpc else GasEngine)(plan, param, variant,
                                                      device="cuda")
        t0 = time.perf_counter()
        m = engine.metrics_host(engine.run_epochs_scan(ACCURACY_EPOCHS))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        loss = m["loss"].mean(0).tolist()
        acc = m["test_acc"].mean(0).tolist()
        last_loss = float(m["loss"][-1, -1])
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise AssertionError(f"accuracy {label}: loss {loss[0]!r} at "
                                 f"epoch 1, {loss[-1]!r} at epoch "
                                 f"{ACCURACY_EPOCHS}")
        final[mpc] = acc[-1]
        row, row_loss, row_acc = MATRIX_ROWS[cell, mpc, variant]
        print(f"accuracy {label}: {ACCURACY_EPOCHS} epochs in {s!r} s; "
              f"loss {loss[0]!r} -> {loss[-1]!r}, test_acc {acc[0]!r} -> "
              f"{acc[-1]!r} (per party {m['test_acc'][:, -1].tolist()}, "
              f"train_acc {float(m['train_acc'][:, -1].mean())!r}), last "
              f"party's loss {last_loss!r}; results/matrix/SUMMARY.md {row}: "
              f"loss {row_loss}, test_acc {row_acc} (test_acc "
              f"{acc[-1] - row_acc:+.5f}, last party's loss "
              f"{last_loss - row_loss:+.5f} from it)",
              flush=True)
    if not abs(final[True] - final[False]) <= ACC_AGREE:
        raise AssertionError(f"accuracy {cell} {variant}: secret-shared "
                             f"test_acc {final[True]!r}, plaintext "
                             f"{final[False]!r}, more than {ACC_AGREE} "
                             "apart")


def integer_rows_check(cell: str, spmm, dup, D: int) -> None:
    """The f32 SpMM ``torch.equal`` to its plain version on integer-valued
    rows of width ``D`` (their sums are exact in f32 in any order), on the
    cell's CSR ``spmm`` and on :func:`with_repeats`' edges ``dup``."""
    from cognn_tpu_torch.ops.spmm import spmm_plain

    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.integers(-8, 9, (spmm.n_src, D)).astype(
        np.float32)).cuda()
    for what, k in (("", spmm), (" repeated edges", dup)):
        held(f"kernel {cell} D={D}{what} integer rows", k(h),
             spmm_plain(k.indptr, k.indices, k.counts, h), None)
    print(f"kernel {cell} D={D}: equal to plain on integer-valued rows, on "
          f"the cell's edges and on repeated edges", flush=True)


def unopt_forward_phase(cell: str, plan, param, spmms) -> dict:
    """The unopt inference path (``variant="unopt_inference"``, CoGNN):
    FORWARDS requests of the plaintext engine (held to ``sparse`` as in
    :func:`forward_phase`), then of the secret-shared engine hoisted and not
    hoisted (:func:`mpc_forward_phase`: each ``torch.equal`` to the hoisted
    ``sparse`` engine's logits, so to each other, and within
    MPC_LOGITS_TOL of the plaintext port's), every kernel count set to 0
    just before each and read just after; one more request of each
    profiled. Returns the counts by engine."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.mpc import MpcGasEngine

    variant = "unopt_inference"
    plain, plain_sparse = (GasEngine(plan, param, variant, aggregation=agg,
                                     device="cuda")
                           for agg in ("auto", "sparse"))
    mpc = {label: MpcGasEngine(plan, param, variant, hoist_agg=hoist,
                               device="cuda")
           for label, hoist in (("hoisted", True), ("not hoisted", False))}
    mpc_sparse = MpcGasEngine(plan, param, variant, aggregation="sparse",
                              device="cuda")
    spmms = spmms + (plain.spmm, *(e.spmm for e in mpc.values()))
    counts = {}
    counts["plaintext"], z_plain = forward_phase(f"{cell} unopt", plain,
                                                 plain_sparse, spmms)
    profile_phase(f"{cell} unopt", plain.forward)
    for label, engine in mpc.items():
        counts[label] = mpc_forward_phase(f"{cell} unopt mpc {label}",
                                          engine, mpc_sparse, z_plain, spmms)
        profile_phase(f"{cell} unopt mpc {label}", engine.forward)
    return counts


def unopt_train_phase(cell: str, plan, param, spmms, n_edges: int) -> dict:
    """The unopt training path (``variant="unopt"``, fresh engines):
    :func:`train_phase` for the plaintext engine, then the secret-shared
    engine hoisted and not hoisted, each beside its ``sparse`` twin; the
    hoisted and the not hoisted engines' revealed weights and metrics must
    be ``torch.equal``. Then EPOCHS_TIMED_UNOPT epochs of each kernel-path
    engine timed (:func:`time_epochs`) and one profiled. Returns the counts
    by engine."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.mpc import MpcGasEngine

    pairs = {"plaintext": tuple(
        GasEngine(plan, param, "unopt", aggregation=agg, device="cuda")
        for agg in ("auto", "sparse"))}
    for label, hoist in (("hoisted", True), ("not hoisted", False)):
        pairs[label] = tuple(
            MpcGasEngine(plan, param, "unopt", aggregation=agg,
                         hoist_agg=hoist, device="cuda")
            for agg in ("auto", "sparse"))
    spmms = spmms + tuple(pair[0].spmm for pair in pairs.values())
    counts, trained = {}, {}
    counts["plaintext"], w_plain, _ = train_phase(
        f"{cell} unopt", *pairs["plaintext"], spmms)
    for label in ("hoisted", "not hoisted"):
        counts[label], *trained[label] = train_phase(
            f"{cell} unopt mpc {label}", *pairs[label], spmms, w_plain)
    (w_h, m_h), (w_n, m_n) = trained["hoisted"], trained["not hoisted"]
    if not (all(torch.equal(a, b) for a, b in zip(w_h, w_n))
            and all(torch.equal(m_h[k], m_n[k]) for k in m_h)):
        raise AssertionError(f"{cell} unopt: hoisted and not hoisted "
                             "epochs reveal different weights or metrics")
    print(f"train {cell} unopt mpc: hoisted and not hoisted revealed "
          f"weights and metrics equal after {EPOCHS_CHECKED} epochs",
          flush=True)
    for label, (engine, _) in pairs.items():
        name = f"{cell} unopt" + (f" mpc {label}" if label != "plaintext"
                                  else "")
        time_epochs(name, engine, n_edges, EPOCHS_TIMED_UNOPT)
        profile_phase(f"{name} epoch", engine.run_epoch)
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs "
                 "on a GPU")
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.harness.datasets import party_plan
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
    edge_case_check()
    sddmm_edge_check()
    launch_floor()

    kernels = []
    for cell, dataset, parties, replaces, jax_path in CELLS:
        t0 = time.perf_counter()
        plan, param = party_plan(dataset, parties)
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
        degree_line(cell, engine.spmm)
        spmms = (engine.spmm, mpc.spmm, dup)
        f32 = kernel_phase(cell, engine.spmm, dup, widths)
        ring = ring_spmm_phase(cell, mpc.spmm, dup, widths, mac_ms)
        shapes = [(parties, plan.V, dims[l], dims[l + 1]) for l in range(L)]
        k3 = ring_matmul_phase(cell, shapes)

        f32_counts, z_plain = forward_phase(cell, engine, reference, spmms)
        profile_phase(cell, engine.forward)
        n0_fp_check(cell, mpc)
        counts = mpc_forward_phase(cell, mpc, mpc_sparse, z_plain, spmms)
        profile_phase(f"{cell} mpc", mpc.forward)
        n_src, n_dst = engine.spmm.n_src, engine.spmm.n_dst
        src, dst = engine.spmm.edge_list()
        merged_phase(cell, SpmmMerged(src, dst, n_src, n_dst, "cuda"), widths,
                     SpmmMerged(*dup.edge_list(), n_src, n_dst, "cuda"))
        k5 = Sddmm(src, dst, n_src, n_dst, "cuda")
        sddmm = sddmm_phase(cell, k5, random_operands(k5, widths, 5))

        # the training main path: kernel engine and sparse reference,
        # plaintext (False) and secret-shared (True), built fresh
        train = {mpc: tuple((MpcGasEngine if mpc else GasEngine)(
            plan, param, "opt", aggregation=agg, device="cuda")
            for agg in ("auto", "sparse")) for mpc in (False, True)}
        train_spmms = spmms + (train[False][0].spmm, train[True][0].spmm)
        n_edges = int(plan.loc_valid.sum() + plan.rem_valid.sum())
        f32_train, w_plain, _ = train_phase(cell, *train[False],
                                            train_spmms)
        time_epochs(cell, train[False][0], n_edges)
        profile_phase(f"{cell} epoch", train[False][0].run_epoch)
        mpc_train, _, _ = train_phase(f"{cell} mpc", *train[True],
                                      train_spmms, w_plain)
        time_epochs(f"{cell} mpc", train[True][0], n_edges)
        profile_phase(f"{cell} mpc epoch", train[True][0].run_epoch)
        del train
        k3_shapes = train_shapes(parties, plan.V, dims)
        k3_train = ring_matmul_phase(f"{cell} train", k3_shapes)
        accuracy_phase(cell, plan, param)

        # the unopt path (CoGNN): layer 0 aggregates at the input width
        unopt_widths = dims[:2]  # one unopt forward's aggregations
        integer_rows_check(cell, engine.spmm, dup, dims[0])
        f32_unopt = kernel_phase(f"{cell} unopt", engine.spmm, dup,
                                 unopt_widths)
        ring_unopt = ring_spmm_phase(f"{cell} unopt", mpc.spmm, dup,
                                     unopt_widths, mac_ms)
        unopt_fwd = unopt_forward_phase(cell, plan, param, spmms)
        unopt_train = unopt_train_phase(cell, plan, param, spmms, n_edges)
        accuracy_phase(cell, plan, param, "unopt")

        csr = f"n={engine.spmm.n_dst}, nnz={engine.spmm.nnz}"
        kernels += [{
            "name": f"spmm_csr_f32[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": jax_path,
            "launches": f32_counts["spmm_csr_f32"],
            "training_launches": f32_train["spmm_csr_f32"],
            "launches_per_epoch": f32_train["spmm_csr_f32"] // EPOCHS_CHECKED,
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
            "training_launches": mpc_train["spmm_csr_i64"],
            "launches_per_epoch": mpc_train["spmm_csr_i64"] // EPOCHS_CHECKED,
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
            "training_launches": mpc_train["ring_matmul_i64"],
            "launches_per_epoch": mpc_train["ring_matmul_i64"]
            // EPOCHS_CHECKED,
            "shape": "one secret-shared forward: " + ", ".join(
                f"[{b},{n},{k}]@[{b},{k},{m}]" for b, n, k, m in shapes),
            **k3,
        }, {
            "name": f"ring_matmul_i64[{cell} train]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
            "replaces": RING_MATMUL_REPLACES,
            "jax_path": RING_MATMUL_JAX_PATH,
            "launches": mpc_train["ring_matmul_i64"],
            "launches_per_epoch": mpc_train["ring_matmul_i64"]
            // EPOCHS_CHECKED,
            "shape": "the secret-shared epoch's backward shapes, "
                     f"{len(k3_shapes)} of its "
                     f"{mpc_train['ring_matmul_i64'] // EPOCHS_CHECKED} "
                     "launches an epoch (launches: all of them in "
                     f"{EPOCHS_CHECKED} epochs): " + ", ".join(
                         f"[{b},{n},{k}]@[{b},{k},{m}]"
                         for b, n, k, m in k3_shapes),
            **k3_train,
        }, {
            "name": f"sddmm_f32[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/sddmm.cu",
            "replaces": SDDMM_REPLACES,
            "jax_path": "shape only: no engine launches K5",
            "launches": f32_counts["sddmm_f32"] + counts["sddmm_f32"],
            "shape": f"scores of the cell's {k5.n_edges} flat edges "
                     f"(destination-major), D in {list(widths)}, random "
                     f"rows; sampled_addmm on the same edges",
            **sddmm,
        }, {
            "name": f"spmm_csr_f32[{cell} unopt]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": f"{jax_path}; unopt: layer 0 at the input width",
            "launches": unopt_fwd["plaintext"]["spmm_csr_f32"],
            "training_launches": unopt_train["plaintext"]["spmm_csr_f32"],
            "launches_per_epoch": unopt_train["plaintext"]["spmm_csr_f32"]
            // EPOCHS_CHECKED,
            "shape": f"one unopt forward: D in {list(unopt_widths)}, {csr}",
            **f32_unopt,
        }, {
            "name": f"spmm_csr_i64[{cell} unopt]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": f"share instantiation (_bcsr_agg_shares, "
                        f"cognn_tpu/mpc/engine.py:269): {jax_path}; unopt: "
                        f"layer 0 at the input width",
            "launches": unopt_fwd["not hoisted"]["spmm_csr_i64"],
            "hoisted_launches": unopt_fwd["hoisted"]["spmm_csr_i64"],
            "training_launches": unopt_train["not hoisted"]["spmm_csr_i64"],
            "launches_per_epoch": unopt_train["not hoisted"]["spmm_csr_i64"]
            // EPOCHS_CHECKED,
            "hoisted_launches_per_epoch":
                unopt_train["hoisted"]["spmm_csr_i64"] // EPOCHS_CHECKED,
            "shape": f"one secret-shared unopt forward without the hoist: "
                     f"2 shares, D in {list(unopt_widths)}, {csr}; hoisted "
                     f"D = {dims[1]} only (agg(x0) once, when the state is "
                     f"installed)",
            **ring_unopt,
        }, {
            "name": f"ring_matmul_i64[{cell} unopt]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
            "replaces": RING_MATMUL_REPLACES,
            "jax_path": RING_MATMUL_JAX_PATH,
            "launches": unopt_fwd["hoisted"]["ring_matmul_i64"],
            "not_hoisted_launches": unopt_fwd["not hoisted"][
                "ring_matmul_i64"],
            "training_launches": unopt_train["hoisted"]["ring_matmul_i64"],
            "launches_per_epoch": unopt_train["hoisted"]["ring_matmul_i64"]
            // EPOCHS_CHECKED,
            "shape": "one secret-shared unopt forward, hoisted or not: "
                     + ", ".join(f"[{b},{n},{k}]@[{b},{k},{m}]"
                                 for b, n, k, m in shapes)
                     + " (layer 0's A side agg(x0)); the opt forward's "
                     "shapes, timed once for both",
            **k3,
        }]

    case, bench_counts = bench_phase()
    full_tile_check()
    v, d = case.v, case.h.shape[1]
    csr = kernel_phase("bench", case.spmm, with_repeats(case.spmm), (d,))
    k4 = merged_phase("bench", case.merged, (d,))
    k5 = sddmm_phase("bench", case.sddmm, [(case.h, case.h)])
    bench_shape = (f"the tool's graph: V={v} E={len(case.src)} band 2048 "
                   f"({case.spmm.nnz} distinct edges), D={d}")
    kernels += [{
        "name": "spmm_csr_f32[bench]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/spmm.cu",
        "replaces": "cognn_tpu/ops/pallas_spmm.py:27",
        "jax_path": "tools/bench_spmm.py:104-119, 186 (PallasSpmm)",
        "launches": bench_counts["spmm_csr_f32"],
        "shape": f"{bench_shape}, random rows",
        **csr,
    }, {
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
