"""Smoke run of the PyTorch/CUDA port (``cognn_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine
    python3 chip_smoke.py --sharded  # steps 1, 2 and 12 only: the sharded
                                     # parties, over NCCL too on a host
                                     # with a card a party

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel from ``cognn_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints the time and the compiler's
   register counts.
3. Checks once that int64 and int32 ``+``, ``-``, ``*``, ``sum`` and
   ``index_add_`` on the card wrap like numpy uint64 (the plain versions,
   the share arithmetic and the ``sparse`` backend of both rings rely on
   it).
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

10. Drives the dense backend on cora_2p (``dense_phase``; pubmed_4p's
   dense matrix exceeds the plan's budget): plaintext opt and unopt
   requests held to ``sparse`` as in step 5 and 2 epochs as in step 7 (no
   SpMM launched); secret-shared opt, unopt hoisted and not hoisted, each
   ``torch.equal`` to ``sparse`` in logits, weights and metrics, an
   aggregation one K3 launch (a forward 4 K3 opt, 3 hoisted, 4 not; an
   epoch 9, 7, 8; building the hoisted engine 1, agg(x0)); request and
   epoch ms and device busy of dense beside the CSR kernel's; the dense
   f32 product and K3 at ``[1, n, n] @ [1, n, 2·D]`` (the real Aᵀ,
   full-range B, ``torch.equal``, warm and cold) beside the CSR kernels at
   D = 16, 7, 1433: the numbers behind ``auto``, whose decision for each
   cell and engine is printed (``auto_phase``) and held to what the
   engines took.
11. Drives the CLI, ``python -m cognn_tpu_torch.harness.run_party``, in
   subprocesses on files written by the port's ``transform`` (synthetic
   Cora, 2 parties, and PubMed, 4): opt, opt --reorder, --mpc, --variant
   ss, inference, --mpc inference, --mpc --aggregation dense, a
   checkpointed run and its -n resume, PubMed --mpc (``cli_phase``); each
   gated as its docstring says and its spans printed; then the CLI's
   multi-process mode, ``--mode sharded`` and ``-c --mpc``
   (``sharded_cli_phase``).
12. Drives the sharded mode of each cell before step 11 (``sharded_phase``):
   P party processes of this script on the card, one process a party, the
   collectives over gloo through host copies, and over NCCL as well where
   the host has a card a party. Each party builds its engines (plaintext
   opt and unopt, secret-shared opt and unopt hoisted; the dense
   secret-shared forward on the dense cell) twice from the same seeds,
   graphed (the default: CUDA graphs split at the collectives) and eager,
   and holds graphed to eager ``torch.equal`` (logits, every epoch's
   metrics, weights and share bits), with equal launch counts, collective
   calls and bytes, generator offsets, and one graph more a step than its
   collectives; both hold their kernel and collective counts a forward
   and an epoch; requests and epochs are timed graphed and eager in turns,
   one epoch of each profiled on party 0 (the host's launch calls), the
   collectives' ms synchronized. The gathered graphed results are held to
   the stacked engines built here (plaintext within LOGITS_TOL_OF_MAX and
   TRAIN_WEIGHTS_TOL_OF_MAX of the largest, losses within
   SHARDED_LOSS_TOL, accuracies equal; secret-shared reveals and metrics
   ``torch.equal``), and the int64 collectives must wrap like numpy
   uint64. Then the CSR kernels at a party's shape (V sources, P·V
   destinations), K3 at the sharded dense shape and at a party's batch-1
   share matmuls are held and timed as in step 4 (``[cell party]`` on the
   kernels line, launches from party 0's counted forward and epochs).
   Each counted part's bytes a party, by collective, must equal the comm
   model's (``engine/comm_model.py`` ``analytic_bytes_per_epoch``), and
   int32 ``all_reduce`` / ``all_to_all`` must wrap too; party 0's bytes
   and rounds an epoch are printed with the model's duration grid over
   the reference's networks, the stacked engine's ms an epoch as compute
   (``comm_grid``).
13. Drives the vertex analytics on each cell, in its pass after step 10
   (``analytics_phase``): ``AnalyticsEngine`` and ``SSAnalyticsEngine``,
   pagerank PAGERANK_SWEEPS sweeps, bfs, sssp (weights uniform in [0.5, 2)
   from SSSP_WEIGHT_SEED) and cc to their fixpoint, each held to the same
   engine on the CPU (``torch.equal``; plaintext pagerank rtol
   PAGERANK_CPU_RTOL), to a float64 host reference, and secret-shared to
   plaintext at the tests' tolerances; pagerank's counts set to 0 just
   before its run and read just after (one f32 or ring CSR SpMM a sweep).
   Each engine on the card is built graphed (the default, a
   CUDA graph a sweep) and eager, held ``torch.equal`` (secret-shared also
   the shares and the generator offsets, and a run after one with another
   seed; pagerank's ``tol`` stop too), ms a sweep of each in turns, and one
   profiled run of each (busy, idle share, the host's launch calls a
   sweep). The CSR kernels at D = 1 on the kernels line (``[cell
   pagerank]``).
14. Drives the 32-bit ring on each cell after step 13 (``ring32_phase``):
   the int32 ring SpMM and K3 mod 2^32 held ``torch.equal`` and timed at
   the RING32 forward's and epoch's shapes (``spmm_csr_i32``,
   ``ring_matmul_i32`` on the kernels line), ``MpcGasEngine`` at
   ``FixedPointSpec(RING32, 8)``: requests and 2 epochs counted, ``bcsr``
   equal to ``sparse``, the gap to plaintext and request and epoch ms
   beside RING64's; on the dense cell the rates behind ``auto`` for int32
   shares. Step 3's wrap check covers int32 too, and step 11 runs ``--mpc
   --ring-bits 32 --scaler-bits 8``.

15. Holds the engines to the port's float64 oracle (``oracle_phase``,
   each cell after its accuracy runs; ``cognn_tpu_torch/models/oracle.py``,
   plain numpy on the host): CoGNN-Opt and CoGNN (unopt; secret-shared
   hoisted), EPOCHS_CHECKED epochs from the same initial weights and one
   forward; plaintext weights and logits within ORACLE_TOL_OF_MAX of the
   oracle's largest, secret-shared within MPC_WEIGHTS_TOL and
   MPC_LOGITS_TOL.
16. Drives CiteSeer's 3,703-wide layer 0 (``citeseer_phase``, after the
   cells): the counts set to 0 around a secret-shared opt epoch at 3
   parties, a plaintext unopt epoch and a secret-shared unopt forward
   without the hoist at 5, each checked; then K3 at the layer-0 forward and
   weight-gradient shapes and the f32 and ring CSR kernels at D = 3703 held
   and timed as in step 4, warm and cold (``[citeseer_3p]``,
   ``[citeseer_5p unopt]`` on the kernels line). Step 11 also holds the
   native graph reader to the numpy parse on the files it writes and runs
   Cora 2p with ``-t 8``, its ``::graph_load`` beside the run without.
17. Drives the port's evaluation-matrix driver after step 11
   (``matrix_phase``): ``python -m cognn_tpu_torch.tools.run_cluster`` as
   subprocesses on the card (MATRIX_RUNS: the smallest run plaintext and
   secret-shared, FedGNN Cora 2p, secret-shared opt CiteSeer 3p, unopt
   CiteSeer 5p), then ``cognn_tpu_torch.tools.summarize_matrix``: each
   row's test accuracy within MATRIX_ACC_TOL of results/matrix/SUMMARY.md's
   row, its bytes counted in gloo party processes and equal to the
   closed form; us/iter printed beside the card.
18. Drives the experiment tools and the examples after step 17
   (``tools_phase``): ``cognn_tpu_torch.tools.profile_epoch`` on each
   PROFILE_CELLS cell, secret-shared opt (``profile_tool_phase``: the
   counts set to 0 just before PROFILE_REPS traced ``run_epochs_scan(
   PROFILE_SCAN)`` calls and read just after; every CSR SpMM and K3
   launch of the trace attributed to ``oga`` / ``matmul``, as many as the
   wrappers counted; the buckets summing to every device event of the
   trace, nothing unlinked; the phase table, the reference tags and the
   ``<other:...>`` share printed, the breakdown log read back by
   ``tools/log_parse.py``); ``network_model`` on Cora 2p --mpc (opt, unopt;
   the bytes and rounds counted in gloo party processes equal the closed
   form; the grids printed); ``bench_scaling`` on PubMed at 1 and 2
   parties sharing this card over gloo (its NOTE), its JSON printed; the
   three examples at EXAMPLE_EPOCHS epochs.

19. Every engine on ``bcsr`` or ``dense`` (``auto`` takes the CSR kernel
   on both cells) replays each request and epoch as CUDA graphs
   (``cognn_tpu_torch/engine/graphs.py``; sharded, split at the
   collectives), and every analytics sweep as one, so steps 5, 7, 8,
   10, 11, 12, 13, 14, 15, 16 and 17 hold the graphs through their gates
   (launch counts, ``torch.equal`` to ``sparse`` and to the stacked
   engines, the oracle, the 90-epoch accuracy, the CLI's dumps, the
   matrix rows, the comm model's bytes); the ``sparse`` references never
   capture and run eager, as does ``profile_epoch``. ``graph_phase``,
   each
   cell after step 14, holds the graphs against eager engines
   (``cuda_graphs=False``) built from the same seeds (``graph_cases``:
   opt and unopt, plaintext and secret-shared, unopt hoisted, RING32;
   pubmed_4p also not hoisted; cora_2p also ``dense``): FORWARDS requests,
   EPOCHS_CHECKED epochs and one more request, secret-shared logits,
   metrics and revealed weights ``torch.equal``, plaintext within
   LOGITS_TOL_OF_MAX of the largest (whether equal printed); the counts
   of both engines FORWARDS and EPOCHS_CHECKED times ``forward_counts`` /
   ``epoch_counts`` through the replays; the generator's offset after
   every call equal to the eager engine's and growing; results handed out
   earlier unchanged by later calls. Then GRAPH_CALLS_TIMED requests and
   GRAPH_EPOCHS_TIMED epochs timed, graphed and eager in turns, the
   weights held again, one epoch of each profiled (device busy, idle
   share, the host's launch calls: ``cudaLaunchKernel`` against
   ``cudaGraphLaunch``), peak device memory over each engine's build and
   checked calls, and the capture time.
20. Holds the metrics kernel (``csrc/metrics.cu``, ``ops/metrics.py``)
   against its plain version on each cell after step 19
   (``metrics_phase``), every metric ``torch.equal``: at the cell's shape
   with its labels and masks and METRICS_SEEDS random predictions (ties,
   exact zeros), each party alone as a sharded party holds it (on the
   second card where there is one), empty train, test and border sets,
   NaN, infinite and negative probabilities (NaN where the plain version
   has NaN), every C of METRICS_WIDTHS, V of METRICS_ROWS, and the most
   labels the kernel takes (``MAX_CLASSES``; one more is refused); then
   times it (warm L2) beside its plain version and its bound. Step 19
   also counts one metrics kernel a request and an epoch, and holds the
   last request's metrics graphed == eager.
21. Drives the GAT of the benchmark's configuration ``gat2_pubmed_4p_ss``
   after the cells' loop (``gat_phase``; its graph and leaves from seed
   0): the weighted ring SpMM (``csrc/spmm.cu`` ``csr_gather_wsum``) and
   the ring multi-head SDDMM (``csrc/sddmm.cu`` ``edge_dot_heads``) held
   ``torch.equal`` to their plain versions on edge cases
   (``gat_edge_check``) and, forward and transposed, at the cell's shapes
   on random full-range values, int64 and int32, and timed beside their
   bounds; then a graphed GAT engine against an eager one from the same
   seed: each replay launches what an eager epoch launches (the counts
   read from the eager epochs), the weighted SpMM and the SDDMM at least
   once, ``graphs.replays`` one an epoch; losses, leaves and a graphed
   request's logits equal; ms an epoch graphed and eager, peak memory.

The line before the last is one JSON object with each kernel's numbers
(the engines' kernels also with their ``training_launches`` and
``launches_per_epoch``); the
last line is ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is not 0; without a card the script exits 1 before printing a
result.
"""

import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cognn_tpu_torch.utils.timing import HBM_BYTES_PER_S, device_ms

ROOT = Path(__file__).resolve().parent
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
INT8_TC_OPS_PER_S = 1979e12  # H100 SXM dense int8 on the tensor cores
LIMB_PAIRS = 36  # byte-limb products of one 64-bit multiply-add in K3
LIMB_PAIRS_32 = 10  # ... of one 32-bit multiply-add (K3 mod 2^32)
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
# the --reorder dump against the plain one: f32 sums in another order over
# 90 epochs, the bound of tests/test_engine.py:43
REORDER_DUMP_TOL = 5e-4
# the reference's lines every run of the CLI prints (harness.cpp, gcn.h)
CLI_LINES = ("::graph_load took", "::preprocess took", "::iteration took",
             "--------", "cross-entropy-loss = ", "full set accuracy = ",
             "training set accuracy = ", "border training set accuracy = ",
             "test set accuracy = ", "border test set accuracy = ",
             "the number of vertices is", "wrote vertex outputs to")
DENSE_CELL = "cora_2p"  # the cell whose dense operator fits the budget
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
# the TPU kernel JAX's sharded bcsr runs a party, on its V src x P*V dst
# blocks: the one-block K2 on Cora, the supertiled K1 on PubMed
SHARDED_JAX_PATH = {
    "cora_2p": "sharded bcsr: _spmm_call once a party on its V src x P*V "
               "dst blocks (cognn_tpu/engine/gas.py:596-600; "
               "cognn_tpu/mpc/engine.py:975-980)",
    "pubmed_4p": "sharded bcsr: _tiled_call once a party on its V src x "
                 "P*V dst blocks (cognn_tpu/engine/gas.py:573-588; "
                 "cognn_tpu/mpc/engine.py:962-973)",
}
SHARDED_EPOCHS_TIMED = 10  # epochs of a sharded timing window, per party
SHARDED_CALLS_TIMED = 10  # requests of a sharded timing window, per party
# (key, secret-shared, variant, aggregation) of the sharded parties' engines
SHARDED_CASES = (("plain", False, "opt", "bcsr"),
                 ("plain unopt", False, "unopt", "bcsr"),
                 ("mpc", True, "opt", "bcsr"),
                 ("unopt", True, "unopt", "bcsr"),  # hoisted agg(x0)
                 ("dense", True, "opt_inference", "dense"))  # DENSE_CELL
SHARDED_TIMED = ("plain", "mpc", "unopt", "dense")  # timed, graphed and eager
SHARDED_GROUP_TIMEOUT_S = 300  # rendezvous and each collective
SHARDED_RUN_TIMEOUT_S = 600  # a cell's party processes, start to end
# a party's plaintext loss against the stacked engine's party row (f32
# sums in another order; tests/test_torch_sharded.py's tolerance)
SHARDED_LOSS_TOL = 1e-5
# the --mode sharded dump against the stacked one after the same 10 epochs
# (f32 sums in another order; printed at 6 decimals)
SHARDED_DUMP_TOL = 1e-4
RING_MATMUL_REPLACES = "cognn_tpu/ops/intmatmul.py:147"
# the vertex analytics (analytics_phase): pagerank's sweeps, the bound on
# the MIN programs' sweeps to their fixpoint, sssp's weights
PAGERANK_SWEEPS = 20
PAGERANK_TOL = 1e-7  # the tol stop, graphed against eager
SS_OTHER_SEED = 7  # a run between two seed-0 runs of one engine
MAX_SWEEPS = 2000
SSSP_WEIGHT_SEED = 42  # weights uniform in [0.5, 2)
# card vs the same engine on the CPU: pagerank's f32 sums in another order
PAGERANK_CPU_RTOL = 1e-5
# card vs the float64 host reference after PAGERANK_SWEEPS f32 sweeps
PAGERANK_HOST_RTOL = 1e-4
SSSP_HOST_RTOL = 1e-5  # f32 path sums against float64
# secret-shared vs plaintext, tests/test_mpc_analytics.py:72-124 (pagerank
# at 24 fractional bits, the others at 16, clipped at SS_INF)
SS_PAGERANK_FRAC_BITS = 24
SS_ANALYTICS_TOL = {"pagerank": 2e-3, "bfs": 1e-3, "sssp": 2e-3, "cc": 0.0}
RING32_FRAC_BITS = 8  # the 32-bit ring's fractional bits (JAX's tests)
# the engines against the float64 oracle after EPOCHS_CHECKED epochs, as a
# share of the oracle's largest weight or logit (oracle_phase; plaintext
# f32 sums against float64 ones)
ORACLE_TOL_OF_MAX = 1e-4
# the port's evaluation-matrix driver (matrix_phase): each run's arguments
MATRIX_RUNS = (
    ("--smallest-cognn-efficiency", "--fedgnn", "--parties", "2"),
    ("--smallest-cognn-efficiency", "--mpc"),
    ("--cognn-opt-accuracy", "--mpc", "--dataset", "citeseer", "--parties",
     "3"),
    ("--cognn-unopt-accuracy", "--dataset", "citeseer", "--parties", "5"),
)
MATRIX_ACC_TOL = 0.01  # a row's test accuracy against the JAX matrix's
RING_MATMUL_JAX_PATH = ("ring_matmul_small_prepped (24 int8 MXU dots) "
                        "through Protocol.matmul / matmul_prepped, "
                        "cognn_tpu/mpc/protocol.py:129-174")
# the experiment tools (tools_phase): the per-phase breakdown's cells and
# window (run_epochs_scan(PROFILE_SCAN) PROFILE_REPS times, traced), each
# on-path kernel and the bucket all its launches must land in
PROFILE_CELLS = (("cora_2p", "cora", 2), ("pubmed_4p", "pubmed", 4))
PROFILE_SCAN, PROFILE_REPS = 8, 2
# traced windows a cell may take: CUPTI on the card now and then loses
# device records (a window whose trace holds launches without their kernel
# is traced again; the attribution checks run on the first whole one)
PROFILE_ATTEMPTS = 3
PROFILE_KERNELS = (("csr_gather_sum", "oga", "spmm_csr_i64"),
                   ("ring_matmul_u8_mma", "matmul", "ring_matmul_i64"))
SCALING_ARGS = ("--dataset", "pubmed", "--parties", "1", "2", "--epochs",
                "5")
EXAMPLE_EPOCHS = 10
# graph_phase: requests and epochs of a timing window, graphed and eager in
# turns (as many epochs as EPOCHS_TIMED_UNOPT, for the same reason)
GRAPH_CALLS_TIMED = 20
GRAPH_EPOCHS_TIMED = 20
METRICS_SEEDS = (0, 1, 2)  # random predictions a cell's shape
METRICS_WIDTHS = range(2, 65)  # label counts C held at METRICS_C_SHAPE
METRICS_C_SHAPE = (2, 1500)  # (P, V)
# rows a party around the kernel's 8 blocks a party and its tiles of 1024
# rows
METRICS_ROWS = (0, 1, 7, 8, 9, 2047, 2048, 2049, 8191, 8192, 8193, 20000)
METRICS_REPLACES = ("none: the plain ops of cognn_tpu/engine/gas.py "
                    "gcn_metrics, fused by XLA into the jitted forward and "
                    "epoch")
# gat_phase: the benchmark's GAT configuration (its cell
# gat-pubmed4p-ss-train), its graph and leaves from seed 0; the epochs held
# graphed against eager, and timed
GAT_CONFIG = "gat2_pubmed_4p_ss"
GAT_EPOCHS_CHECKED = 3
GAT_EPOCHS_TIMED = 90
GAT_RING32 = (32, 16)  # the int32 engine whose launches the kernels line gives
GAT_RINGED = ("wsum", "sddmm_heads", "ring_matmul")  # counted a ring
# the weighted SpMM's edge cases: (heads, f) (scalar, vector and wide rows,
# a head split across a vector load) on edge_graph's rows
GAT_EDGE_HEADS = ((1, 1), (3, 3), (8, 3), (8, 8), (7, 10), (3, 30))
# the ring SDDMM's: edge counts around its batch of 4 and its 128-thread
# blocks, at (heads, f) as above
GAT_SDDMM_EDGES = (0, 1, 3, 4, 5, 127, 128, 129, 5003)
GAT_REPLACES = ("none: the JAX package has no attention model (its K5, "
                "cognn_tpu/ops/pallas_sddmm.py, was written for one)")


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
    """int64 and int32 ``+``, ``-``, ``*``, ``sum`` (int32's cast back, and
    with ``dtype=``) and ``index_add_`` on the card against numpy uint64
    (masked to 32 bits for int32): the plain versions, the share arithmetic
    and the sparse backend of both rings assume they wrap."""
    from cognn_tpu_torch.core.ring import RING32, RING64, ring_from_u64, \
        ring_to_u64

    rng = np.random.default_rng(5)
    idx = rng.integers(0, 50, 4096)
    for spec in (RING64, RING32):
        mask = np.uint64(spec.mask)
        a = rng.integers(0, 1 << 64, 4096, dtype=np.uint64) & mask
        b = rng.integers(0, 1 << 64, 4096, dtype=np.uint64) & mask
        ta = ring_from_u64(a, spec, device="cuda")
        tb = ring_from_u64(b, spec, device="cuda")
        want_add = np.zeros(50, np.uint64)
        np.add.at(want_add, idx, a)
        got_add = torch.zeros(50, dtype=spec.dtype,
                              device="cuda").index_add_(
            0, torch.from_numpy(idx).cuda(), ta)
        rows = ta.reshape(64, 64)
        checks = {
            "+": (ta + tb, a + b),
            "-": (ta - tb, a - b),
            "*": (ta * tb, a * b),
            "sum": (rows.sum(1).to(spec.dtype), a.reshape(64, 64).sum(1)),
            "sum(dtype=)": (rows.sum(1, dtype=spec.dtype),
                            a.reshape(64, 64).sum(1)),
            "index_add_": (got_add, want_add),
        }
        for name, (got, want) in checks.items():
            if got.dtype != spec.dtype or \
                    not np.array_equal(ring_to_u64(got), want & mask):
                raise AssertionError(f"{spec.dtype} {name} on the card does "
                                     "not wrap like numpy uint64")
        print(f"wrap check: {spec.dtype} {', '.join(checks)} on the card "
              f"equal numpy uint64 mod 2^{spec.bits}", flush=True)


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


def launch_floor() -> float:
    """Device time of a one-element ``zero_``, timed as the kernels are
    (``device_ms``): the part of a µs kernel's time no design removes.
    Returns it (ms)."""
    x = torch.zeros(1, device="cuda")
    ms = device_ms(x.zero_, TIMED_CALLS)
    print(f"launch_floor_ms={ms!r} (one-element zero_, device_ms over "
          f"{TIMED_CALLS} calls; {card_line()})", flush=True)
    return ms


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


def ring_spmm_phase(cell: str, spmm, dup, widths, mac_ms: float,
                    spec=None) -> dict:
    """The ring SpMM on both shares of random full-range rows of the ring
    ``spec`` (RING64 by default, int64; RING32, int32) at each width,
    measured with ``torch.sparse.mm`` on the CSR of the ring's dtype (both
    shares side by side) as the library call; also held against its plain
    version on ``dup``'s edges. ``mac_ms`` is the operation time of one
    multiply-add in the ring (3 IMADs at 64 bits, 1 at 32)."""
    from cognn_tpu_torch.core.ring import RING64, ring_from_u64
    from cognn_tpu_torch.ops.spmm import launch_shape, spmm_plain

    spec = spec or RING64
    e = spec.bits // 8  # bytes of an element and of a count
    rng = np.random.default_rng(1)
    S, n_src, n_dst = 2, spmm.n_src, spmm.n_dst
    counts = spmm.counts_i64 if spec.bits == 64 else spmm.counts_i32
    dup_counts = dup.counts_i64 if spec.bits == 64 else dup.counts_i32
    a_csr = torch.sparse_csr_tensor(
        spmm.indptr.long(), spmm.indices.long(), counts,
        size=(n_dst, n_src), check_invariants=True)
    name = "ring kernel" if spec.bits == 64 else "ring32 kernel"

    def cases():
        for D in widths:
            h = ring_from_u64(rng.integers(0, 1 << 64, (S, n_src, D),
                                           dtype=np.uint64), spec,
                              device="cuda")
            h2 = h.transpose(0, 1).reshape(n_src, S * D)
            held(f"{name} {cell} D={D} repeated edges", dup.ring(h),
                 spmm_plain(dup.indptr, dup.indices, dup_counts, h), None)
            print(f"{name} {cell} D={D}: equal to plain on repeated "
                  f"edges nnz={dup.nnz} (max count "
                  f"{dup_counts.max().item()})", flush=True)
            path = launch_shape(D, e, (h.data_ptr(),),
                                (n_src * D, n_dst * D))
            yield (f"2 shares D={D} n={n_dst} nnz={spmm.nnz} "
                   f"(vec, lanes)={path}",
                   lambda: spmm.ring(h),
                   lambda: spmm_plain(spmm.indptr, spmm.indices, counts, h),
                   lambda: torch.sparse.mm(a_csr, h2).reshape(
                       n_dst, S, D).transpose(0, 1),
                   4 * (n_dst + 1) + (4 + e) * spmm.nnz
                   + e * S * (n_src + n_dst) * D,
                   S * spmm.nnz * D * mac_ms)

    return measure(f"{name} {cell}", cases(), None, PLAIN_CALLS)


def ring_matmul_operands(shape, rng, spec=None) -> tuple:
    """Random full-range operands of ``shape`` = (B, N, K, M) in the ring
    ``spec`` (int64 by default)."""
    from cognn_tpu_torch.core.ring import RING64, ring_from_u64

    B, N, K, M = shape
    spec = spec or RING64
    return (ring_from_u64(rng.integers(0, 1 << 64, (B, N, K),
                                       dtype=np.uint64), spec, device="cuda"),
            ring_from_u64(rng.integers(0, 1 << 64, (B, K, M),
                                       dtype=np.uint64), spec, device="cuda"))


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


def ring_matmul_phase(cell: str, shapes, a=None, spec=None) -> dict:
    """K3 at ``shapes`` (B, N, K, M) on random full-range operands of the
    ring ``spec`` (RING64 by default; RING32 runs K3 mod 2^32) (A is ``a``
    where given, at every shape), measured with ``torch.bmm`` on CUDA
    tensors of the ring's dtype as the library call, and timed once more
    with the L2 cold (:func:`cold_ms`; ``cold_ms`` is their sum). The bound
    is the larger of A, B and C once at 3.35 TB/s and the kernel's byte-limb
    products a multiply-add (36 at 64 bits, 10 at 32) at the int8
    tensor-core rate."""
    from cognn_tpu_torch.core.ring import RING64
    from cognn_tpu_torch.ops.intmatmul import ring_matmul, ring_matmul_plain

    spec = spec or RING64
    e = spec.bits // 8
    pairs = LIMB_PAIRS if spec.bits == 64 else LIMB_PAIRS_32
    rng = np.random.default_rng(2)
    operands = [ring_matmul_operands(shape, rng, spec) for shape in shapes]
    if a is not None:
        operands = [(a, b) for _, b in operands]
    name = "ring matmul" if spec.bits == 64 else "ring32 matmul"

    def cases():
        for (B, N, K, M), (a, b) in zip(shapes, operands):
            yield (f"[{B},{N},{K}]@[{B},{K},{M}]",
                   lambda: ring_matmul(a, b),
                   lambda: ring_matmul_plain(a, b),
                   lambda: torch.bmm(a, b),
                   e * (B * N * K + B * K * M + B * N * M),
                   2 * pairs * B * N * K * M / INT8_TC_OPS_PER_S * 1e3)

    tot = measure(f"{name} {cell}", cases(), None, PLAIN_CALLS)
    tot["cold_ms"] = 0.0
    for shape, (a, b) in zip(shapes, operands):
        ms = cold_ms(lambda: ring_matmul(a, b))
        print(f"{name} {cell} {shape} cold L2: kernel_ms={ms!r}",
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

    intmatmul.launches = intmatmul.launches_i32 = sddmm.launches = 0
    for k in spmms:
        k.launches = k.ring_launches = k.ring32_launches = 0


def read_counts(spmms) -> dict:
    from cognn_tpu_torch.ops import intmatmul, sddmm

    return {"spmm_csr_f32": sum(k.launches for k in spmms),
            "spmm_csr_i64": sum(k.ring_launches for k in spmms),
            "spmm_csr_i32": sum(k.ring32_launches for k in spmms),
            "ring_matmul_i64": intmatmul.launches,
            "ring_matmul_i32": intmatmul.launches_i32,
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


def launch_counts(engine, agg: int, matmuls: int) -> dict:
    """Kernel launches of ``agg`` aggregations and, on shares, ``matmuls``
    share matmuls: an aggregation is an f32 SpMM, a ring SpMM on shares, or
    with the dense backend none plaintext (``torch.matmul``) and a K3 on
    shares."""
    mpc = hasattr(engine, "weights_sh")
    dense = engine.aggregation == "dense"
    spmm = 0 if dense else agg
    bits = engine.proto.ring.bits if mpc else 0
    return {"spmm_csr_f32": 0 if mpc else spmm,
            "spmm_csr_i64": spmm if bits == 64 else 0,
            "spmm_csr_i32": spmm if bits == 32 else 0,
            "ring_matmul_i64": matmuls + dense * agg if bits == 64 else 0,
            "ring_matmul_i32": matmuls + dense * agg if bits == 32 else 0,
            "sddmm_f32": 0}


def aggregations(engine, epoch: bool) -> int:
    """The aggregations of one forward (an aggregation a layer) or one
    training epoch (opt: L forward and 2L backward phases less the two
    Apply-only ones, phase % L == 0; unopt: L forward and L - 1 between
    the backward layers), less layer 0's where the secret-shared unopt
    engine hoists agg(x0). In the sharded mode each is one halo."""
    L, mpc = engine.L, hasattr(engine, "weights_sh")
    hoisted = mpc and engine.unopt and engine.hoist_agg
    if not epoch:
        return L - hoisted
    return 2 * L - 1 - hoisted if engine.unopt else 3 * L - 2


def forward_counts(engine) -> dict:
    """Kernel launches of one forward: its :func:`aggregations` and on
    shares a K3 a layer (:func:`launch_counts`)."""
    return launch_counts(engine, aggregations(engine, False), engine.L)


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


def profile_phase(label: str, fn) -> dict:
    """Where one call of ``fn`` (a request, an epoch) spends its time: the
    device time of every kernel and copy (torch.profiler, CUPTI) against
    the call's wall time, which the profiler itself inflates, and the
    host's launch calls (``cuda*`` and ``cu*`` API). One call of ``fn`` runs
    first as the profiler's warm-up step, untraced: without it CUPTI lost
    a window's first device records now and then."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    by_name, host_calls = {}, Counter()
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) \
                or e.name.startswith("ProfilerStep"):
            continue  # the step's span, on the device timeline too
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        elif "Launch" in e.name and e.name.startswith("cu"):
            host_calls[e.name] += 1  # a launch call of the host's
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"profile {label}: wall_ms={wall_ms!r} device_busy_ms={busy_ms!r} "
          f"device_ops={sum(n for n, _ in by_name.values())} "
          f"idle_share={1 - busy_ms / wall_ms!r} "
          f"host_launch_calls={dict(host_calls)}", flush=True)
    for name, (n, us) in top:
        print(f"  {us / 1e3!r} ms x{n} {name[:110]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "ops": sum(n for n, _ in by_name.values()),
            "host_calls": dict(host_calls)}


def epoch_counts(engine) -> dict:
    """Kernel launches of one training epoch of the engine's L layers: its
    :func:`aggregations` and the secret-shared share matmuls (K3): L
    forward, L - 1 delta @ W^T (the engines skip layer 0's, which nothing
    reads), L weight gradients."""
    return launch_counts(engine, aggregations(engine, True), 3 * engine.L - 1)


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


def auto_phase(cell: str, plan, param, engines) -> None:
    """The ``auto`` decision of each engine and variant on ``cell``
    (:func:`cognn_tpu_torch.engine.gas.select_backend`), with the predicted
    times it compares; ``engines`` (built with ``auto``) must have taken
    it."""
    from cognn_tpu_torch.engine.gas import (aggregation_seconds,
                                            forward_widths, select_backend)
    from cognn_tpu_torch.engine.plan import DENSE_ADJ_BUDGET

    n = plan.num_parties * plan.V
    nnz = int(plan.loc_valid.sum() + plan.rem_valid.sum())
    fits = n * n <= DENSE_ADJ_BUDGET
    cuda = torch.device("cuda")
    for ring in (False, True):
        for variant, hoisted in (("opt", False), ("unopt", False),
                                 ("unopt", True)):
            if hoisted and not ring:
                continue
            widths = forward_widths(param, variant, hoisted)
            pick = select_backend(plan, cuda, widths, ring)
            t = {b: sum(aggregation_seconds(b, n, nnz, w, ring)
                        for w in widths) * 1e3 for b in ("bcsr", "dense")}
            print(f"auto {cell} {'mpc' if ring else 'plaintext'} {variant}"
                  f"{' hoisted' if hoisted else ''}: {pick} (widths "
                  f"{widths}, n={n} nnz={nnz}; predicted ms a forward: CSR "
                  f"{t['bcsr']!r}, dense {t['dense']!r}"
                  f"{'' if fits else ', dense over DENSE_ADJ_BUDGET'})",
                  flush=True)
    for engine in engines:
        mpc = hasattr(engine, "weights_sh")
        widths = forward_widths(param, engine.variant,
                                mpc and engine.unopt and engine.hoist_agg)
        want = select_backend(plan, cuda, widths, mpc)
        if engine.aggregation != want:
            raise AssertionError(f"auto {cell}: engine took "
                                 f"{engine.aggregation}, the rule {want}")


def dense_matmul_check(cell: str, dense, spmm, widths) -> dict:
    """The plaintext dense aggregation's product ``Aᵀ·H`` (``torch.matmul``,
    f32, TF32 off) beside the f32 CSR kernel at each width: both held to the
    CSR's plain version (KERNEL_TOL), both timed. The bound of the dense
    product: its compulsory bytes (the n×n matrix, H and the output) or its
    2·n²·D f32 operations. Returns {D: (dense ms, CSR ms)}."""
    from cognn_tpu_torch.ops.spmm import spmm_plain

    rng = np.random.default_rng(12)
    adj_t, n = dense.adj_t, dense.adj_t.shape[0]
    out = {}
    for D in widths:
        h = torch.from_numpy(rng.standard_normal((n, D),
                                                 dtype=np.float32)).cuda()
        want = spmm_plain(spmm.indptr, spmm.indices, spmm.counts, h)
        held(f"dense {cell} D={D}", adj_t @ h, want, KERNEL_TOL)
        held(f"kernel {cell} D={D}", spmm(h), want, KERNEL_TOL)
        ms = device_ms(lambda: adj_t @ h, TIMED_CALLS)
        csr_ms = device_ms(lambda: spmm(h), TIMED_CALLS)
        nbytes = 4 * (n * n + 2 * n * D)
        bound = max(nbytes / HBM_BYTES_PER_S,
                    2 * n * n * D / F32_FLOPS_PER_S) * 1e3
        print(f"dense {cell} f32 D={D}: torch.matmul [{n},{n}]@[{n},{D}] "
              f"ms={ms!r} (bound {bound!r} ms for {nbytes} B; achieved "
              f"{nbytes / ms * 1e3!r} B/s) beside CSR kernel ms={csr_ms!r} "
              f"(achieved {4 * ((n + 1) + 2 * spmm.nnz + 2 * n * D) / csr_ms * 1e3!r} "
              f"B/s)", flush=True)
        out[D] = (ms, csr_ms)
    return out


def ring_spmm_times(cell: str, spmm, widths) -> dict:
    """The ring CSR kernel's ms on both shares at each width, for the
    ``auto`` comparison with K3 on the dense matrix."""
    from cognn_tpu_torch.core.ring import ring_from_u64

    rng = np.random.default_rng(13)
    out = {}
    for D in widths:
        h = ring_from_u64(rng.integers(0, 1 << 64, (2, spmm.n_src, D),
                                       dtype=np.uint64), device="cuda")
        out[D] = device_ms(lambda: spmm.ring(h), TIMED_CALLS)
        nbytes = 4 * (spmm.n_dst + 1) + 12 * spmm.nnz \
            + 8 * 2 * (spmm.n_src + spmm.n_dst) * D
        print(f"ring kernel {cell} 2 shares D={D}: ms={out[D]!r} (achieved "
              f"{nbytes / out[D] * 1e3!r} B/s)", flush=True)
    return out


def install_counts(cell: str, plan, param, spmms) -> None:
    """The secret-shared unopt dense engine with the hoist: building it
    (its ``install_state``) must launch one K3, agg(x0), and nothing
    else."""
    from cognn_tpu_torch.mpc import MpcGasEngine

    reset_counts(spmms)
    MpcGasEngine(plan, param, "unopt", aggregation="dense", device="cuda")
    counts = read_counts(spmms)
    want = {"spmm_csr_f32": 0, "spmm_csr_i64": 0, "spmm_csr_i32": 0,
            "ring_matmul_i64": 1, "ring_matmul_i32": 0, "sddmm_f32": 0}
    if counts != want:
        raise AssertionError(f"{cell} dense unopt mpc install_state: "
                             f"launches {counts}, want {want}")
    print(f"dense {cell} unopt mpc hoisted: install_state launches "
          f"{counts}", flush=True)


def dense_phase(cell: str, plan, param, spmm, ring_spmm, spmms,
                n_edges: int) -> dict:
    """The dense backend on ``cell``, beside the CSR kernel in the same
    call. Plaintext (opt, unopt): FORWARDS requests of a dense engine held
    to ``sparse`` (:func:`forward_phase`: logits within LOGITS_TOL_OF_MAX of
    the largest, launches counted: no SpMM), 2 epochs of fresh engines
    (:func:`train_phase`: weights within TRAIN_WEIGHTS_TOL_OF_MAX of the
    largest). Secret-shared (opt, unopt hoisted and not): requests and 2
    epochs ``torch.equal`` to ``sparse`` in logits, weights and metrics, the
    launches counted (an aggregation is one K3, no SpMM), and
    ``install_counts``. Then the dense f32 product and K3 at the dense
    shapes (``[1, n, n] @ [1, n, 2·D]``, the real Aᵀ, full-range B; held
    ``torch.equal`` and timed warm and cold) beside the CSR kernels; request
    and epoch ms and device busy of dense beside the CSR kernel's. Returns
    the K3 numbers and counts for the kernels line."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.mpc import MpcGasEngine

    dims = param.layer_dims
    counts, z_plain, w_plain = {}, {}, {}
    for variant in ("opt", "unopt"):
        inf = f"{variant}_inference"
        dense, sparse = (GasEngine(plan, param, inf, aggregation=agg,
                                   device="cuda")
                         for agg in ("dense", "sparse"))
        label = f"{cell} dense {variant}"
        _, z_plain[variant] = forward_phase(label, dense, sparse, spmms)
        profile_phase(label, dense.forward)
        train = [GasEngine(plan, param, variant, aggregation=agg,
                           device="cuda") for agg in ("dense", "sparse")]
        _, w_plain[variant], _ = train_phase(label, *train, spmms)
    for variant, hoist in (("opt", True), ("unopt", True),
                           ("unopt", False)):
        label = (f"{cell} dense {variant} mpc"
                 + (" hoisted" if variant == "unopt" and hoist else "")
                 + ("" if hoist else " not hoisted"))
        inf = f"{variant}_inference"
        dense, sparse = (MpcGasEngine(plan, param, inf, aggregation=agg,
                                      hoist_agg=hoist, device="cuda")
                         for agg in ("dense", "sparse"))
        counts[label] = {"forward": mpc_forward_phase(
            label, dense, sparse, z_plain[variant], spmms)}
        profile_phase(label, dense.forward)
        train = [MpcGasEngine(plan, param, variant, aggregation=agg,
                              hoist_agg=hoist, device="cuda")
                 for agg in ("dense", "sparse")]
        counts[label]["epochs"] = train_phase(label, *train, spmms,
                                              w_plain[variant])[0]
    install_counts(cell, plan, param, spmms)

    # dense against the CSR kernel: requests and epochs in this call
    for mpc in (False, True):
        cls = MpcGasEngine if mpc else GasEngine
        for agg in ("dense", "bcsr"):
            label = f"{cell} {agg}{' mpc' if mpc else ''}"
            engine = cls(plan, param, "opt", aggregation=agg, device="cuda")
            (_, _, _), times = timed_forwards(engine)
            print(f"request {label}: ms per request {times!r}", flush=True)
            time_epochs(label, engine, n_edges, EPOCHS_TIMED_UNOPT)
            profile_phase(f"{label} epoch", engine.run_epoch)

    # the aggregation's products at the cells' widths, beside the CSR kernel
    widths = (dims[1], dims[2], dims[0])
    dense = GasEngine(plan, param, "opt", aggregation="dense",
                      device="cuda")
    dense_matmul_check(cell, dense, spmm, widths)
    ring_spmm_times(cell, ring_spmm, widths)
    mpc = MpcGasEngine(plan, param, "opt", aggregation="dense",
                       device="cuda")
    n = mpc.adj_t.shape[-1]
    k3 = ring_matmul_phase(f"{cell} dense", [(1, n, n, 2 * D)
                                              for D in widths], mpc.adj_t)
    return {"k3": k3, "counts": counts,
            "shapes": [(1, n, n, 2 * D) for D in widths]}


def sharded_party(cell: str, dataset: str, parties: int, rank: int,
                  port: int, backend: str, out_file: str) -> None:
    """One party process of :func:`sharded_phase` (``chip_smoke.py
    --sharded-party ...``): party ``rank`` of ``parties`` on
    ``cuda:{rank % cards}``, collectives over ``backend``. Builds the
    cell's plan from the seed as the stacked engines do, then each of
    SHARDED_CASES twice from the same seeds: graphed (the default, CUDA
    graphs split at the collectives) and eager (``cuda_graphs=False``).
    Each drives FORWARDS requests, EPOCHS_CHECKED epochs
    (``run_epochs_scan``) and one more request, the counts (kernels and
    collectives) set to 0 just before and read just after each part, each
    held to its expected number and to the comm model's
    (:func:`sharded_drive`); graphed is held to eager
    (:func:`sharded_hold`: ``torch.equal`` everywhere, counts, collectives,
    bytes, generator offsets, the graphs a replay launches). Then, for
    SHARDED_TIMED, requests and epochs timed graphed and eager in turns,
    each window from a barrier, one epoch of each profiled on party 0 (the
    host's launch calls), and an epoch window of each with every
    collective synchronized and timed. Then the wrap operands through
    ``all_reduce`` and ``all_to_all``. Saves the graphed results and the
    times, on the host, to ``out_file``."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.harness.datasets import party_plan
    from cognn_tpu_torch.mpc import MpcGasEngine
    from cognn_tpu_torch.utils import distributed

    group = distributed.init_party_group(
        rank, parties, f"127.0.0.1:{port}", backend=backend,
        timeout=SHARDED_GROUP_TIMEOUT_S, device="cuda")
    print(f"sharded {cell}: {group}", flush=True)
    try:
        plan, param = party_plan(dataset, parties,
                                 dense=(cell == DENSE_CELL) or None)
        out = {}
        for key, mpc, variant, aggregation in SHARDED_CASES:
            if aggregation == "dense" and plan.dense_adj is None:
                continue
            epochs = 0 if variant.endswith("inference") else EPOCHS_CHECKED
            runs = {}
            for mode, flag in (("eager", False), ("graphed", None)):
                eng = (MpcGasEngine if mpc else GasEngine)(
                    plan, param, variant, aggregation=aggregation,
                    mode="sharded", group=group, device="cuda",
                    cuda_graphs=flag)
                if eng._graphs.enabled != (flag is None):
                    raise AssertionError(f"sharded {cell} {key} {mode}: "
                                         f"graphs {eng._graphs.enabled}")
                runs[mode] = sharded_drive(f"{cell} party {rank} {key} "
                                           f"{mode}", eng, group, plan,
                                           param, epochs)
            sharded_hold(f"sharded {cell} party {rank} {key}", mpc, runs)
            g = runs["graphed"]
            out[key] = {k: g[k] for k in (
                "logits", "weights", "metrics", "forward_counts",
                "epoch_counts", "epoch_comm", "segments") if k in g}
            if key in SHARDED_TIMED:
                out[key]["times"] = sharded_times(
                    f"{cell} {key}", group, rank,
                    {m: r["engine"] for m, r in runs.items()}, epochs)
            del runs, g, eng

        for dtype, key in ((torch.int64, ""), (torch.int32, "_i32")):
            x = distributed.wrap_check_operand(rank, parties, dtype).to(
                group.device)
            out["all_reduce" + key] = group.all_reduce_sum(x).cpu()
            out["all_to_all" + key] = group.all_to_all(x).cpu()
        torch.save(out, out_file)
        print(f"sharded {cell} party {rank}: done", flush=True)
    finally:
        distributed.destroy_party_group()


def sharded_analytic(eng, plan, param, forwards: int, epochs: int):
    """The comm model's calls and bytes of ``forwards`` forwards and
    ``epochs`` epochs of the sharded ``eng``, by collective (those called):
    a halo all_to_all an aggregation, an all_reduce a weight mean."""
    from cognn_tpu_torch.engine import comm_model

    mpc = hasattr(eng, "weights_sh")
    kw = dict(mpc=mpc, limbs=eng.proto.ring.bits // 32 if mpc else 2,
              hoist_agg=eng.hoist_agg if mpc else None)
    base = "unopt" if eng.unopt else "opt"
    variants = (f"{base}_inference", base)  # a forward, an epoch

    def total(fwd, ep):
        want = {k: forwards * fwd[k] + epochs * ep[k]
                for k in ("all_to_all", "all_reduce")}
        return {k: v for k, v in want.items() if v}

    return (total(*(comm_model.analytic_rounds_per_epoch(param, v, **kw)
                    for v in variants)),
            total(*(comm_model.analytic_bytes_per_epoch(
                plan, param, v, aggregation=eng.aggregation, **kw)
                for v in variants)))


def sharded_drive(label: str, eng, group, plan, param, epochs: int) -> dict:
    """One engine of :func:`sharded_party`: FORWARDS requests (each timed,
    its logits kept), ``epochs`` epochs through ``run_epochs_scan`` and one
    more request, each part between a barrier and a synchronize with the
    kernel and collective counts set to 0 just before and read just after,
    held to :func:`forward_counts` / :func:`epoch_counts` and to the comm
    model (:func:`sharded_analytic`); the generator's offset after every
    call (secret-shared). Returns the results on the host."""
    mpc = hasattr(eng, "weights_sh")
    spmms = [eng.spmm] if eng.spmm is not None else []
    offsets = []

    def offset():
        if mpc:
            offsets.append(eng._gen.get_offset())

    def counted(part, fn, forwards, n_epochs):
        group.barrier()
        torch.cuda.synchronize()
        reset_counts(spmms)
        group.reset_counts()
        result = fn()
        torch.cuda.synchronize()
        counts, calls = read_counts(spmms), dict(group.calls)
        sent = dict(group.bytes)
        want = {k: forwards * v for k, v in forward_counts(eng).items()}
        for k, v in epoch_counts(eng).items():
            want[k] += n_epochs * v
        want_calls, want_bytes = sharded_analytic(eng, plan, param, forwards,
                                                  n_epochs)
        if counts != want or calls != want_calls or sent != want_bytes:
            raise AssertionError(
                f"sharded {label} {part}: launches {counts}, collectives "
                f"{calls}, bytes {sent}; want {want}, {want_calls}, "
                f"{want_bytes} (comm model)")
        return result, counts, {"calls": calls, "bytes": sent}

    def requests(n):
        zs, ms = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            zs.append(eng.forward()[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            offset()
        return zs, ms

    (zs, ms), f_counts, f_comm = counted("requests",
                                         lambda: requests(FORWARDS),
                                         FORWARDS, 0)
    run = {"engine": eng, "request_ms": ms, "forward_counts": f_counts,
           "forward_comm": f_comm}
    if epochs:
        metrics, e_counts, e_comm = counted(
            "epochs", lambda: eng.run_epochs_scan(epochs), 0, epochs)
        offset()
        (z_after, _), _, _ = counted("request after the epochs",
                                     lambda: requests(1), 1, 0)
        zs += z_after
        run.update(metrics={k: v.cpu() for k, v in metrics.items()},
                   epoch_counts=e_counts, epoch_comm=e_comm)
    run["z"] = [z.cpu() for z in zs]
    # the stacked references' logits: before the epochs plaintext, after
    # them secret-shared
    run["logits"] = run["z"][-1 if mpc else 0]
    run["weights"] = [w.cpu() for w in (eng.reveal_weights() if mpc
                                        else eng.weights)]
    if mpc:
        run["shares"] = [w.cpu() for w in eng.weights_sh]
    run["offsets"] = offsets
    run["segments"] = {step: eng._graphs.segments(step)
                       for step in ("forward", "epoch")}
    return run


def sharded_hold(label: str, mpc: bool, runs: dict) -> None:
    """Graphed against eager (:func:`sharded_drive`'s results): every
    request's logits, every epoch's metrics, the weights (revealed, and the
    share bits) ``torch.equal``; launch counts, collective calls and bytes
    of each part equal; the generator's offsets equal after every call and
    growing. The graphed engine's steps split into one graph more than
    their collectives, the eager one's into none."""
    g, e = runs["graphed"], runs["eager"]
    tensors = {"logits": (g["z"], e["z"]),
               "weights": (g["weights"], e["weights"])}
    if "metrics" in g:
        tensors["metrics"] = (list(g["metrics"].values()),
                              list(e["metrics"].values()))
    if mpc:
        tensors["shares"] = (g["shares"], e["shares"])
    for what, (got, want) in tensors.items():
        for a, b in zip(got, want, strict=True):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{label}: graphed {what} differ from eager by "
                    f"{(a.double() - b.double()).abs().max().item()!r}")
    for k in ("forward_counts", "forward_comm", "epoch_counts",
              "epoch_comm"):
        if g.get(k) != e.get(k):
            raise AssertionError(f"{label}: {k} graphed {g.get(k)}, eager "
                                 f"{e.get(k)}")
    got = g["offsets"]
    if got != e["offsets"] or any(b <= a for a, b in zip(got, got[1:])):
        raise AssertionError(f"{label}: generator offsets graphed {got}, "
                             f"eager {e['offsets']}")
    want = {"forward": sum(g["forward_comm"]["calls"].values())
            // FORWARDS + 1}
    if "epoch_comm" in g:
        want["epoch"] = (sum(g["epoch_comm"]["calls"].values())
                         // EPOCHS_CHECKED + 1)
    if any(g["segments"][k] != n for k, n in want.items()) \
            or any(e["segments"].values()):
        raise AssertionError(f"{label}: graphs a step graphed "
                             f"{g['segments']} (want {want}), eager "
                             f"{e['segments']}")
    print(f"{label}: graphed == eager (torch.equal: logits of "
          f"{len(g['z'])} requests, metrics, weights"
          f"{', share bits' if mpc else ''}); launches, collectives and "
          f"bytes as eager's and the comm model's; generator offsets "
          f"{got} as eager's; graphs a replay {g['segments']}", flush=True)


def sharded_times(label: str, group, rank: int, engines: dict,
                  epochs: int) -> dict:
    """ms a request over SHARDED_CALLS_TIMED and, with ``epochs``, ms an
    epoch over SHARDED_EPOCHS_TIMED (``run_epochs_scan``), graphed and
    eager in turns, each window from a barrier to a synchronize; one epoch
    (or request) of each profiled on party 0 (the others run it alike), its
    host launch calls; then an epoch window of each with every collective
    bracketed by synchronizations, the collectives' ms an epoch."""
    def window(eng, what):
        group.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "request":
            for _ in range(SHARDED_CALLS_TIMED):
                eng.forward()
        else:
            eng.run_epochs_scan(SHARDED_EPOCHS_TIMED)
        torch.cuda.synchronize()
        n = SHARDED_CALLS_TIMED if what == "request" else SHARDED_EPOCHS_TIMED
        return (time.perf_counter() - t0) * 1e3 / n

    out = {}
    for what in ("request", "epoch") if epochs else ("request",):
        out[what] = {"eager": [], "graphed": []}
        for mode in ("eager", "graphed", "graphed", "eager"):
            out[what][mode].append(window(engines[mode], what))
    step = "epoch" if epochs else "request"
    for mode, eng in engines.items():
        fn = eng.run_epoch if epochs else eng.forward
        group.barrier()
        if rank == 0:
            prof = profile_phase(f"sharded {label} {mode} {step}", fn)
            out[f"{mode} host_calls"] = prof["host_calls"]
        else:
            for _ in range(2):  # as profile_phase calls it
                fn()
                torch.cuda.synchronize()
    if epochs:
        for mode, eng in engines.items():
            group.timed = True
            group.reset_counts()
            out[f"{mode} synced"] = window(eng, "epoch")
            out[f"{mode} collective"] = (group.seconds * 1e3
                                         / SHARDED_EPOCHS_TIMED)
            group.timed = False
    return out


def sharded_auto(cell: str, plan, param) -> None:
    """The ``auto`` decision of the sharded engines on ``cell``: the
    per-party products (V src x P·V dst, the busiest party's entries)
    compared by :func:`cognn_tpu_torch.engine.gas.select_backend`."""
    from cognn_tpu_torch.engine.gas import (aggregation_seconds,
                                            forward_widths, select_backend)

    P, V = plan.num_parties, plan.V
    nnz = int((plan.loc_valid.sum(1) + plan.rem_valid.sum(1)).max())
    cuda = torch.device("cuda")
    for ring in (False, True):
        for variant, hoisted in (("opt", False), ("unopt", ring)):
            widths = forward_widths(param, variant, hoisted)
            pick = select_backend(plan, cuda, widths, ring, sharded=True)
            t = {b: sum(aggregation_seconds(b, P * V, nnz, w, ring, V)
                        for w in widths) * 1e3 for b in ("bcsr", "dense")}
            print(f"auto {cell} sharded {'mpc' if ring else 'plaintext'} "
                  f"{variant}{' hoisted' if hoisted else ''}: {pick} "
                  f"(widths {widths}, V={V} x P*V={P * V}, nnz={nnz}; "
                  f"predicted ms a forward's products: CSR {t['bcsr']!r}, "
                  f"dense {t['dense']!r}"
                  f"{'' if plan.dense_adj is not None else ', no dense plan'}"
                  ")", flush=True)


def stacked_epoch_ms(engine) -> float:
    """ms an epoch of ``engine`` over EPOCHS_TIMED epochs (``run_epochs``,
    synchronized): the compute of the comm model's duration grid."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_epochs(EPOCHS_TIMED)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / EPOCHS_TIMED


def sharded_references(plan, param) -> dict:
    """What :func:`sharded_party` computes, from the stacked engines in this
    process (same seeds, ``bcsr``), on the host; and the stacked plaintext
    and secret-shared opt engines' ms an epoch (:func:`stacked_epoch_ms`,
    after the checked epochs)."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.mpc import MpcGasEngine

    ref = {}
    plain = GasEngine(plan, param, "opt", aggregation="bcsr", device="cuda")
    z = plain.forward()[0].cpu()
    metrics = plain.run_epochs_scan(EPOCHS_CHECKED)
    ref["plain"] = {"logits": z, "weights": [w.cpu() for w in plain.weights],
                    "metrics": {k: v.cpu() for k, v in metrics.items()},
                    "stacked_ms": stacked_epoch_ms(plain)}
    for key, variant in (("mpc", "opt"), ("unopt", "unopt")):
        mpc = MpcGasEngine(plan, param, variant, aggregation="bcsr",
                           device="cuda")
        metrics = mpc.run_epochs_scan(EPOCHS_CHECKED)
        ref[key] = {"weights": [w.cpu() for w in mpc.reveal_weights()],
                    "metrics": {k: v.cpu() for k, v in metrics.items()},
                    "logits": mpc.forward()[0].cpu()}
        if key == "mpc":
            ref[key]["stacked_ms"] = stacked_epoch_ms(mpc)
    if plan.dense_adj is not None:
        dense = MpcGasEngine(plan, param, "opt_inference",
                             aggregation="dense", device="cuda")
        ref["dense"] = {"logits": dense.forward()[0].cpu()}
    return ref


def launch_parties(cell: str, dataset: str, parties: int, backend: str,
                   tmp: Path) -> list:
    """The ``parties`` processes of :func:`sharded_party` over ``backend``,
    all under SHARDED_RUN_TIMEOUT_S; raises (their logs printed) if one
    fails. Returns their results in rank order."""
    from cognn_tpu_torch.utils.distributed import free_port, run_parties

    port = free_port()
    outs = [tmp / f"{cell}_{backend}_{r}.pt" for r in range(parties)]
    logs = [tmp / f"{cell}_{backend}_{r}.log" for r in range(parties)]
    handles = [open(f, "w") for f in logs]
    t0 = time.perf_counter()
    try:
        run_parties([[sys.executable, str(Path(__file__).resolve()),
                      "--sharded-party", cell, dataset, str(parties), str(r),
                      str(port), backend, str(outs[r])]
                     for r in range(parties)],
                    timeout=SHARDED_RUN_TIMEOUT_S, stdouts=handles,
                    stderrs=handles,
                    env={**os.environ, "PYTHONPATH": str(ROOT)})
    except (RuntimeError, TimeoutError) as e:
        for h in handles:
            h.close()
        for r, f in enumerate(logs):
            print(f"--- sharded {cell} {backend} party {r}:\n"
                  f"{f.read_text()[-4000:]}", flush=True)
        raise AssertionError(f"sharded {cell} over {backend}: {e}") from e
    for h in handles:
        h.close()
    wall = time.perf_counter() - t0
    print(f"sharded {cell} {backend}: {parties} party processes in "
          f"{wall:.1f} s; " + "; ".join(
              line for f in logs for line in f.read_text().splitlines()
              if "collectives over" in line or "graphed ==" in line),
          flush=True)
    return [torch.load(o, weights_only=False) for o in outs]


def hold_sharded(cell: str, backend: str, ref: dict, results) -> None:
    """The party processes' results (their graphed engines'), gathered over
    the parties, against the stacked engines' (``ref``): plaintext logits
    within LOGITS_TOL_OF_MAX and weights within TRAIN_WEIGHTS_TOL_OF_MAX of
    the largest, losses
    within SHARDED_LOSS_TOL and the other metrics equal; every
    secret-shared revealed weight, logit and metric ``torch.equal``; the
    collectives' int64 sums and exchanges equal numpy uint64's. Prints each
    party's times."""
    from cognn_tpu_torch.utils import distributed

    def cat(key, field):
        return torch.cat([r[key][field] for r in results])

    z, z_ref = cat("plain", "logits"), ref["plain"]["logits"]
    atol = LOGITS_TOL_OF_MAX * z_ref.abs().max().item()
    torch.testing.assert_close(z, z_ref, rtol=0, atol=atol)
    w_err = max((torch.cat([r["plain"]["weights"][l] for r in results])
                 - w_ref).abs().max().item()
                for l, w_ref in enumerate(ref["plain"]["weights"]))
    w_tol = TRAIN_WEIGHTS_TOL_OF_MAX * max(
        w.abs().max().item() for w in ref["plain"]["weights"])
    if not w_err <= w_tol:
        raise AssertionError(f"sharded {cell} {backend}: weights {w_err} "
                             f"from the stacked engine's, tolerance {w_tol}")
    metrics = {k: torch.cat([r["plain"]["metrics"][k] for r in results])
               for k in ref["plain"]["metrics"]}
    loss_err = (metrics["loss"]
                - ref["plain"]["metrics"]["loss"]).abs().max().item()
    if not loss_err <= SHARDED_LOSS_TOL:
        raise AssertionError(f"sharded {cell} {backend}: loss {loss_err} "
                             f"from the stacked engine's, tolerance "
                             f"{SHARDED_LOSS_TOL}")
    for k, m_ref in ref["plain"]["metrics"].items():
        if k != "loss" and not torch.equal(metrics[k], m_ref):
            raise AssertionError(f"sharded {cell} {backend}: plaintext {k} "
                                 f"differs from the stacked engine's")
    for key in ("mpc", "unopt", "dense"):
        if key not in ref:
            continue
        checks = {"logits": (cat(key, "logits"), ref[key]["logits"])} \
            if "logits" in results[0][key] else {}
        for l, w_ref in enumerate(ref[key].get("weights", [])):
            checks[f"weights {l}"] = (torch.cat(
                [r[key]["weights"][l] for r in results]), w_ref)
        for k, m_ref in ref[key].get("metrics", {}).items():
            checks[f"metric {k}"] = (torch.cat(
                [r[key]["metrics"][k] for r in results]), m_ref)
        for what, (got, want) in checks.items():
            if not torch.equal(got, want):
                raise AssertionError(
                    f"sharded {cell} {backend} {key}: {what} differs from "
                    f"the stacked engine's by "
                    f"{(got - want).abs().max().item()}")
    world = len(results)
    for dtype, key in ((torch.int64, ""), (torch.int32, "_i32")):
        total, recv = distributed.wrap_expected(world, dtype)
        for r, res in enumerate(results):
            if not (torch.equal(res["all_reduce" + key], total)
                    and torch.equal(res["all_to_all" + key], recv[r])):
                raise AssertionError(f"sharded {cell} {backend}: {dtype} "
                                     f"all_reduce / all_to_all of party {r} "
                                     "do not wrap like numpy uint64")
    print(f"sharded {cell} {backend}: plaintext logits within "
          f"{(z - z_ref).abs().max().item()!r} (atol {atol!r}), weights "
          f"within {w_err!r} (tol {w_tol!r}), loss within {loss_err!r} of "
          f"the stacked engine; secret-shared opt, unopt hoisted"
          f"{' and dense' if 'dense' in ref else ''} revealed logits, "
          f"weights and metrics equal; int64 and int32 all_reduce and "
          f"all_to_all wrap like numpy uint64; every part's bytes equal to "
          f"the comm model's", flush=True)
    cards = torch.cuda.device_count()
    for r, res in enumerate(results):
        where = f"party on cuda:{r % cards}" + (
            "" if cards >= world else
            f", {world} parties time-sliced on {cards} card(s)")
        for key in SHARDED_TIMED:
            if key not in res:
                continue
            t = res[key]["times"]
            line = (f"sharded {cell} {backend} party {r} {key}: ms a request "
                    f"over {SHARDED_CALLS_TIMED} (in turns) graphed "
                    f"{t['request']['graphed']!r} eager "
                    f"{t['request']['eager']!r}")
            if "epoch" in t:
                line += (f"; ms an epoch over {SHARDED_EPOCHS_TIMED} graphed "
                         f"{t['epoch']['graphed']!r} eager "
                         f"{t['epoch']['eager']!r}; synced graphed "
                         f"{t['graphed synced']!r} (collectives "
                         f"{t['graphed collective']!r}) eager "
                         f"{t['eager synced']!r} (collectives "
                         f"{t['eager collective']!r})")
            if "graphed host_calls" in t:
                line += (f"; host launch calls "
                         f"{'an epoch' if 'epoch' in t else 'a request'} "
                         f"graphed "
                         f"{t['graphed host_calls']} eager "
                         f"{t['eager host_calls']}")
            print(f"{line}; graphs a replay {res[key]['segments']}; {where}; "
                  f"{card_line()}", flush=True)


def comm_grid(cell: str, party: dict, ref: dict) -> None:
    """Party 0's counted bytes and rounds an epoch (equal to the comm
    model's, :func:`sharded_party` holds that), and the comm model's epoch
    duration over the reference's network grid with the stacked engine's
    measured ms an epoch as the compute, plaintext and secret-shared."""
    from cognn_tpu_torch.engine.comm_model import duration_grid

    for key, label in (("plain", "plaintext"), ("mpc", "secret-shared")):
        comm = party[key]["epoch_comm"]
        sent = sum(comm["bytes"].values()) / EPOCHS_CHECKED
        rounds = sum(comm["calls"].values()) / EPOCHS_CHECKED
        ms = ref[key]["stacked_ms"]
        grid = duration_grid(ms / 1e3, sent, rounds)
        print(f"comm {cell} {label} opt: bytes an epoch a party "
              f"{ {k: v / EPOCHS_CHECKED for k, v in comm['bytes'].items()} } "
              f"total {sent!r}, rounds {rounds!r}; duration_grid(compute = "
              f"stacked {ms!r} ms an epoch) s: " + ", ".join(
                  f"{bw} Mbit/s {lat} ms: {t!r}"
                  for (bw, lat), t in grid.items()), flush=True)


def sharded_phase(cell: str, dataset: str, parties: int, replaces: str,
                  mac_ms: float) -> list:
    """The sharded mode on ``cell``: the ``auto`` decision; P party
    processes on the card over gloo with host copies (:func:`sharded_party`:
    graphed against eager engines in each party), held to the stacked
    engines built here (:func:`hold_sharded`); over
    NCCL as well where the host has a card for each party, else said so;
    then, alone on the card, the CSR kernels at the per-party shape (party
    0's V src x P·V dst CSR, D = 16 and C) against their plain versions
    and ``torch.sparse.mm``, every other party's CSR held too, on the
    dense cell K3 at ``[1, P·V, V] @ [1, V, 2·D]``, and K3 at a party's
    share matmuls (batch 1: its forward's and its epoch's others). Returns
    the kernels line's entries."""
    import tempfile

    from cognn_tpu_torch.engine.gas import (_build_spmm_sharded,
                                            party_dense_block)
    from cognn_tpu_torch.harness.datasets import party_plan
    from cognn_tpu_torch.ops.spmm import spmm_plain

    t0 = time.perf_counter()
    plan, param = party_plan(dataset, parties,
                             dense=(cell == DENSE_CELL) or None)
    sharded_auto(cell, plan, param)
    ref = sharded_references(plan, param)
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("gloo", "nccl"):
            if backend == "nccl" and torch.cuda.device_count() < parties:
                print(f"sharded {cell} nccl: not run: "
                      f"{torch.cuda.device_count()} card(s), {parties} "
                      "parties need one card each (NCCL refuses two ranks "
                      "on one GPU)", flush=True)
                continue
            runs[backend] = launch_parties(cell, dataset, parties, backend,
                                           Path(tmp))
            hold_sharded(cell, backend, ref, runs[backend])
    first = runs["gloo"][0]
    comm_grid(cell, first, ref)

    cuda = torch.device("cuda")
    dims = param.layer_dims
    widths = dims[1:]
    rng = np.random.default_rng(14)
    spmms = [_build_spmm_sharded(plan, p, cuda) for p in range(parties)]
    for p, k in enumerate(spmms):
        h = torch.from_numpy(rng.integers(-8, 8, (k.n_src, widths[0]))
                             .astype(np.float32)).cuda()
        held(f"kernel {cell} party {p}", k(h),
             spmm_plain(k.indptr, k.indices, k.counts, h), None)
        h = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62,
                                          (2, k.n_src, widths[0]))).cuda()
        held(f"ring kernel {cell} party {p}", k.ring(h),
             spmm_plain(k.indptr, k.indices, k.counts_i64, h), None)
    print(f"sharded {cell}: every party's CSR (V={plan.V} src x "
          f"P*V={parties * plan.V} dst, nnz {[k.nnz for k in spmms]}) equal "
          f"to its plain version at D={widths[0]} (integer rows, f32 and "
          f"ring)", flush=True)
    spmm = spmms[0]
    dup = with_repeats(spmm)
    degree_line(f"{cell} party 0", spmm)
    f32 = kernel_phase(f"{cell} party", spmm, dup, widths)
    ring = ring_spmm_phase(f"{cell} party", spmm, dup, widths, mac_ms)
    csr = (f"party 0's CSR: n_src={spmm.n_src} n_dst={spmm.n_dst} "
           f"nnz={spmm.nnz}")
    jax_path = SHARDED_JAX_PATH[cell]
    p, m = first["plain"], first["mpc"]
    entries = [{
        "name": f"spmm_csr_f32[{cell} party]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/spmm.cu",
        "replaces": replaces,
        "jax_path": jax_path,
        "launches": p["forward_counts"]["spmm_csr_f32"],
        "training_launches": p["epoch_counts"]["spmm_csr_f32"],
        "launches_per_epoch": p["epoch_counts"]["spmm_csr_f32"]
        // EPOCHS_CHECKED,
        "shape": f"one forward of party process 0 (of {parties} on the "
                 f"card): D in {list(widths)}, {csr}",
        **f32,
    }, {
        "name": f"spmm_csr_i64[{cell} party]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/spmm.cu",
        "replaces": replaces,
        "jax_path": f"share instantiation: {jax_path}",
        "launches": m["forward_counts"]["spmm_csr_i64"],
        "training_launches": m["epoch_counts"]["spmm_csr_i64"],
        "launches_per_epoch": m["epoch_counts"]["spmm_csr_i64"]
        // EPOCHS_CHECKED,
        "shape": f"one secret-shared forward of party process 0: 2 shares, "
                 f"D in {list(widths)}, {csr}",
        **ring,
    }]
    if plan.dense_adj is not None:
        adj = torch.from_numpy(party_dense_block(plan, 0)).to(
            torch.int64)[None].cuda()
        shapes = [(1, parties * plan.V, plan.V, 2 * D) for D in widths]
        k3 = ring_matmul_phase(f"{cell} party dense", shapes, adj)
        entries.append({
            "name": f"ring_matmul_i64[{cell} party dense]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
            "replaces": RING_MATMUL_REPLACES,
            "jax_path": "the sharded dense share aggregation "
                        "(_dense_agg_shares_i8 a party, "
                        "cognn_tpu/mpc/engine.py:987-1010), byte planes on "
                        "the MXU: XLA, not Pallas",
            "launches": first["dense"]["forward_counts"]["ring_matmul_i64"],
            "shape": "party 0's aggregation A_p^T [sh_0 | sh_1]: "
                     + ", ".join(f"[{b},{n},{k}]@[{b},{k},{c}]"
                                 for b, n, k, c in shapes)
                     + "; launches: one secret-shared dense forward of "
                     "party process 0 (its L matmuls and L aggregations)",
            **k3,
        })
    # K3 at a party's share matmuls: the forward's, then the epoch's others
    L = len(dims) - 1
    k3_shapes = ([(1, plan.V, dims[l], dims[l + 1]) for l in range(L)]
                 + train_shapes(1, plan.V, dims))
    k3 = ring_matmul_phase(f"{cell} party", k3_shapes)
    entries.append({
        "name": f"ring_matmul_i64[{cell} party]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
        "replaces": RING_MATMUL_REPLACES,
        "jax_path": f"{RING_MATMUL_JAX_PATH}, one party a process",
        "launches": m["forward_counts"]["ring_matmul_i64"],
        "training_launches": m["epoch_counts"]["ring_matmul_i64"],
        "launches_per_epoch": m["epoch_counts"]["ring_matmul_i64"]
        // EPOCHS_CHECKED,
        "shape": "party process 0's share matmuls, its forward's "
                 f"{L} then the epoch's {len(k3_shapes) - L} others: "
                 + ", ".join(f"[{b},{n},{k}]@[{b},{k},{c}]"
                             for b, n, k, c in k3_shapes)
                 + f"; launches: one secret-shared forward of party "
                 f"process 0 (training: {EPOCHS_CHECKED} epochs)",
        **k3,
    })
    print(f"sharded {cell}: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


def sharded_cli_phase(tmp: Path, files, stacked: dict) -> None:
    """The CLI's multi-process mode on synthetic Cora, 2 parties, 10
    epochs: ``--mode sharded`` (this command starts the 2 party processes,
    party 0 writes the dump from the gathered logits), its dump within
    SHARDED_DUMP_TOL of the stacked ``checkpoint`` run's (the same 10
    epochs); and ``-c`` in 2 processes started here with ``--mpc``, each
    printing its own ``tid->`` lines, party 0's losses equal to the stacked
    ``mpc dense`` run's at the 6 printed decimals."""
    import re

    from cognn_tpu_torch.utils.distributed import free_port, run_parties

    run = run_cli("sharded", ["-g", 2, "-m", "60", "--mode", "sharded"]
                  + files("cora", "sharded.txt"), tmp)
    dump = read_dump("sharded", tmp / "sharded.txt", len(stacked["dump"]))
    err = float(np.abs(dump - stacked["dump"]).max())
    if not err <= SHARDED_DUMP_TOL:
        raise AssertionError(f"cli sharded: dump {err} from the stacked "
                             f"dump, tolerance {SHARDED_DUMP_TOL}")
    print(f"cli sharded: dump within {err!r} of the stacked run's (tol "
          f"{SHARDED_DUMP_TOL}); loss {run['losses'][-1]!r}, stacked "
          f"{stacked['losses'][-1]!r}", flush=True)

    port = free_port()
    logs = [tmp / f"cluster{i}.log" for i in range(2)]
    handles = [open(f, "w") for f in logs]
    t0 = time.perf_counter()
    try:
        run_parties([[sys.executable, "-m",
                      "cognn_tpu_torch.harness.run_party", "-g", "2", "-m",
                      "60", "--mpc", "-c", "-i", str(i), "--coordinator",
                      f"127.0.0.1:{port}", *map(str, files("cora", "-"))]
                     for i in range(2)], timeout=900, stdouts=handles,
                    stderrs=handles, cwd=tmp,
                    env={**os.environ, "PYTHONPATH": str(ROOT)})
    except (RuntimeError, TimeoutError) as e:
        for h in handles:
            h.close()
        raise AssertionError(f"cli -c: {e}\n" + "\n".join(
            f.read_text()[-3000:] for f in logs)) from e
    for h in handles:
        h.close()
    outs = [f.read_text() for f in logs]
    for i, out in enumerate(outs):
        if f"tid-> {i}, iteration-> 60" not in out:
            raise AssertionError(f"cli -c party {i}: no iteration line")
    got = [float(x) for x in re.findall(r"cross-entropy-loss = (\S+)",
                                        outs[0])]
    if got != stacked["mpc_losses"]:
        raise AssertionError(f"cli -c --mpc: party 0 losses {got}, stacked "
                             f"{stacked['mpc_losses']}")
    print(f"cli -c --mpc: 2 party processes in "
          f"{time.perf_counter() - t0:.1f} s, party 0's 10 losses equal "
          f"to the stacked run's ({got[0]!r} -> {got[-1]!r}); " + "; ".join(
              line for out in outs for line in out.splitlines()
              if "joined cluster" in line), flush=True)


def parse_check(sets) -> None:
    """The native graph reader (``csrc/graph_io.cpp``, its thread pool on
    auto) against the numpy parse on the edge and vertex files of each
    dataset in ``sets`` (``cli_phase``'s): equal arrays and dtypes; prints
    each one's time."""
    from cognn_tpu_torch.config import GNNParam
    from cognn_tpu_torch.graph import io, native_io

    native_io.set_threads(0)
    for name, (edges, verts, _, config) in sets.items():
        dim = GNNParam.read_config(config).input_dim
        for what, native, plain in (
                ("edges", lambda: io.read_edge_list(edges),
                 lambda: io.read_edge_list_numpy(edges)),
                ("vertices", lambda: io.read_vertex_file(verts, dim),
                 lambda: io.read_vertex_file_numpy(verts, dim))):
            t0 = time.perf_counter()
            got = native()
            t1 = time.perf_counter()
            want = plain()
            t2 = time.perf_counter()
            if not all(g.dtype == w.dtype and np.array_equal(g, w)
                       for g, w in zip(got, want)):
                raise AssertionError(f"cli parse {name} {what}: the native "
                                     "reader differs from numpy's")
            print(f"cli parse {name} {what}: native == numpy "
                  f"({len(got[0])} rows); native {t1 - t0!r} s, numpy "
                  f"{t2 - t1!r} s", flush=True)


def run_cli(label: str, args, cwd: Path) -> dict:
    """One ``python -m cognn_tpu_torch.harness.run_party`` run on the card:
    rc 0 and the reference's lines, or it raises. Returns its stdout, its
    losses and its spans (s)."""
    import re

    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-m",
                        "cognn_tpu_torch.harness.run_party", *map(str, args)],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"cli {label}: rc {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    for line in CLI_LINES:
        if line not in r.stdout:
            raise AssertionError(f"cli {label}: no '{line}' line")
    spans = {tag: [float(x) for x in re.findall(
        rf"::{tag} took (\S+)", r.stdout)]
        for tag in ("graph_load", "preprocess", "iteration")}
    losses = [float(x) for x in
              re.findall(r"cross-entropy-loss = (\S+)", r.stdout)]
    print(f"cli {label}: rc 0; graph_load {spans['graph_load']} s, "
          f"preprocess {spans['preprocess']} s, median iteration "
          f"{float(np.median(spans['iteration']))!r} s over "
          f"{len(spans['iteration'])}; loss {losses[0]!r} -> "
          f"{losses[-1]!r}", flush=True)
    return {"stdout": r.stdout, "losses": losses, "spans": spans}


def read_dump(label: str, path: Path, n: int) -> np.ndarray:
    """The dump's rows by vid; raises unless it has one row a vid of
    0..n-1."""
    rows = np.loadtxt(path)
    vids = rows[:, 0].astype(np.int64)
    if len(rows) != n or not np.array_equal(np.sort(vids), np.arange(n)):
        raise AssertionError(f"cli {label}: {len(rows)} dump rows, want one "
                             f"for each of {n} vids")
    return rows[np.argsort(vids), 1:]


def last_block(stdout: str) -> str:
    """The last metric block of a run's output."""
    return stdout[stdout.rindex("--------"):].split("\n", 8)[:8]


def in_process_block(graphs, plan_kw: dict, param, variant: str, mpc: bool,
                     aggregation: str, epochs: int, fp=None) -> list:
    """The last metric block of an engine built in this process from the
    same graphs (secret-shared at the fixed-point spec ``fp``, the default
    where None), trained ``epochs`` epochs (0: one forward)."""
    import contextlib
    import io

    from cognn_tpu_torch.engine import GasEngine, build_device_plan
    from cognn_tpu_torch.harness.run_party import \
        print_metrics_reference_format
    from cognn_tpu_torch.mpc import MpcGasEngine

    plan = build_device_plan(graphs, **plan_kw)
    engine = (MpcGasEngine(plan, param, variant, aggregation=aggregation,
                           fp=fp, device="cuda") if mpc else
              GasEngine(plan, param, variant, aggregation=aggregation,
                        device="cuda"))
    metrics = (engine.run_epochs(epochs) if epochs
               else engine.forward()[2])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_metrics_reference_format(engine.metrics_host(metrics),
                                       num_vertices=graphs[0].num_local)
    return last_block(buf.getvalue())


def cli_phase() -> None:
    """The entry point a user calls, ``python -m
    cognn_tpu_torch.harness.run_party``, as subprocesses on the card, on
    files the port's ``transform`` writes into a temporary directory:
    synthetic Cora (seed 0, 2708 vertices, 1433 -> 16 -> 7, partitions 2
    and 4) and synthetic PubMed (19,717 vertices, 500 -> 16 -> 3, 4
    parties). Every run: rc 0, the reference's lines, one dump row a vid,
    and its last metric block equal to an engine's built in this process
    from the same files; the loss falling in training runs. Between runs:
    the --reorder dump within REORDER_DUMP_TOL of the plain one; the --mpc
    inference dump within MPC_LOGITS_TOL of the plaintext one (one forward
    from the same weights, the bound of tests/test_mpc.py:90); after 90
    epochs of each, the --mpc test accuracy within ACC_AGREE of the
    plaintext one (their dumps drift apart by more than MPC_LOGITS_TOL over
    90 epochs of fixed-point training: printed, not gated); the first loss
    resumed by -n below the cold one. The ``--ring-bits 32 --scaler-bits
    8`` run is exempt from the falling loss: at 8 fractional bits its
    gradient scale 1/train_n encodes to 0, and the in-process block is its
    gate. Prints each run's spans."""
    import contextlib
    import io
    import re
    import tempfile

    from cognn_tpu_torch.config import GNNParam, RunConfig
    from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
    from cognn_tpu_torch.core.ring import RING32
    from cognn_tpu_torch.harness.datasets import (synthetic_planetoid,
                                                  transform)
    from cognn_tpu_torch.harness.run_party import load_party_graphs

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        sets = {}
        for name, parties in (("cora", (2, 4)), ("pubmed", (4,))):
            d = transform(synthetic_planetoid(name, seed=0), tmp / name,
                          partitions=parties)
            sets[name] = [d / f"{name}.edge.preprocessed",
                          d / f"{name}.vertex.preprocessed",
                          d / f"{name}.part.preprocessed.{parties[0]}p",
                          d / f"{name}_config.txt"]
        print(f"cli: wrote synthetic cora and pubmed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        parse_check(sets)

        def files(name, out):
            *inputs, config = sets[name]
            return [*inputs, tmp / out, config]

        # (label, dataset, parties, extra args, variant, mpc, aggregation,
        # epochs: -m // epoch_layers, 0 for a forward)
        runs = [
            ("opt", "cora", 2, ["-m", "540"], "opt", False, "auto", 90),
            ("opt reorder", "cora", 2, ["-m", "540", "--reorder"], "opt",
             False, "auto", 90),
            ("mpc", "cora", 2, ["-m", "540", "--mpc"], "opt", True, "auto",
             90),
            ("ss", "cora", 2, ["-m", "360", "--variant", "ss"], "unopt",
             True, "auto", 90),
            ("inference", "cora", 2, ["--variant", "inference"],
             "opt_inference", False, "auto", 0),
            ("mpc inference", "cora", 2, ["--variant", "inference",
                                          "--mpc"], "opt_inference", True,
             "auto", 0),
            ("mpc dense", "cora", 2, ["-m", "60", "--mpc", "--aggregation",
                                      "dense"], "opt", True, "dense", 10),
            ("checkpoint", "cora", 2, ["-m", "60", "--checkpoint-every", "1",
                                       "-s", "smoke"], "opt", False, "auto",
             10),
            ("pubmed mpc", "pubmed", 4, ["-m", "60", "--mpc"], "opt", True,
             "auto", 10),
            ("mpc ring32", "cora", 2, ["-m", "60", "--mpc", "--ring-bits",
                                       "32", "--scaler-bits",
                                       str(RING32_FRAC_BITS)], "opt", True,
             "auto", 10),
            ("opt t8", "cora", 2, ["-m", "60", "-t", "8"], "opt", False,
             "auto", 10),
        ]
        graphs, out = {}, {}
        for (label, name, parties, extra, variant, mpc, agg,
             epochs) in runs:
            dump = label.replace(" ", "_") + ".txt"
            out[label] = run_cli(label, ["-g", parties, *extra]
                                 + files(name, dump), tmp)
            cfg = RunConfig(tiles=parties, edge_file=sets[name][0],
                            vertex_file=sets[name][1],
                            partition_file=sets[name][2])
            param = GNNParam.read_config(sets[name][3])
            if name not in graphs:
                with contextlib.redirect_stdout(io.StringIO()):  # its span
                    graphs[name] = load_party_graphs(cfg, param)
            out[label]["dump"] = read_dump(label, tmp / dump,
                                           param.num_samples)
            plan_kw = {"reorder": "--reorder" in extra,
                       "dense": agg == "dense" or None}
            fp = (FixedPointSpec(RING32, RING32_FRAC_BITS)
                  if "--ring-bits" in extra else None)
            want = in_process_block(graphs[name], plan_kw, param, variant,
                                    mpc, agg, epochs, fp)
            got = last_block(out[label]["stdout"])
            if got != want:
                raise AssertionError(f"cli {label}: last metrics {got}, in "
                                     f"process {want}")
            losses = out[label]["losses"]
            if epochs and f"tid-> 0, iteration-> " not in \
                    out[label]["stdout"]:
                raise AssertionError(f"cli {label}: no iteration line")
            # at --scaler-bits 8 the gradient scale 1/train_n (1/270 a
            # party on Cora) encodes to 0: RING32 updates are 0, its loss
            # stays, and the in-process block above is its gate
            if epochs and "--ring-bits" not in extra \
                    and not losses[-1] < losses[0]:
                raise AssertionError(f"cli {label}: loss {losses[0]} -> "
                                     f"{losses[-1]}")
        print(f"cli -t 8: ::graph_load {out['opt t8']['spans']['graph_load']}"
              f" s; without -t {out['opt']['spans']['graph_load']} s (Cora "
              f"2p, the native parser's threads)", flush=True)
        ckpt_args = next(run[3] for run in runs if run[0] == "checkpoint")
        resumed = run_cli("checkpoint -n", ["-g", 2, *ckpt_args, "-n"]
                          + files("cora", "resumed.txt"), tmp)
        if "restored checkpoint from checkpoints/smoke" not in \
                resumed["stdout"] or \
                not resumed["losses"][0] < out["checkpoint"]["losses"][0]:
            raise AssertionError(
                f"cli checkpoint -n: resumed first loss "
                f"{resumed['losses'][0]}, cold {out['checkpoint']['losses'][0]}")
        for label, plain, tol in (
                ("opt reorder", "opt", REORDER_DUMP_TOL),
                ("mpc inference", "inference", MPC_LOGITS_TOL),
                ("mpc", "opt", None), ("mpc ring32", "mpc dense", None)):
            err = float(np.abs(out[label]["dump"]
                               - out[plain]["dump"]).max())
            if tol is not None and not err <= tol:
                raise AssertionError(f"cli {label}: dump {err} from the "
                                     f"{plain} dump, tolerance {tol}")
            print(f"cli {label}: dump within {err!r} of the {plain} dump"
                  + (f" (tol {tol})" if tol is not None else
                     " (not gated: the same epochs in other rings or "
                     "backends)"), flush=True)
        acc = {label: float(re.findall(r"^test set accuracy = (\S+)$",
                                       out[label]["stdout"], re.M)[-1])
               for label in ("opt", "mpc")}
        if not abs(acc["mpc"] - acc["opt"]) <= ACC_AGREE:
            raise AssertionError(f"cli mpc: test accuracy {acc['mpc']}, "
                                 f"plaintext {acc['opt']}, more than "
                                 f"{ACC_AGREE} apart")
        print(f"cli mpc: test accuracy after 90 epochs {acc['mpc']!r}, "
              f"plaintext {acc['opt']!r} (within {ACC_AGREE})", flush=True)
        print(f"cli: {len(runs) + 1} runs, metrics equal to in-process "
              f"engines; checkpoint resumed at loss "
              f"{resumed['losses'][0]!r} (cold {out['checkpoint']['losses'][0]!r})",
              flush=True)
        sharded_cli_phase(tmp, files, {
            "dump": out["checkpoint"]["dump"],
            "losses": out["checkpoint"]["losses"],
            "mpc_losses": out["mpc dense"]["losses"]})



def host_reference(plan, name: str, edges, sweeps: int, n: int,
                   source) -> np.ndarray:
    """float64 values of ``name`` on the flat (party, vertex) axis after
    ``sweeps`` synchronous sweeps over the plan's real ``edges`` (src, dst,
    w), padding rows kept: the programs of tests/test_analytics.py."""
    from cognn_tpu_torch.engine.analytics import global_out_degree

    src, dst, w = edges
    mask = plan.vertex_mask.reshape(-1)
    size = mask.size
    if name == "pagerank":
        od = global_out_degree(plan).reshape(-1).astype(np.float64)
        x = np.full(size, 1.0 / n)
        for _ in range(sweeps):
            contrib = np.zeros(size)
            np.add.at(contrib, dst, x[src] / np.maximum(od[src], 1.0))
            x = np.where(mask, 0.15 / n + 0.85 * contrib, x)
        return x
    if name == "cc":
        x = np.arange(size, dtype=np.float64)
    else:
        x = np.full(size, 3.0e38)
        x[source[0] * plan.V + source[1]] = 0.0
    add = {"bfs": 1.0, "sssp": w.astype(np.float64), "cc": 0.0}[name]
    for _ in range(sweeps):
        nd = x.copy()
        np.minimum.at(nd, dst, x[src] + add)
        x = np.where(mask, nd, x)
    return x


def sweeps_to_fixpoint(step, h, reveal=lambda h: h) -> int:
    """Sweeps of ``step`` from ``h`` until one changes nothing (that one
    counted); raises after MAX_SWEEPS."""
    for k in range(1, MAX_SWEEPS + 1):
        nh = step(h)
        if torch.equal(reveal(nh), reveal(h)):
            return k
        h = nh
    raise AssertionError(f"no fixpoint in {MAX_SWEEPS} sweeps")


def timed_run(eng, sweeps: int, **kw) -> float:
    """ms a sweep of ``eng.run(sweeps)``, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(sweeps, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / sweeps


def analytics_pair(label: str, engines: dict, sweeps: int,
                   want: int) -> dict:
    """The graphed engine (the default: a CUDA graph a sweep) against the
    eager one (``cuda_graphs=False``), built alike: ``run(sweeps)`` of
    each with the kernel counts set to 0 just before and read just after
    (``want`` CSR SpMMs, f32 or ring, and nothing else), the values
    ``torch.equal``; then ms a sweep in turns (eager, graphed,
    graphed, eager) and one profiled run of each (busy, idle share, the
    host's launch calls a sweep). Returns the graphed values, counts, ms
    and profiles."""
    spmms = [eng.spmm for eng in engines.values() if eng.spmm is not None]
    out = {"counts": {}, "ms": {"eager": [], "graphed": []}, "prof": {}}
    for mode, eng in engines.items():
        if eng._graphs.enabled != (mode == "graphed"):
            raise AssertionError(f"analytics {label} {mode}: graphs "
                                 f"{eng._graphs.enabled}")
        reset_counts(spmms)
        out[mode] = eng.run(sweeps)
        torch.cuda.synchronize()
        counts = out["counts"][mode] = read_counts(spmms)
        if sum(counts.values()) != want or (want and not any(
                counts[k] == want for k in ("spmm_csr_f32", "spmm_csr_i64",
                                            "spmm_csr_i32"))):
            raise AssertionError(f"analytics {label} {mode}: launches "
                                 f"{counts}, want {want} CSR SpMMs")
    if not torch.equal(out["graphed"], out["eager"]):
        err = (out["graphed"] - out["eager"]).abs().max().item()
        raise AssertionError(f"analytics {label}: graphed differs from eager "
                             f"by {err!r}")
    for mode in ("eager", "graphed", "graphed", "eager"):
        out["ms"][mode].append(timed_run(engines[mode], sweeps))
    for mode, eng in engines.items():
        prof = profile_phase(f"analytics {label} {mode} run({sweeps})",
                             lambda: eng.run(sweeps))
        out["prof"][mode] = {
            "busy_ms_a_sweep": prof["busy_ms"] / sweeps,
            "idle_share": prof["idle_share"],
            "host_calls_a_sweep": {k: v / sweeps
                                   for k, v in prof["host_calls"].items()}}
    return out


def analytics_phase(cell: str, dataset: str, parties: int,
                    mac_ms: float) -> dict:
    """The vertex analytics on ``cell``'s plan (sssp's edge weights uniform
    in [0.5, 2) from SSSP_WEIGHT_SEED), plaintext (``AnalyticsEngine``)
    and secret-shared (``SSAnalyticsEngine``): pagerank PAGERANK_SWEEPS
    sweeps, bfs, sssp and cc (source: party 0's first vertex) to their
    fixpoint. Each engine on the card is built twice, graphed (the default:
    a sweep one CUDA graph replay) and eager, and held to itself
    (:func:`analytics_pair`: ``torch.equal``, one f32 CSR SpMM (plaintext)
    or one ring SpMM (secret-shared) a pagerank sweep in both, ms a sweep
    and the host's launch calls a sweep of each); the secret-shared shares
    and generator offsets equal too, and a graphed run after one with
    another seed equal to the eager run; pagerank's ``tol`` stop
    (PAGERANK_TOL) graphed == eager. Each held against the same engine on
    the CPU (the MIN programs and every secret-shared value ``torch.equal``,
    pagerank PAGERANK_CPU_RTOL), the plaintext ones against a float64 host
    reference, the secret-shared ones against the plaintext ones at the
    tests' tolerances (SS_ANALYTICS_TOL). Returns the pagerank SpMMs'
    numbers at D = 1 for the kernels line."""
    from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
    from cognn_tpu_torch.engine import analytics
    from cognn_tpu_torch.harness.datasets import (party_plan,
                                                  synthetic_planetoid)
    from cognn_tpu_torch.mpc.analytics import SS_INF, SSAnalyticsEngine
    from cognn_tpu_torch.mpc.protocol import Protocol

    t0 = time.perf_counter()
    ds = synthetic_planetoid(dataset)
    w = np.random.default_rng(SSSP_WEIGHT_SEED).uniform(
        0.5, 2.0, len(ds.src)).astype(np.float32)
    plan, _ = party_plan(dataset, parties, edge_weights=w)
    n = int(plan.num_local.sum())
    source = (0, 0)
    edges = analytics.flat_edges(plan)
    programs = {"pagerank": analytics.pagerank_program(num_vertices=n),
                "bfs": analytics.bfs_program(source),
                "sssp": analytics.sssp_program(source),
                "cc": analytics.cc_program()}
    out = {}
    for name, prog in programs.items():
        engines = {mode: analytics.AnalyticsEngine(
            plan, prog, device="cuda", cuda_graphs=None if mode == "graphed"
            else False) for mode in ("graphed", "eager")}
        card = engines["graphed"]
        cpu = analytics.AnalyticsEngine(plan, prog, device="cpu")
        h0 = torch.as_tensor(prog.init(plan, {}), device="cuda")
        sweeps = (PAGERANK_SWEEPS if name == "pagerank"
                  else sweeps_to_fixpoint(card.iteration, h0))
        want = PAGERANK_SWEEPS if name == "pagerank" else 0
        pair = analytics_pair(f"{cell} {name}", engines, sweeps, want)
        h, counts = pair["graphed"], pair["counts"]["graphed"]
        if name == "pagerank":
            tol = {mode: eng.run(MAX_SWEEPS, tol=PAGERANK_TOL)
                   for mode, eng in engines.items()}
            if not torch.equal(tol["graphed"], tol["eager"]):
                raise AssertionError(f"analytics {cell} pagerank: tol stop "
                                     "graphed differs from eager")
        h_cpu = cpu.run(sweeps)
        ref = host_reference(plan, name, edges, sweeps, n, source)
        got = h.cpu().reshape(-1).double().numpy()
        if name == "pagerank":
            torch.testing.assert_close(h.cpu(), h_cpu,
                                       rtol=PAGERANK_CPU_RTOL, atol=0)
            np.testing.assert_allclose(got, ref, rtol=PAGERANK_HOST_RTOL)
        else:
            if not torch.equal(h.cpu(), h_cpu):
                raise AssertionError(f"analytics {cell} {name}: card and "
                                     "CPU differ")
            np.testing.assert_allclose(
                np.minimum(got, 1e30), np.minimum(ref, 1e30),
                rtol=SSSP_HOST_RTOL if name == "sssp" else 0)

        # secret-shared: the same sweeps (the MIN programs' own fixpoint)
        proto = Protocol(FixedPointSpec(frac_bits=SS_PAGERANK_FRAC_BITS)
                         if name == "pagerank" else FixedPointSpec())
        kw = dict(proto=proto, num_vertices=n,
                  source=None if name in ("pagerank", "cc") else source)
        ss_engines = {mode: SSAnalyticsEngine(
            plan, name, device="cuda", cuda_graphs=None if mode == "graphed"
            else False, **kw) for mode in ("graphed", "eager")}
        ss = ss_engines["graphed"]
        ss_cpu = SSAnalyticsEngine(plan, name, device="cpu", **kw)
        gen = torch.Generator(device="cuda").manual_seed(1)
        sh0 = proto.share(gen, torch.as_tensor(ss.init_values(),
                                               device="cuda"))
        ss_sweeps = (PAGERANK_SWEEPS if name == "pagerank" else
                     sweeps_to_fixpoint(lambda x: ss.iteration(gen, x), sh0,
                                        proto.reveal))
        ss_pair = analytics_pair(f"{cell} {name} mpc", ss_engines, ss_sweeps,
                                 want)
        z, ss_counts = ss_pair["graphed"], ss_pair["counts"]["graphed"]
        # the last timed or profiled run of each had seed 0: its shares
        # and generator offset; then a graphed run after another seed
        shares = {m: e._h_sh.clone() for m, e in ss_engines.items()}
        offsets = {m: e._gen.get_offset() for m, e in ss_engines.items()}
        ss.run(ss_sweeps, seed=SS_OTHER_SEED)
        again = ss.run(ss_sweeps)
        if not (torch.equal(shares["graphed"], shares["eager"])
                and offsets["graphed"] == offsets["eager"]
                and torch.equal(ss._h_sh, shares["eager"])
                and torch.equal(again, z)
                and ss._gen.get_offset() == offsets["eager"]):
            raise AssertionError(f"analytics {cell} {name} mpc: graphed "
                                 f"shares or generator offsets ({offsets}, "
                                 f"after a reseed {ss._gen.get_offset()}) "
                                 "differ from eager")
        if not torch.equal(z.cpu(), ss_cpu.run(ss_sweeps)):
            raise AssertionError(f"analytics {cell} {name} mpc: card and "
                                 "CPU reveal different values")
        zc = np.minimum(z.cpu().numpy(), SS_INF)
        hc = np.minimum(h.cpu().numpy(), SS_INF)
        ss_err = float(np.abs(zc - hc).max())
        if name == "cc":
            if not np.array_equal(zc, hc):
                raise AssertionError(f"analytics {cell} cc mpc: labels "
                                     "differ from plaintext")
        elif not ss_err <= SS_ANALYTICS_TOL[name]:
            raise AssertionError(f"analytics {cell} {name} mpc: {ss_err} "
                                 f"from plaintext, tolerance "
                                 f"{SS_ANALYTICS_TOL[name]}")
        rel = float((np.abs(zc - hc) / np.maximum(np.abs(hc), 1e-30)).max())
        tol_note = "; the tol stop too" if name == "pagerank" else ""
        print(f"analytics {cell} {name}: {sweeps} sweeps plaintext, "
              f"{ss_sweeps} secret-shared; launches {counts} / {ss_counts}; "
              f"graphed == eager (torch.equal{tol_note}; "
              f"secret-shared shares and generator offsets, and after a "
              f"reseed); card == CPU{' (rtol ' + str(PAGERANK_CPU_RTOL) + ')' if name == 'pagerank' else ''}; "
              f"max|h - float64|={float(np.abs(np.minimum(got, 1e30) - np.minimum(ref, 1e30)).max())!r}; "
              f"secret-shared within {ss_err!r} of plaintext (tol "
              f"{SS_ANALYTICS_TOL[name]}, max relative {rel!r}); {card_line()}",
              flush=True)
        for label, pr in (("plaintext", pair), ("secret-shared", ss_pair)):
            print(f"analytics {cell} {name} {label}: ms a sweep (in turns) "
                  f"graphed {pr['ms']['graphed']!r} eager "
                  f"{pr['ms']['eager']!r}; a profiled run: busy ms a sweep "
                  f"graphed {pr['prof']['graphed']['busy_ms_a_sweep']!r} "
                  f"eager {pr['prof']['eager']['busy_ms_a_sweep']!r}, idle "
                  f"share {pr['prof']['graphed']['idle_share']!r} / "
                  f"{pr['prof']['eager']['idle_share']!r}, host launch calls "
                  f"a sweep graphed "
                  f"{pr['prof']['graphed']['host_calls_a_sweep']} eager "
                  f"{pr['prof']['eager']['host_calls_a_sweep']}; "
                  f"{card_line()}", flush=True)
        out[name] = {"counts": counts, "ss_counts": ss_counts,
                     "spmm": card.spmm, "ss_spmm": ss.spmm}
    k = out["pagerank"]["spmm"]
    dup = with_repeats(k)
    f32 = kernel_phase(f"{cell} pagerank", k, dup, (1,))
    ring = ring_spmm_phase(f"{cell} pagerank", k, dup, (1,), mac_ms)
    print(f"analytics {cell}: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"f32": f32, "ring": ring, "nnz": k.nnz, "n": k.n_dst,
            "launches": out["pagerank"]["counts"]["spmm_csr_f32"],
            "ring_launches": out["pagerank"]["ss_counts"]["spmm_csr_i64"]}


def ring32_phase(cell: str, plan, param, spmm, dup, mac_ms: float,
                 n_edges: int) -> dict:
    """The 32-bit ring on ``cell``: the int32 ring SpMM (``spmm``, the flat
    CSR, and ``dup``, its repeated edges) ``torch.equal`` to its plain
    version at the cell's widths and timed; K3 mod 2^32 at the RING32
    forward's and epoch's shapes; ``MpcGasEngine`` at ``FixedPointSpec(
    RING32, RING32_FRAC_BITS)``: FORWARDS requests and EPOCHS_CHECKED
    epochs with the counts set to 0 just before and read just after (a
    forward L int32 ring SpMMs and L int32 K3, an epoch as
    :func:`epoch_counts`), ``bcsr`` ``torch.equal`` to ``sparse`` in
    logits, weights and metrics, the gap to plaintext printed beside
    RING64's, and request and epoch ms beside RING64's engines'. On the
    dense cell, K3 mod 2^32 with the dense Aᵀ at ``[1, n, n] @ [1, n, 2·D]``
    and the int32 ring SpMM at the input width: the rates behind
    ``auto`` for int32 shares. Returns the kernels line's numbers."""
    from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
    from cognn_tpu_torch.core.ring import RING32
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.engine.gas import flat_dense_adjacency
    from cognn_tpu_torch.mpc import MpcGasEngine

    t0 = time.perf_counter()
    dims, L, P, V = param.layer_dims, param.num_layers, plan.num_parties, \
        plan.V
    mac32_ms = mac_ms / MULTIPLIES_PER_MAC  # one IMAD a 32-bit multiply-add
    ring = ring_spmm_phase(cell, spmm, dup, dims[1:], mac32_ms, RING32)
    fwd_shapes = [(P, V, dims[l], dims[l + 1]) for l in range(L)]
    k3 = ring_matmul_phase(cell, fwd_shapes, spec=RING32)
    train = train_shapes(P, V, dims)
    k3_train = ring_matmul_phase(f"{cell} train", train, spec=RING32)
    fp = FixedPointSpec(RING32, RING32_FRAC_BITS)

    def mpc(variant, aggregation="bcsr", ring32=True):
        return MpcGasEngine(plan, param, variant, aggregation=aggregation,
                            fp=fp if ring32 else None, device="cuda")

    eng, eng_sparse = mpc("opt_inference"), mpc("opt_inference", "sparse")
    spmms = [eng.spmm]
    reset_counts(spmms)
    (z, _, metrics), req_ms = timed_forwards(eng)
    counts = read_counts(spmms)
    want = {k: FORWARDS * v for k, v in forward_counts(eng).items()}
    if counts != want:
        raise AssertionError(f"ring32 {cell}: launches {counts} in "
                             f"{FORWARDS} forwards, want {want}")
    if not torch.equal(z, eng_sparse.forward()[0]):
        raise AssertionError(f"ring32 {cell}: bcsr logits differ from "
                             "sparse")
    check_metrics(f"ring32 {cell}", eng, metrics)
    z_plain = GasEngine(plan, param, "opt_inference",
                        device="cuda").forward()[0]
    wide = mpc("opt_inference", ring32=False)
    (z64, _, _), req64_ms = timed_forwards(wide)
    print(f"ring32 {cell}: {FORWARDS} forwards, launches {counts}, bcsr "
          f"logits equal to sparse; max|z - z_plain| RING32 f="
          f"{RING32_FRAC_BITS} {(z - z_plain).abs().max().item()!r}, RING64 "
          f"f=16 {(z64 - z_plain).abs().max().item()!r}; ms a request "
          f"RING32 {req_ms!r}, RING64 {req64_ms!r}", flush=True)
    del eng, eng_sparse, wide

    train_eng, train_sparse = mpc("opt"), mpc("opt", "sparse")
    reset_counts([train_eng.spmm])
    m = train_eng.run_epochs_scan(EPOCHS_CHECKED)
    e_counts = read_counts([train_eng.spmm])
    want = {k: EPOCHS_CHECKED * v for k, v in epoch_counts(train_eng).items()}
    if e_counts != want:
        raise AssertionError(f"ring32 {cell}: launches {e_counts} in "
                             f"{EPOCHS_CHECKED} epochs, want {want}")
    m_ref = train_sparse.run_epochs_scan(EPOCHS_CHECKED)
    w, w_ref = train_eng.reveal_weights(), train_sparse.reveal_weights()
    if not (all(torch.equal(m[k], m_ref[k]) for k in m)
            and all(torch.equal(a, b) for a, b in zip(w, w_ref))):
        raise AssertionError(f"ring32 {cell}: bcsr epochs differ from "
                             "sparse")
    check_metrics(f"ring32 {cell} epochs", train_eng, m)
    plain = GasEngine(plan, param, "opt", device="cuda")
    plain.run_epochs(EPOCHS_CHECKED)
    wide = mpc("opt", ring32=False)
    wide.run_epochs(EPOCHS_CHECKED)
    gap = max((a - b).abs().max().item() for a, b in zip(w, plain.weights))
    gap64 = max((a - b).abs().max().item()
                for a, b in zip(wide.reveal_weights(), plain.weights))
    ms = {}
    for label, e in (("RING32", train_eng), ("RING64", wide)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e.run_epochs(EPOCHS_TIMED)
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t1) * 1e3 / EPOCHS_TIMED
    print(f"ring32 {cell}: {EPOCHS_CHECKED} epochs, launches {e_counts}, "
          f"bcsr weights and metrics equal to sparse; max|W - W_plain| "
          f"RING32 {gap!r}, RING64 {gap64!r}; ms an epoch over "
          f"{EPOCHS_TIMED} {ms}; edge-iterations/s RING32 "
          f"{train_eng.epoch_layers * n_edges / ms['RING32'] * 1e3!r}; "
          f"{card_line()}", flush=True)
    del train_eng, train_sparse, wide, plain

    if cell == DENSE_CELL:
        n = P * V
        adj = torch.from_numpy(flat_dense_adjacency(plan).T.copy()).to(
            torch.int32)[None].cuda()
        widths = (dims[2], dims[0])
        dense = ring_matmul_phase(f"{cell} dense", [(1, n, n, 2 * D)
                                                    for D in widths], adj,
                                  RING32)
        csr = ring_spmm_phase(f"{cell} wide", spmm, dup, (dims[0],),
                              mac32_ms, RING32)
        print(f"ring32 {cell} auto rates: see the dense K3 lines above "
              f"(D = {widths}) and the CSR line at D = {dims[0]}; dense "
              f"{dense['ms']!r} ms for both widths, CSR {csr['ms']!r} ms",
              flush=True)
        torch.cuda.empty_cache()
    print(f"ring32 {cell}: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"spmm": ring, "k3": k3, "k3_train": k3_train,
            "counts": counts, "epoch_counts": e_counts,
            "shapes": fwd_shapes, "train_shapes": train}

def graph_cases(cell: str) -> list:
    """``graph_phase``'s engines on ``cell``: (label, secret-shared, keyword
    arguments). CoGNN-Opt and CoGNN (unopt; the inference variants run the
    same forward) plaintext and secret-shared on ``auto`` (the CSR kernel on
    both cells), unopt hoisted, RING32, and not hoisted on pubmed_4p; the
    dense backend on the dense cell."""
    from cognn_tpu_torch.core.fixedpoint import FixedPointSpec
    from cognn_tpu_torch.core.ring import RING32

    ring32 = FixedPointSpec(RING32, RING32_FRAC_BITS)
    cases = [("opt", False, {"variant": "opt"}),
             ("unopt", False, {"variant": "unopt"}),
             ("mpc opt", True, {"variant": "opt"}),
             ("mpc unopt hoisted", True, {"variant": "unopt"}),
             ("mpc opt RING32", True, {"variant": "opt", "fp": ring32})]
    if cell == "pubmed_4p":
        cases.append(("mpc unopt not hoisted", True,
                      {"variant": "unopt", "hoist_agg": False}))
    if cell == DENSE_CELL:
        cases += [(f"{label} dense", mpc, {"variant": "opt",
                                           "aggregation": "dense"})
                  for label, mpc in (("opt", False), ("mpc opt", True))]
    return cases


def graph_run(engine) -> dict:
    """The calls ``graph_phase`` makes of each engine first: FORWARDS
    requests, EPOCHS_CHECKED epochs through ``run_epochs_scan``, one more
    request, the kernel counts (the metrics kernel's too) set to 0 just
    before the requests and the epochs and read just after, the
    generator's offset after each call (secret-shared). The second
    request's logits, the epochs' metrics and the last request's metrics
    are kept with a copy taken at once."""
    from cognn_tpu_torch.ops import metrics as metric_ops

    gen = getattr(engine, "_gen", None)
    spmms = [engine.spmm] if engine.spmm is not None else []
    run = {"z": [], "offsets": []}

    def offset():
        if gen is not None:
            run["offsets"].append(gen.get_offset())

    reset_counts(spmms)
    metric_ops.launches = 0
    for _ in range(FORWARDS):
        run["z"].append(engine.forward()[0])
        offset()
    run["forward_counts"] = {**read_counts(spmms),
                             "gcn_metrics": metric_ops.launches}
    reset_counts(spmms)
    metric_ops.launches = 0
    run["metrics"] = engine.run_epochs_scan(EPOCHS_CHECKED)
    run["epoch_counts"] = {**read_counts(spmms),
                           "gcn_metrics": metric_ops.launches}
    offset()
    z, _, run["request_metrics"] = engine.forward()
    run["z"].append(z)
    offset()
    run["held"] = [(run["z"][1], run["z"][1].clone())] + [
        (v, v.clone()) for v in (*run["metrics"].values(),
                                 *run["request_metrics"].values())]
    return run


def graph_hold(label: str, mpc: bool, got, want) -> bool:
    """Graphed ``got`` against eager ``want`` (tensors, or lists of them):
    secret-shared ``torch.equal``, plaintext within LOGITS_TOL_OF_MAX of
    the largest |want|. Raises; returns whether all are ``torch.equal``."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    equal = True
    for a, b in zip(got, want, strict=True):
        if torch.equal(a, b):
            continue
        equal = False
        err = (a.double() - b.double()).abs().max().item()
        tol = LOGITS_TOL_OF_MAX * b.double().abs().max().item()
        if mpc or not err <= tol:
            raise AssertionError(f"{label}: graphed differs from eager by "
                                 f"{err!r} (tolerance "
                                 f"{0.0 if mpc else tol!r})")
    return equal


def graph_case(cell: str, plan, param, label: str, mpc: bool, kw: dict,
               n_edges: int) -> dict:
    """One engine of ``graph_phase``: the graphed engine (the default) and
    an eager one (``cuda_graphs=False``) built from the same seeds, each
    through :func:`graph_run` with peak device memory read around its build
    and calls; then requests and epochs timed in turns, one epoch of each
    profiled. Gates: logits, every epoch's and the last request's metrics
    and the (revealed) weights graphed == eager (:func:`graph_hold`) after
    the checked epochs and again after the timed ones; the counts of both
    each FORWARDS and EPOCHS_CHECKED times :func:`forward_counts` /
    :func:`epoch_counts` and one metrics kernel a call (through replays);
    the generator's offset graphed == eager after every
    call, and growing; the kept results unchanged by every later call.
    Returns the graphed engine's ``forward_counts`` and ``epoch_counts``."""
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.mpc import MpcGasEngine

    name = f"graph {cell} {label}"
    runs = {}
    for mode, flag in (("eager", False), ("graphed", None)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        alloc = torch.cuda.memory_allocated()
        res = torch.cuda.memory_reserved()
        engine = (MpcGasEngine if mpc else GasEngine)(
            plan, param, device="cuda", cuda_graphs=flag, **kw)
        if engine._graphs.enabled != (flag is None):
            raise AssertionError(f"{name}: {mode} engine has graphs "
                                 f"{engine._graphs.enabled}")
        runs[mode] = graph_run(engine)
        torch.cuda.synchronize()
        runs[mode]["engine"] = engine
        runs[mode]["peak"] = (torch.cuda.max_memory_allocated() - alloc,
                              torch.cuda.max_memory_reserved() - res)
    eager, graphed = runs["eager"], runs["graphed"]
    g_eng, e_eng = graphed["engine"], eager["engine"]
    want_f = {**{k: FORWARDS * v for k, v in forward_counts(g_eng).items()},
              "gcn_metrics": FORWARDS}
    want_e = {**{k: EPOCHS_CHECKED * v
                 for k, v in epoch_counts(g_eng).items()},
              "gcn_metrics": EPOCHS_CHECKED}
    for mode, run in runs.items():
        if run["forward_counts"] != want_f or run["epoch_counts"] != want_e:
            raise AssertionError(f"{name} {mode}: launches "
                                 f"{run['forward_counts']} in {FORWARDS} "
                                 f"forwards, {run['epoch_counts']} in "
                                 f"{EPOCHS_CHECKED} epochs; want {want_f}, "
                                 f"{want_e}")

    def weights(engine):
        return engine.reveal_weights() if mpc else engine.weights

    equal = {"logits": graph_hold(name, mpc, graphed["z"], eager["z"]),
             "metrics": graph_hold(name, mpc,
                                   [*graphed["metrics"].values(),
                                    *graphed["request_metrics"].values()],
                                   [*eager["metrics"].values(),
                                    *eager["request_metrics"].values()]),
             "weights": graph_hold(name, mpc, weights(g_eng),
                                   weights(e_eng))}

    def offsets_held(when: str) -> None:
        if not mpc:
            return
        g, e = g_eng._gen.get_offset(), e_eng._gen.get_offset()
        got = graphed["offsets"]
        if got != eager["offsets"] or g != e or any(
                b <= a for a, b in zip(got, got[1:])):
            raise AssertionError(f"{name}: generator offsets {when} graphed "
                                 f"{got} / {g}, eager {eager['offsets']} / "
                                 f"{e}")

    offsets_held("after the checked calls")
    pool = tuple(g_eng._graphs._pool)
    pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == pool)

    def requests(engine):
        for _ in range(GRAPH_CALLS_TIMED):
            engine.forward()

    def epochs(engine):
        engine.run_epochs_scan(GRAPH_EPOCHS_TIMED)

    ms = {}
    for what, fn, calls in (("request", requests, GRAPH_CALLS_TIMED),
                            ("epoch", epochs, GRAPH_EPOCHS_TIMED)):
        ms[what] = {"eager": [], "graphed": []}
        for mode in ("eager", "graphed", "graphed", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(runs[mode]["engine"])
            torch.cuda.synchronize()
            ms[what][mode].append((time.perf_counter() - t0) * 1e3 / calls)
    prof = {mode: profile_phase(f"{name} {mode} epoch",
                                runs[mode]["engine"].run_epoch)
            for mode in ("graphed", "eager")}
    scan = {mode: profile_phase(f"{name} {mode} scan", lambda: epochs(
        runs[mode]["engine"])) for mode in ("graphed", "eager")}
    graph_hold(name, mpc, weights(g_eng), weights(e_eng))
    if mpc:
        graphed["offsets"].append(g_eng._gen.get_offset())
        eager["offsets"].append(e_eng._gen.get_offset())
    offsets_held("after the timed and profiled calls")
    for kept, copy in graphed["held"]:
        if not torch.equal(kept, copy):
            raise AssertionError(f"{name}: a result handed out earlier "
                                 "changed")
    capture = capture_s(g_eng)
    epoch_ms = min(ms["epoch"]["graphed"])
    print(f"{name}: graphed == eager (torch.equal: {equal}; plaintext "
          f"within {LOGITS_TOL_OF_MAX} x max): logits of {FORWARDS + 1} "
          f"requests, metrics of {EPOCHS_CHECKED} epochs and the last "
          f"request, weights after "
          f"them and again after the timed and profiled ones; launches "
          f"{graphed['forward_counts']} in {FORWARDS} "
          f"requests, {graphed['epoch_counts']} in {EPOCHS_CHECKED} epochs, "
          f"as eager; generator offsets {graphed['offsets']} as eager; "
          f"earlier results unchanged", flush=True)
    print(f"{name}: ms a request over {GRAPH_CALLS_TIMED} (in turns) graphed "
          f"{ms['request']['graphed']!r} eager {ms['request']['eager']!r}; "
          f"ms an epoch over {GRAPH_EPOCHS_TIMED} graphed "
          f"{ms['epoch']['graphed']!r} eager {ms['epoch']['eager']!r}; "
          f"edge-iterations/s graphed "
          f"{g_eng.epoch_layers * n_edges / epoch_ms * 1e3!r}; one epoch "
          f"busy {prof['graphed']['busy_ms']!r} ms idle "
          f"{prof['graphed']['idle_share']!r} graphed, "
          f"{prof['eager']['busy_ms']!r} / {prof['eager']['idle_share']!r} "
          f"eager; a scan of {GRAPH_EPOCHS_TIMED} busy "
          f"{scan['graphed']['busy_ms']!r} ms idle "
          f"{scan['graphed']['idle_share']!r} graphed, "
          f"{scan['eager']['busy_ms']!r} / {scan['eager']['idle_share']!r} "
          f"eager; host launch calls an epoch graphed "
          f"{prof['graphed']['host_calls']} eager "
          f"{prof['eager']['host_calls']}; peak device memory (allocated, "
          f"reserved) over the build and the checked calls graphed "
          f"{graphed['peak']} B eager {eager['peak']} B; the graphs' pool "
          f"{pool_bytes or 'not measured'} B; capture s {capture} (the "
          f"tracer's graphs.capture span, captured again with the tracer "
          f"on); {card_line()}", flush=True)
    return {k: graphed[k] for k in ("forward_counts", "epoch_counts")}


def capture_s(engine) -> dict:
    """Seconds of a capture of the engine's forward and epoch, read from
    the tracer's ``graphs.capture`` span: its graphs dropped and each step
    captured again with the tracer on, after the checks (an epoch moves its
    weights; the graphs timed before hold no phase boundaries). Then one
    replay of each: its phase table, read from the stamp kernel's slots,
    tiles the replay (``epoch_phases_us``, ``forward_phases_us``)."""
    from cognn_tpu_torch.utils.logging_utils import (collect, reset,
                                                     snapshot, tracing)

    out = {}
    for step, call in (("forward", engine.forward),
                       ("epoch", engine.run_epoch)):
        engine._graphs.clear()
        with tracing():
            reset()
            call()
            out[step] = snapshot()["spans"]["graphs.capture"]["s"]
            call()  # a replay
            torch.cuda.synchronize()
            units = collect()
            reset()
        unit = units[-1]
        if unit["step"] != step or unit["total_ns"] <= 0 \
                or sum(unit["ns"].values()) != unit["total_ns"]:
            raise AssertionError(f"{step}: phase table {unit}")
        out[f"{step}_phases_us"] = {k: v / 1e3 for k, v in unit["ns"].items()}
    return out


def graph_phase(cell: str, plan, param, n_edges: int) -> dict:
    """Requests and epochs as CUDA graph replays against the eager engines
    that the graphs are captured from: :func:`graph_case` for each of
    :func:`graph_cases`. Returns each case's counts by its label."""
    t0 = time.perf_counter()
    counts = {label: graph_case(cell, plan, param, label, mpc, kw, n_edges)
              for label, mpc, kw in graph_cases(cell)}
    print(f"graph {cell}: {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def metrics_inputs(P: int, V: int, C: int, seed: int, device="cuda",
                   plan_arrays=None) -> tuple:
    """Arguments of ``ops/metrics.py`` ``gcn_metrics``: softmax rows of
    random logits from ``seed``, every 37th row all equal (ties) and every
    53rd row's first probability exactly 0 (the clamp); labels and masks
    random (the last 17·p rows of party p invalid), or the cell's own from
    ``plan_arrays`` (``plan_tensors``' dict)."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(P, V, C, generator=g) * 3
    z[:, ::37] = 1.0
    prob = torch.softmax(z, -1)
    prob[:, ::53, 0] = 0.0
    if plan_arrays is not None:
        t = plan_arrays
        return (prob.to(device), t["labels"], t["vertex_mask"],
                t["train_mask"], t["val_mask"], t["border"], t["num_local"])
    labels = torch.randint(0, C, (P, V), generator=g)
    num_local = torch.tensor([max(V - 17 * p, 0) for p in range(P)])
    valid = torch.arange(V)[None] < num_local[:, None]
    split = torch.rand(P, V, generator=g)
    train, val = (split < 0.3) & valid, (split > 0.8) & valid
    border = torch.rand(P, V, generator=g) < 0.4
    return tuple(t.to(device) for t in (prob, labels, valid, train, val,
                                        border, num_local.clamp(min=1)))


def metrics_edges(args) -> tuple:
    """``args`` of 4 parties with party 0 no train rows, party 1 no test
    rows (every valid row train or val), party 2 no border rows and party 3
    a train row outside its valid rows."""
    prob, labels, valid, train, val, border, num_local = (
        t.clone() for t in args)
    train[0] = False
    val[1] = valid[1] & ~train[1]
    border[2] = False
    train[3, -1] = True
    return prob, labels, valid, train, val, border, num_local


def metrics_non_finite(args) -> tuple:
    """``args`` of 4 parties with a NaN (party 0), +inf (party 1) and a
    negative probability (party 2) in a column other than row 0's label,
    and a NaN in party 3's last row, which is not valid: the plain
    version's loss is NaN for parties 0 to 2 (its one-hot row sum takes 0
    times every column's log) and finite for party 3."""
    prob, labels, valid, train, val, border, num_local = (
        t.clone() for t in args)
    C = prob.shape[-1]
    for p, x in enumerate((float("nan"), float("inf"), -0.25)):
        prob[p, 0, (labels[p, 0] + 1) % C] = x
    prob[3, -1, 0] = float("nan")
    return prob, labels, valid, train, val, border, num_local


def metrics_held(what: str, got: dict, want: dict) -> None:
    """Raises unless every metric of ``got`` is ``torch.equal`` to
    ``want``'s, with the same keys, dtypes and shapes (a NaN where
    ``want`` has a NaN, the rest ``torch.equal``)."""
    if list(got) != list(want):
        raise AssertionError(f"{what}: keys {list(got)}, want {list(want)}")
    for k, v in got.items():
        v, w = v.cpu(), want[k].cpu()
        nan = v.isnan()
        if v.dtype != w.dtype or v.shape != w.shape or not torch.equal(
                nan, w.isnan()) or not torch.equal(v[~nan], w[~nan]):
            raise AssertionError(f"{what}: {k} kernel {v.tolist()} "
                                 f"({v.dtype}), plain {w.tolist()} "
                                 f"({w.dtype})")


def metrics_phase(cell: str, plan, param, launch_ms: float) -> dict:
    """The metrics kernel (``csrc/metrics.cu``) against its plain version
    on the card, every metric ``torch.equal``: at the cell's shape with
    its own labels and masks and METRICS_SEEDS random predictions (the
    kernel's launches counted, one a call); each party alone, ``[1, V,
    C]`` on the second card where there is one (else this one), equal to
    its row of the stacked result; the cases of :func:`metrics_edges` and
    of :func:`metrics_non_finite`; every C of METRICS_WIDTHS, V of
    METRICS_ROWS, and C = MAX_CLASSES (C + 1 refused). Then kernel and
    plain version timed (warm L2) beside the bound: the bytes read and
    written at the memory rate, or the launch floor ``launch_ms``."""
    from cognn_tpu_torch.engine.plan import plan_tensors, set_split
    from cognn_tpu_torch.ops import metrics as metric_ops
    from cognn_tpu_torch.ops.metrics import (MAX_CLASSES, gcn_metrics,
                                             gcn_metrics_plain)

    t0 = time.perf_counter()
    P, V, C = plan.num_parties, plan.V, param.num_labels
    set_split(plan, param.train_ratio, param.val_ratio)  # as the engines
    arrays = plan_tensors(plan, torch.device("cuda"))
    other = torch.device(f"cuda:{min(1, torch.cuda.device_count() - 1)}")
    checked = 0
    for seed in METRICS_SEEDS:
        args = metrics_inputs(P, V, C, seed, plan_arrays=arrays)
        metric_ops.launches = 0
        got = gcn_metrics(*args)
        if metric_ops.launches != 1:
            raise AssertionError(f"metrics {cell}: {metric_ops.launches} "
                                 "launches a call")
        metrics_held(f"metrics {cell} seed {seed}", got,
                     gcn_metrics_plain(*args))
        for p in range(P):
            alone = gcn_metrics(*(a[p:p + 1].to(other) for a in args))
            metrics_held(f"metrics {cell} seed {seed} party {p} alone on "
                         f"{other}", alone,
                         {k: v[p:p + 1] for k, v in got.items()})
        checked += 1 + P
    for seed in METRICS_SEEDS:
        for edges in (metrics_edges, metrics_non_finite):
            args = edges(metrics_inputs(4, 300, C, seed))
            metrics_held(f"metrics {edges.__name__} seed {seed}",
                         gcn_metrics(*args), gcn_metrics_plain(*args))
            checked += 1
    for c in METRICS_WIDTHS:
        args = metrics_inputs(*METRICS_C_SHAPE, c, c)
        metrics_held(f"metrics C={c}", gcn_metrics(*args),
                     gcn_metrics_plain(*args))
        checked += 1
    for v in METRICS_ROWS:
        args = metrics_inputs(2, v, C, v)
        metrics_held(f"metrics V={v}", gcn_metrics(*args),
                     gcn_metrics_plain(*args))
        checked += 1
    args = metrics_inputs(2, 40, MAX_CLASSES, 5)
    metrics_held(f"metrics C={MAX_CLASSES}", gcn_metrics(*args),
                 gcn_metrics_plain(*args))
    checked += 1
    try:
        gcn_metrics(*metrics_inputs(2, 40, MAX_CLASSES + 1, 5))
    except ValueError:
        pass
    else:
        raise AssertionError(f"metrics: C = {MAX_CLASSES + 1} not refused")
    args = metrics_inputs(P, V, C, 0, plan_arrays=arrays)
    torch.cuda.synchronize()
    ms = device_ms(lambda: gcn_metrics(*args), TIMED_CALLS)
    plain_ms = device_ms(lambda: gcn_metrics_plain(*args), TIMED_CALLS)
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + P * (6 * 4 + 8))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"metrics {cell} [{P}, {V}, {C}]: {checked} calls torch.equal to "
          f"the plain version (the cell's masks x {len(METRICS_SEEDS)} "
          f"seeds, each party alone on {other}, edge cases, non-finite "
          f"probabilities, C = {METRICS_WIDTHS.start}.."
          f"{METRICS_WIDTHS.stop - 1} and {MAX_CLASSES}, V in "
          f"{list(METRICS_ROWS)}); kernel_ms={ms!r} plain_ms={plain_ms!r} "
          f"bound_ms={max(t_bytes, launch_ms)!r} (bytes {t_bytes!r} ms for "
          f"{nbytes} B, launch floor {launch_ms!r} ms); "
          f"{time.perf_counter() - t0:.1f} s; {card_line()}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_bytes, launch_ms),
            "bound_by": "bytes" if t_bytes >= launch_ms else "launch floor",
            "check": "torch.equal", "max_abs_err": 0.0,
            "shape": f"prob [{P}, {V}, {C}], the cell's labels and masks"}


def cell_graphs(dataset: str, parties: int):
    """The parties' graphs of a cell as ``party_plan`` builds them
    (synthetic ``dataset``, vertex v to party v mod ``parties``), and its
    :class:`GNNParam`: the float64 oracle reads graphs, not plans."""
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid
    from cognn_tpu_torch.tools.run_cluster import build_graphs

    ds = synthetic_planetoid(dataset)
    return build_graphs(ds, parties), ds.param


def oracle_phase(cell: str, dataset: str, parties: int) -> None:
    """The engines against the port's float64 ``GasOracle``
    (``cognn_tpu_torch/models/oracle.py``, plain numpy on the host) at the
    cell's full width: CoGNN-Opt and CoGNN (unopt), EPOCHS_CHECKED epochs
    from the same initial weights, then one forward (the oracle: the next
    epoch's L forward phases). Plaintext (the CSR kernel under ``auto``)
    logits and weights within ORACLE_TOL_OF_MAX of the oracle's largest;
    secret-shared (unopt hoisted) logits within MPC_LOGITS_TOL and weights
    within MPC_WEIGHTS_TOL of it. Prints each distance and the oracle's
    time."""
    from cognn_tpu_torch.engine import GasEngine, build_device_plan
    from cognn_tpu_torch.models.oracle import GasOracle
    from cognn_tpu_torch.mpc import MpcGasEngine

    graphs, param = cell_graphs(dataset, parties)
    plan = build_device_plan(graphs)
    L = param.num_layers
    for variant in ("opt", "unopt"):
        t0 = time.perf_counter()
        orc = GasOracle(graphs, param, variant)
        orc.run_epochs(EPOCHS_CHECKED)
        w_or = [np.stack([p.weights[l] for p in orc.parties])
                for l in range(L)]
        orc.run(L)
        z_or = [p.z[L - 1] for p in orc.parties]
        s = time.perf_counter() - t0
        for mpc in (False, True):
            label = f"oracle {cell} {variant}" + " mpc" * mpc
            engine = (MpcGasEngine if mpc else GasEngine)(
                plan, param, variant, device="cuda")
            engine.run_epochs(EPOCHS_CHECKED)
            w = [x.double().cpu().numpy() for x in weights_of(engine)]
            z = engine.forward()[0].double().cpu().numpy()
            w_err = max(float(np.abs(a - b).max()) for a, b in zip(w, w_or))
            z_err = max(float(np.abs(z[p, :len(want)] - want).max())
                        for p, want in enumerate(z_or))
            if mpc:
                w_tol, z_tol = MPC_WEIGHTS_TOL, MPC_LOGITS_TOL
            else:
                w_tol = ORACLE_TOL_OF_MAX * max(float(np.abs(b).max())
                                                for b in w_or)
                z_tol = ORACLE_TOL_OF_MAX * max(float(np.abs(b).max())
                                                for b in z_or)
            if not (w_err <= w_tol and z_err <= z_tol):
                raise AssertionError(
                    f"{label}: weights {w_err!r} (tol {w_tol!r}), logits "
                    f"{z_err!r} (tol {z_tol!r}) from the float64 oracle")
            print(f"{label}: {EPOCHS_CHECKED} epochs and a forward of "
                  f"{engine.aggregation}; max|W - W_oracle|={w_err!r} (tol "
                  f"{w_tol!r}), max|z - z_oracle|={z_err!r} (tol "
                  f"{z_tol!r}); oracle {s!r} s on the host", flush=True)


def citeseer_phase(mac_ms: float) -> list:
    """CiteSeer's 3,703-wide layer 0, which the matrix's CiteSeer rows run
    and no cell above does. The counts set to 0 just before and read just
    after: one secret-shared CoGNN-Opt epoch at 3 parties (K3 at the
    forward's ``[3, V, 3703] @ [3, 3703, 16]`` and the weight gradient's
    ``[3, 3703, V] @ [3, V, 16]``, 5 launches), one plaintext unopt epoch at
    5 parties (the f32 CSR kernel at D = 3703, 3 launches) and one
    secret-shared unopt forward at 5 parties without the hoist (the ring
    CSR kernel at D = 3703, 2 launches); each checked as
    :func:`launch_counts` says and its metrics finite. Then K3 at those two
    shapes (full-range operands, ``torch.equal``, warm and cold L2) and both
    CSR kernels at D = 3703 (f32 ``torch.equal`` on integer-valued rows and
    within KERNEL_TOL on normal rows, ring ``torch.equal``, warm and cold)
    held to their plain versions and timed beside the library calls.
    Returns the kernels line's entries."""
    from cognn_tpu_torch.core.ring import ring_from_u64
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.harness.datasets import party_plan
    from cognn_tpu_torch.mpc import MpcGasEngine

    plan3, param = party_plan("citeseer", 3)
    plan5, _ = party_plan("citeseer", 5)
    F = param.input_dim
    mpc3 = MpcGasEngine(plan3, param, "opt", device="cuda")
    plain5 = GasEngine(plan5, param, "unopt", device="cuda")
    mpc5 = MpcGasEngine(plan5, param, "unopt_inference", hoist_agg=False,
                        device="cuda")
    spmms = (mpc3.spmm, plain5.spmm, mpc5.spmm)
    runs = ((mpc3, mpc3.run_epoch, epoch_counts(mpc3)),
            (plain5, plain5.run_epoch, epoch_counts(plain5)),
            (mpc5, lambda: mpc5.forward()[2], forward_counts(mpc5)))
    launched = {}
    for engine, run, want in runs:
        reset_counts(spmms)
        metrics = run()
        torch.cuda.synchronize()
        got = read_counts(spmms)
        if got != want:
            raise AssertionError(f"citeseer {engine.variant} "
                                 f"{engine.aggregation}: launches {got}, "
                                 f"want {want}")
        check_metrics(f"citeseer {engine.variant}", engine, metrics)
        launched[engine.variant] = got
    print(f"citeseer: launches {launched} (3p opt epoch mpc, 5p unopt epoch "
          f"plaintext, 5p unopt forward mpc not hoisted)", flush=True)
    V3 = plan3.V
    k3_shapes = [(3, V3, F, param.hidden_dim), (3, F, V3, param.hidden_dim)]
    k3 = ring_matmul_phase("citeseer_3p", k3_shapes)
    spmm = plain5.spmm
    dup = with_repeats(spmm)
    integer_rows_check("citeseer_5p", spmm, dup, F)
    f32 = kernel_phase("citeseer_5p", spmm, dup, (F,))
    ring = ring_spmm_phase("citeseer_5p", spmm, dup, (F,), mac_ms)
    rng = np.random.default_rng(13)
    h = torch.from_numpy(rng.standard_normal((spmm.n_src, F),
                                             dtype=np.float32)).cuda()
    hs = ring_from_u64(rng.integers(0, 1 << 64, (2, spmm.n_src, F),
                                    dtype=np.uint64), device="cuda")
    f32["cold_ms"] = cold_ms(lambda: spmm(h))
    ring["cold_ms"] = cold_ms(lambda: spmm.ring(hs))
    print(f"citeseer_5p D={F} cold L2: f32 kernel_ms={f32['cold_ms']!r}, "
          f"ring kernel_ms={ring['cold_ms']!r}", flush=True)
    csr = f"n={spmm.n_dst}, nnz={spmm.nnz}"
    return [{
        "name": "ring_matmul_i64[citeseer_3p]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
        "replaces": RING_MATMUL_REPLACES,
        "jax_path": RING_MATMUL_JAX_PATH,
        "launches": launched["opt"]["ring_matmul_i64"],
        "shape": "CiteSeer 3p layer 0, forward and weight gradient, 2 of an "
                 "epoch's 5 launches (launches: one epoch's): " + ", ".join(
                     f"[{b},{n},{k}]@[{b},{k},{m}]"
                     for b, n, k, m in k3_shapes),
        **k3,
    }, {
        "name": "spmm_csr_f32[citeseer_5p unopt]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/spmm.cu",
        "replaces": "cognn_tpu/ops/pallas_spmm.py:27",
        "jax_path": "K2 under aggregation='bcsr' (26^2 < 1024 blocks); "
                    "unopt: layer 0 at the input width",
        "launches": launched["unopt"]["spmm_csr_f32"],
        "shape": f"CiteSeer 5p unopt layer 0: D = {F}, {csr}, 1 of an "
                 f"epoch's 3 launches (launches: one epoch's)",
        **f32,
    }, {
        "name": "spmm_csr_i64[citeseer_5p unopt]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/spmm.cu",
        "replaces": "cognn_tpu/ops/pallas_spmm.py:27",
        "jax_path": "share instantiation (_bcsr_agg_shares, "
                    "cognn_tpu/mpc/engine.py:269); unopt layer 0",
        "launches": launched["unopt_inference"]["spmm_csr_i64"],
        "shape": f"CiteSeer 5p secret-shared unopt layer 0 without the "
                 f"hoist: 2 shares, D = {F}, {csr}, 1 of a forward's 2 "
                 f"launches (launches: one forward's)",
        **ring,
    }]


def matrix_rows(path: Path) -> dict:
    """{(setting, dataset): {column: value}} of a summary table."""
    rows = {}
    lines = path.read_text().splitlines()
    head = next(i for i, line in enumerate(lines)
                if line.startswith("| setting |"))
    cols = [c.strip() for c in lines[head].strip("|").split("|")]
    for line in lines[head + 2:]:
        if line.startswith("|"):
            cells = dict(zip(cols, (c.strip()
                                    for c in line.strip("|").split("|"))))
            rows[cells["setting"], cells["dataset"]] = cells
    return rows


def matrix_phase() -> None:
    """The port's evaluation-matrix driver, ``python -m
    cognn_tpu_torch.tools.run_cluster``, as subprocesses on the card in a
    temporary directory (MATRIX_RUNS), then its summarizer. Every row's
    test accuracy within MATRIX_ACC_TOL of the same row of
    results/matrix/SUMMARY.md (the JAX package's run, read as data; the
    secret-shared smallest run, which has no row there, against the
    plaintext ``smallest_efficiency`` row); every party's ``.comm`` counted
    (``"measured": true``) and equal to the closed-form bytes. Prints both
    accuracies, the loss and us/iter beside the card."""
    import tempfile

    from cognn_tpu_torch.tools import summarize_matrix
    from cognn_tpu_torch.tools.log_parse import parse_comm_file

    tpu = matrix_rows(ROOT / "results" / "matrix" / "SUMMARY.md")
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        for args in MATRIX_RUNS:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "cognn_tpu_torch.tools.run_cluster",
                 *args], cwd=tmp, env=env, capture_output=True, text=True,
                timeout=900)
            if r.returncode != 0:
                raise AssertionError(f"run_cluster {args}: rc "
                                     f"{r.returncode}\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-4000:]}")
            for line in r.stdout.splitlines():
                print(f"run_cluster: {line}", flush=True)
            print(f"run_cluster {' '.join(args)}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = tmp / "SUMMARY.md"
        summarize_matrix.main(["--log-root", str(tmp / "log"), "--comm-root",
                               str(tmp / "comm"), "--out", str(out),
                               "--device", card])
        rows = matrix_rows(out)
        want = {("smallest_efficiency", "cora"), ("mpc_smallest_efficiency",
                                                   "cora"),
                ("fedgnn_2p", "cora"), ("mpc_opt_accuracy_3p", "citeseer"),
                ("unopt_accuracy_5p", "citeseer")}
        if set(rows) != want:
            raise AssertionError(f"matrix: rows {sorted(rows)}, want "
                                 f"{sorted(want)}")
        for (setting, ds), row in sorted(rows.items()):
            ref_key = (("smallest_efficiency", ds)
                       if setting == "mpc_smallest_efficiency"
                       else (setting, ds))
            ref = tpu[ref_key]
            diff = float(row["test acc"]) - float(ref["test acc"])
            files = sorted((tmp / "comm" / setting).glob(f"{ds}_*.comm"))
            if len(files) != int(row["P"]):
                raise AssertionError(f"matrix {setting} {ds}: {len(files)} "
                                     f".comm files for {row['P']} parties")
            for f in files:
                c = parse_comm_file(f)
                if not (c["measured"] and c["per_epoch_bytes"]
                        == c["analytic_per_epoch_bytes"]):
                    raise AssertionError(
                        f"matrix {setting} {ds} {f.name}: measured "
                        f"{c['measured']}, bytes {c['per_epoch_bytes']}, "
                        f"analytic {c['analytic_per_epoch_bytes']}")
            print(f"matrix {setting} {ds}: P={row['P']} test acc "
                  f"{row['test acc']} (results/matrix/SUMMARY.md "
                  f"{' '.join(ref_key)}: {ref['test acc']}, {diff:+.4f}); "
                  f"loss {row['loss']} ({ref['loss']}); us/iter "
                  f"{row['us/iter']} over {row['iters']} iterations; "
                  f"MB/party {row['MB/party']} counted == analytic "
                  f"({row['sharded backend']}); rounds/epoch "
                  f"{row['rounds/epoch']}; {card}", flush=True)
            if not abs(diff) <= MATRIX_ACC_TOL:
                raise AssertionError(f"matrix {setting} {ds}: test acc "
                                     f"{row['test acc']}, matrix "
                                     f"{ref['test acc']}, more than "
                                     f"{MATRIX_ACC_TOL} apart")


def run_tool(label: str, main, argv) -> str:
    """``main(argv)`` of a tool or example in this process, its standard
    output captured, printed with ``label`` before each line, and
    returned. Raises unless it returns 0."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"{label}: {line}", flush=True)
    print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc}")
    return out


def profile_tool_phase(cell: str, dataset: str, parties: int,
                       outdir: Path) -> None:
    """``cognn_tpu_torch.tools.profile_epoch`` on one cell, secret-shared
    opt: its engine warm, one untraced scan timed, every count set to 0
    just before the traced window and read just after, the trace parsed
    with ``kernel`` leaves (a window in which the profiler lost records,
    a launch without its device event or a device event without its
    launch, is traced again, at most PROFILE_ATTEMPTS windows). Every
    launch of each on-path kernel must be attributed to its bucket
    (PROFILE_KERNELS), as many as its wrapper counted; the buckets must
    sum to every device event's time in the trace; nothing may be
    unlinked. Prints the tool's table and reference
    tags, the ``<other:...>`` share, and reads the breakdown log back
    with the port's ``tools/log_parse.py``."""
    from cognn_tpu_torch.tools import profile_epoch as pe
    from cognn_tpu_torch.tools.log_parse import parse_party_log

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _, eng = pe.build_engine(dataset, parties, "auto", "opt", dev)
    eng.run_epochs_scan(PROFILE_SCAN)
    torch.cuda.synchronize()
    untraced_us = pe.untraced_epoch_s(eng, PROFILE_SCAN, dev) * 1e6
    path = outdir / f"{cell}.trace.json.gz"
    n_epochs = PROFILE_SCAN * PROFILE_REPS
    label = f"tools profile_epoch {cell}"
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        wall = pe.trace_epochs(eng, PROFILE_SCAN, PROFILE_REPS, path, dev,
                               on_start=lambda: reset_counts([eng.spmm]))
        counts = read_counts([eng.spmm])
        trace = pe.load_trace(path)
        result = pe.parse_trace(trace, "kernel",
                                plane=f"{card_line()} (cuda:0)")
        unlinked = sum(n for (b, _), n in result.kernels.items()
                       if b == pe.UNLINKED)
        if result.lost == 0 and unlinked == 0:
            break
        print(f"{label}: window {attempt}: {result.lost} launches without "
              f"their device event, {unlinked} device events without their "
              "launch (records lost by the profiler)", flush=True)
    else:
        raise AssertionError(f"{label}: the profiler lost device records in "
                             f"all {PROFILE_ATTEMPTS} windows")
    device_ps = sum(round(e["dur"] * 1e6) for e in trace["traceEvents"]
                    if e.get("cat") in pe.DEVICE_CATS)
    if not (sum(result.by_scope.values()) == result.total == device_ps
            and device_ps > 0):
        raise AssertionError(f"{label}: buckets sum to "
                             f"{sum(result.by_scope.values())} ps, total "
                             f"{result.total}, trace {device_ps}")
    if result.by_scope.get(pe.UNLINKED, 0) != 0:
        raise AssertionError(f"{label}: {result.by_scope[pe.UNLINKED]} ps "
                             "of device time without a launch")
    for pattern, bucket, counter in PROFILE_KERNELS:
        found = Counter()
        for (b, name), n in result.kernels.items():
            if pattern in name:
                found[b] += n
        if set(found) != {bucket} or found[bucket] != counts[counter]:
            raise AssertionError(f"{label}: {pattern} kernels by bucket "
                                 f"{dict(found)}, want all "
                                 f"{counts[counter]} ({counter}) in "
                                 f"{bucket}")
        print(f"{label}: {found[bucket]} {pattern} launches in {bucket} "
              f"== {counter} {counts[counter]} over {n_epochs} epochs",
              flush=True)
    for (b, name), n in sorted(result.kernels.items()):
        if b in ("matmul", "oga") or b.startswith("<other"):
            print(f"{label}:   {b} x{n} {name[:100]}", flush=True)
    log_file = outdir / f"{cell}.breakdown"
    pe.report(result.plane, result.by_scope, result.total, n_epochs,
              str(log_file))
    read = parse_party_log(log_file)["durations"]
    for tag, scopes in pe.REF_TAGS.items():
        want = sum(result.by_scope.get(b, 0) for b in scopes) / 1e12 / n_epochs
        if len(read[tag]) != 1 or abs(read[tag][0] - want) > 5e-7:
            raise AssertionError(f"{label}: ::{tag} read back {read[tag]}, "
                                 f"want {want!r}")
    other = sum(v for k, v in result.by_scope.items()
                if k.startswith("<other"))
    per_epoch_us = result.total / 1e6 / n_epochs
    print(f"{label}: device {per_epoch_us!r} us an epoch, <other:...> "
          f"share {other / result.total!r}; untraced wall "
          f"{untraced_us!r} us an epoch, traced wall (incl. profiler) "
          f"{wall / n_epochs * 1e6!r}; breakdown log read back by "
          f"log_parse; {time.perf_counter() - t0:.1f} s", flush=True)


def tools_phase() -> None:
    """The experiment tools on the card: the per-phase breakdown on each
    PROFILE_CELLS cell (``profile_tool_phase``); ``network_model`` on Cora
    2p --mpc, opt and unopt, its bytes and rounds counted in gloo party
    processes and equal to the closed form, the grid printed;
    ``bench_scaling`` (SCALING_ARGS; the parties share this card over
    gloo, with its NOTE), its JSON held to epoch_layers x E / epoch_s; the
    three examples (EXAMPLE_EPOCHS epochs), their final metrics printed
    and the secret-shared one's loss within MPC_LOGITS_TOL of plaintext."""
    import tempfile

    from cognn_tpu_torch.engine import build_device_plan
    from cognn_tpu_torch.engine.comm_model import (analytic_bytes_per_epoch,
                                                   analytic_rounds_per_epoch)
    from cognn_tpu_torch.examples import (analytics, train_plaintext,
                                          train_secret_shared)
    from cognn_tpu_torch.harness.datasets import synthetic_planetoid
    from cognn_tpu_torch.tools import bench_scaling, network_model
    from cognn_tpu_torch.tools.run_cluster import build_graphs

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for cell, dataset, parties in PROFILE_CELLS:
            profile_tool_phase(cell, dataset, parties, tmp)

        out = tmp / "network.json"
        text = run_tool("tools network_model", network_model.main, [
            "--dataset", "cora", "--parties", "2", "--mpc", "--variants",
            "opt,unopt", "--json", str(out)])
        grids = json.loads(out.read_text())["grids"]
        ds = synthetic_planetoid("cora")
        plan = build_device_plan(build_graphs(ds, 2))
        for variant in ("opt", "unopt"):
            g = grids[variant]
            want = (analytic_bytes_per_epoch(plan, ds.param, variant,
                                             mpc=True,
                                             aggregation=g["backend"]),
                    analytic_rounds_per_epoch(ds.param, variant, mpc=True))
            if (g["bytes_per_epoch"], g["rounds_per_epoch"]) != want:
                raise AssertionError(f"network_model {variant}: "
                                     f"{g['bytes_per_epoch']} "
                                     f"{g['rounds_per_epoch']}, analytic "
                                     f"{want}")
        if text.count("comm counted in 2 gloo party processes") != 2:
            raise AssertionError("network_model: bytes not counted")
        print("tools network_model: counted bytes and rounds == "
              "analytic_bytes_per_epoch / analytic_rounds_per_epoch "
              f"(opt, unopt); compute {grids['opt']['compute_src']}",
              flush=True)

    text = run_tool("tools bench_scaling", bench_scaling.main, SCALING_ARGS)
    rows = json.loads(text.strip().splitlines()[-1])
    n_edges = len(synthetic_planetoid("pubmed").src)
    if [r["parties"] for r in rows] != [1, 2] or "NOTE:" not in text:
        raise AssertionError(f"bench_scaling: {rows}")
    for r in rows:
        want = 6 * n_edges / r["epoch_s"]  # opt, L = 2: 3L phases
        if not (np.isfinite(r["edge_iters_per_s"]) and
                abs(r["edge_iters_per_s"] - want) <= 1e-9 * want):
            raise AssertionError(f"bench_scaling: {r}, want {want}")

    text = run_tool("example train_plaintext", train_plaintext.main,
                    ["--epochs", str(EXAMPLE_EPOCHS)])
    if f"epoch {EXAMPLE_EPOCHS:3d}: loss=" not in text:
        raise AssertionError("train_plaintext: no final metrics")
    text = run_tool("example train_secret_shared", train_secret_shared.main,
                    ["--epochs", str(EXAMPLE_EPOCHS)])
    losses = [float(line.split("loss=")[1].split()[0])
              for line in text.splitlines() if "loss=" in line]
    if len(losses) != 2 or not abs(losses[0] - losses[1]) <= MPC_LOGITS_TOL:
        raise AssertionError(f"train_secret_shared: losses {losses}")
    text = run_tool("example analytics", analytics.main, [])
    if "secret-shared BFS == plaintext BFS: True" not in text:
        raise AssertionError("analytics example: BFS differs")


def gat_edge_check() -> None:
    """The weighted ring SpMM and the ring multi-head SDDMM against their
    plain versions (``torch.equal``) on edge cases, int64 and int32:
    ``edge_graph``'s rows (a hub of 1500 entries, rows one below, at and
    one above the batch sizes, empty first, middle and last rows, repeated
    edges) sorted by destination, at each (heads, f) of GAT_EDGE_HEADS, on
    aligned rows and on rows one element into their storage (the scalar
    path); the SDDMM at each edge count of GAT_SDDMM_EDGES."""
    from cognn_tpu_torch.core.ring import RING32, RING64, ring_from_u64
    from cognn_tpu_torch.ops.sddmm import Sddmm, heads_plain
    from cognn_tpu_torch.ops.spmm import WeightedSpmm, wsum_plain

    rng = np.random.default_rng(11)
    src, dst, n_dst = edge_graph()
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    k = WeightedSpmm(src, dst, EDGE_N_SRC, n_dst, torch.device("cuda"))

    def values(shape, spec):
        return ring_from_u64(rng.integers(0, 1 << 64, shape,
                                          dtype=np.uint64), spec,
                             device="cuda")

    for spec in (RING64, RING32):
        for H, f in GAT_EDGE_HEADS:
            w = values((k.nnz, H), spec)
            for offset in (0, 1):
                h = offset_view(values((EDGE_N_SRC, H * f), spec), offset)
                held(f"weighted spmm ring{spec.bits} H={H} f={f} "
                     f"offset={offset}", k(w, h),
                     wsum_plain(k.indptr, k.indices, w, h), None)
            for n in GAT_SDDMM_EDGES:
                e = rng.integers(0, n_dst, n)
                sd = Sddmm(rng.integers(0, EDGE_N_SRC, n), e, EDGE_N_SRC,
                           n_dst, "cuda")
                b = values((n_dst, H * f), spec)
                for offset in (0, 1):
                    a = offset_view(values((EDGE_N_SRC, H * f), spec), offset)
                    held(f"ring sddmm ring{spec.bits} H={H} f={f} n={n} "
                         f"offset={offset}", sd.ring(a, b, H),
                         heads_plain(sd.src, sd.dst, a, b, H), None)
    print(f"gat kernels: equal to plain on edge cases (rows of "
          f"{np.bincount(dst).max()} entries at most, heads "
          f"{GAT_EDGE_HEADS}, SDDMM edge counts {GAT_SDDMM_EDGES}), int64 "
          f"and int32", flush=True)


def gat_kernel_phase(engine, spec, mac_ms: float) -> tuple:
    """The weighted ring SpMM (forward and transposed) and the ring SDDMM
    at the cell's shapes (each layer's heads), on random full-range values
    of the ring ``spec``: held ``torch.equal`` to the plain versions and
    timed (:func:`measure`; no library computes either in the ring).
    ``mac_ms``: one 64-bit multiply-add (3 IMADs; 1 at 32 bits)."""
    from cognn_tpu_torch.core.ring import ring_from_u64
    from cognn_tpu_torch.ops.sddmm import heads_plain, heads_shape
    from cognn_tpu_torch.ops.spmm import launch_shape, wsum_plain

    e, el = engine.edges, spec.bits // 8
    mac = mac_ms if spec.bits == 64 else mac_ms / MULTIPLIES_PER_MAC
    rng = np.random.default_rng(5)

    def values(shape):
        return ring_from_u64(rng.integers(0, 1 << 64, shape,
                                          dtype=np.uint64), spec,
                             device="cuda")

    heads = list(zip(engine.heads, engine.head_dim))
    ops = {(H, f): e.count * H * f * mac for H, f in heads}

    def wagg_cases():
        for H, f in heads:
            D = H * f
            w, h = values((e.count, H)), values((e.n, D))
            wt = w[e.t_order]
            path = launch_shape(D, el, (h.data_ptr(),))
            nbytes = 4 * (e.n + 1) + (4 + el * H) * e.count + el * 2 * e.n * D
            for name, k, ww in (("forward", e.agg, w),
                                ("transposed", e.agg_t, wt)):
                yield (f"{name} H={H} f={f} n={e.n} entries={e.count} "
                       f"(vec, lanes)={path}",
                       lambda k=k, ww=ww, h=h: k(ww, h),
                       lambda k=k, ww=ww, h=h: wsum_plain(k.indptr,
                                                          k.indices, ww, h),
                       None, nbytes, ops[H, f])

    def sddmm_cases():
        for H, f in heads:
            D = H * f
            a, b = values((e.n, D)), values((e.n, D))
            path = heads_shape(f, el, (a.data_ptr(), b.data_ptr()))
            yield (f"H={H} f={f} edges={e.count} (vec, lanes)={path}",
                   lambda a=a, b=b, H=H: e.sddmm.ring(a, b, H),
                   lambda a=a, b=b, H=H: heads_plain(e.sddmm.src,
                                                     e.sddmm.dst, a, b, H),
                   None, el * 2 * e.n * D + 8 * e.count + el * H * e.count,
                   ops[H, f])

    label = f"ring{spec.bits}"
    return (measure(f"weighted spmm {label} {GAT_CONFIG}", wagg_cases(), None,
                    PLAIN_CALLS),
            measure(f"ring sddmm {label} {GAT_CONFIG}", sddmm_cases(), None,
                    PLAIN_CALLS))


def gat_counts(engine) -> dict:
    """The launch counters of the GAT engine's kernels, both rings."""
    from cognn_tpu_torch.ops import intmatmul
    from cognn_tpu_torch.ops import metrics as metric_ops

    e = engine.edges
    return {"wsum_i64": e.agg.ring_launches + e.agg_t.ring_launches,
            "wsum_i32": e.agg.ring32_launches + e.agg_t.ring32_launches,
            "sddmm_heads_i64": e.sddmm.ring_launches,
            "sddmm_heads_i32": e.sddmm.ring32_launches,
            "ring_matmul_i64": intmatmul.launches,
            "ring_matmul_i32": intmatmul.launches_i32,
            "gcn_metrics": metric_ops.launches}


def gat_epoch_counts(engine, name: str, ring: str) -> dict:
    """The launches an epoch of the eager ``engine``, read from its
    GAT_EPOCHS_CHECKED epochs: whole in every epoch, the weighted SpMM and
    the SDDMM launched on its ring (``"i64"`` or ``"i32"``) and not on the
    other."""
    gat_reset(engine)
    out = engine.metrics_host(engine.run_epochs_scan(GAT_EPOCHS_CHECKED))
    counts = gat_counts(engine)
    per_epoch = {k: v // GAT_EPOCHS_CHECKED for k, v in counts.items()}
    other = "i32" if ring == "i64" else "i64"
    if any(v % GAT_EPOCHS_CHECKED for v in counts.values()) or \
            not per_epoch[f"wsum_{ring}"] or \
            not per_epoch[f"sddmm_heads_{ring}"] or \
            per_epoch[f"wsum_{other}"] or per_epoch[f"sddmm_heads_{other}"]:
        raise AssertionError(f"gat {name} eager epochs launched {counts} "
                             f"in {GAT_EPOCHS_CHECKED} epochs")
    return out, per_epoch


def gat_reset(engine) -> None:
    from cognn_tpu_torch.ops import intmatmul
    from cognn_tpu_torch.ops import metrics as metric_ops

    for k in (engine.edges.agg, engine.edges.agg_t, engine.edges.sddmm):
        k.ring_launches = k.ring32_launches = 0
    intmatmul.launches = intmatmul.launches_i32 = metric_ops.launches = 0


def gat_phase(mac_ms: float) -> list:
    """The GAT of the benchmark's configuration GAT_CONFIG on the card:
    its kernels held and timed at the cell's shapes (``gat_edge_check``,
    ``gat_kernel_phase``, both rings), then a graphed engine and an eager
    one (``cuda_graphs=False``) from the same seed. The eager engine's
    GAT_EPOCHS_CHECKED epochs give the launches an epoch of each kernel
    (:func:`gat_epoch_counts`), and an eager engine at GAT_RING32 those of
    the int32 kernels, the same schedule's; the graphed one runs one epoch
    (the capture), then
    GAT_EPOCHS_CHECKED - 1 replays, counted apart: each replay must launch
    what an eager epoch launches, the weighted SpMM and the SDDMM at least
    once, one ``graphs.replays`` an epoch (the tracer's counter); losses
    and revealed leaves ``torch.equal`` to the eager engine's, and so are
    the logits of a graphed request (captured, then replayed). Then
    GAT_EPOCHS_TIMED graphed epochs timed (``run_epochs_scan``, ms an
    epoch), 3 eager ones, and the peak memory. Returns the kernels line's
    entries."""
    from benchmark.harness import spec
    from benchmark.harness.data import draw_graph, seeds_of
    from benchmark.systems.mpc_gat import build_engine
    from cognn_tpu_torch.core.ring import RING32, RING64
    from cognn_tpu_torch.utils import logging_utils as trace

    cfg = spec.config(spec.load_benchmark(), GAT_CONFIG)
    seeds = seeds_of(0)
    graph = draw_graph(cfg, seeds.graph)
    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    graphed = build_engine(cfg, graph, seeds, cuda)
    print(f"setup {GAT_CONFIG}: {time.perf_counter() - t0:.1f} s, "
          f"P={graphed.P} V={graphed.plan.V} heads={graphed.heads} "
          f"f={graphed.head_dim} entries={graphed.edges.count}", flush=True)
    gat_edge_check()
    wagg, sddmm = gat_kernel_phase(graphed, RING64, mac_ms)
    wagg32, sddmm32 = gat_kernel_phase(graphed, RING32, mac_ms)

    eager = build_engine(cfg, graph, seeds, cuda, cuda_graphs=False)
    want, per_epoch = gat_epoch_counts(eager, "int64", "i64")
    eager32 = build_engine(cfg, graph, seeds, cuda, ring=GAT_RING32,
                           cuda_graphs=False)
    per_epoch32 = gat_epoch_counts(eager32, f"ring {GAT_RING32}", "i32")[1]
    del eager32
    if [per_epoch32[f"{k}_i32"] for k in GAT_RINGED] != \
            [per_epoch[f"{k}_i64"] for k in GAT_RINGED]:
        raise AssertionError(f"gat: an int32 epoch launches {per_epoch32}, "
                             f"an int64 one {per_epoch}")
    first = graphed.metrics_host(graphed.run_epochs_scan(1))
    gat_reset(graphed)
    replays = GAT_EPOCHS_CHECKED - 1
    with trace.tracing():
        trace.reset()
        rest = graphed.metrics_host(graphed.run_epochs_scan(replays))
        counters = trace.snapshot()["counters"]
        trace.reset()
    got_counts = gat_counts(graphed)
    if got_counts != {k: v * replays for k, v in per_epoch.items()} or \
            counters.get("graphs.replays") != replays:
        raise AssertionError(f"gat graphed: {got_counts} and counters "
                             f"{counters} in {replays} replays; an eager "
                             f"epoch launches {per_epoch}")
    for key in want:
        got = np.concatenate([first[key], rest[key]], axis=1)
        if not np.array_equal(got, want[key]):
            raise AssertionError(f"gat graphed {key} {got} != eager "
                                 f"{want[key]}")
    for i, (a, b) in enumerate(zip(graphed.reveal_weights(),
                                   eager.reveal_weights())):
        held(f"gat leaf {i} graphed against eager", a, b, None)
    want_z = eager.forward()[0]
    for call in ("capture", "replay"):
        held(f"gat forward graphed ({call}) against eager",
             graphed.forward()[0], want_z, None)
    print(f"gat {GAT_CONFIG}: an epoch launches {per_epoch} (ring "
          f"{GAT_RING32}: {per_epoch32}), graphed as eager ({replays} "
          f"replays, graphs.replays "
          f"{counters.get('graphs.replays')}); losses and leaves equal; "
          f"losses {want['loss'][:, -1].tolist()}", flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed.metrics_host(graphed.run_epochs_scan(GAT_EPOCHS_TIMED))
    graphed_ms = (time.perf_counter() - t0) * 1e3 / GAT_EPOCHS_TIMED
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager.metrics_host(eager.run_epochs_scan(3))
    eager_ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = torch.cuda.max_memory_allocated()
    print(f"gat {GAT_CONFIG}: {graphed_ms!r} ms an epoch graphed "
          f"({GAT_EPOCHS_TIMED} epochs, one dispatch), {eager_ms!r} eager; "
          f"peak memory {peak} B (both engines and the kernel checks)",
          flush=True)
    shape = (f"{GAT_CONFIG}: heads {graphed.heads} of {graphed.head_dim} "
             f"over {graphed.edges.count} entries")
    del graphed, eager
    torch.cuda.empty_cache()
    counts = {"i64": per_epoch, "i32": per_epoch32}
    return [{
        "name": f"spmm_csr_wsum_{ring}[{GAT_CONFIG}]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/spmm.cu",
        "replaces": GAT_REPLACES,
        "jax_path": "none",
        "launches_per_epoch": counts[ring][f"wsum_{ring}"],
        **({"graphed_ms_per_epoch": graphed_ms} if ring == "i64" else {}),
        "shape": f"{shape}, forward and transposed, random full-range "
                 f"values",
        **stats,
    } for ring, stats in (("i64", wagg), ("i32", wagg32))] + [{
        "name": f"sddmm_heads_{ring}[{GAT_CONFIG}]",
        "route": "cuda",
        "source": "cognn_tpu_torch/csrc/sddmm.cu",
        "replaces": SDDMM_REPLACES,
        "jax_path": "none: no JAX engine launches K5",
        "launches_per_epoch": counts[ring][f"sddmm_heads_{ring}"],
        "shape": f"{shape}, random full-range values",
        **stats,
    } for ring, stats in (("i64", sddmm), ("i32", sddmm32))]


def prologue() -> float:
    """The card's name and power limit, the kernels built (one compiler a
    source, all at once), and the integer multiply rate; returns the time
    of one 64-bit multiply-add in ms."""
    from cognn_tpu_torch.ops import _build

    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    sources = _build.SOURCES + _build.HOST_SOURCES
    with ThreadPoolExecutor(len(sources)) as pool:  # one compiler each
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        tool = "g++" if name in _build.HOST_SOURCES else "nvcc"
        print(f"{tool} {name}: " + " | ".join(log.split("\n")), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    int_rate = IMAD_PER_CLOCK_PER_SM * sms * clock
    mac_ms = MULTIPLIES_PER_MAC / int_rate * 1e3
    print(f"integer multiply rate: {IMAD_PER_CLOCK_PER_SM} IMAD/clock/SM x "
          f"{sms} SMs x {clock / 1e6:.0f} MHz = {int_rate!r} /s; one 64-bit "
          f"multiply-add {mac_ms!r} ms", flush=True)
    return mac_ms


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs "
                 "on a GPU")
    if argv[:1] == ["--sharded-party"]:
        cell, dataset, parties, rank, port, backend, out = argv[1:]
        sharded_party(cell, dataset, int(parties), int(rank), int(port),
                      backend, out)
        return
    if argv == ["--sharded"]:
        mac_ms = prologue()
        kernels = []
        for cell, dataset, parties, replaces, _ in CELLS:
            kernels += sharded_phase(cell, dataset, parties, replaces, mac_ms)
        print(json.dumps({"kernels": kernels}), flush=True)
        return
    if argv:
        sys.exit(f"chip_smoke: unknown arguments {argv} (none, or "
                 "--sharded)")
    from cognn_tpu_torch.engine import GasEngine
    from cognn_tpu_torch.harness.datasets import party_plan
    from cognn_tpu_torch.mpc import MpcGasEngine
    from cognn_tpu_torch.ops.intmatmul import ring_matmul, ring_matmul_plain
    from cognn_tpu_torch.ops.sddmm import Sddmm
    from cognn_tpu_torch.ops.spmm_merged import SpmmMerged

    mac_ms = prologue()
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
    floor_ms = launch_floor()

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
        auto_phase(cell, plan, param, (engine, mpc))
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
        oracle_phase(cell, dataset, parties)
        dense = (dense_phase(cell, plan, param, engine.spmm, mpc.spmm, spmms,
                             n_edges) if cell == DENSE_CELL else None)
        an = analytics_phase(cell, dataset, parties, mac_ms)
        r32 = ring32_phase(cell, plan, param, engine.spmm, dup, mac_ms,
                           n_edges)
        graphed = graph_phase(cell, plan, param, n_edges)["mpc opt"]
        metrics_k = metrics_phase(cell, plan, param, floor_ms)

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
        pr_csr = f"n={an['n']}, nnz={an['nnz']}"
        k3_32 = ", ".join(f"[{b},{n},{k}]@[{b},{k},{m}]"
                          for b, n, k, m in r32["shapes"])
        k3_32_train = ", ".join(f"[{b},{n},{k}]@[{b},{k},{m}]"
                                for b, n, k, m in r32["train_shapes"])
        kernels += [{
            "name": f"spmm_csr_f32[{cell} pagerank]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": "the analytics' ADD combine: an XLA segment_sum in "
                        "JAX (cognn_tpu/engine/analytics.py:100-124), no "
                        "Pallas kernel",
            "launches": an["launches"],
            "shape": f"{PAGERANK_SWEEPS} pagerank sweeps, one a sweep: "
                     f"D = 1 over the flat edge-count matrix, {pr_csr}",
            **an["f32"],
        }, {
            "name": f"spmm_csr_i64[{cell} pagerank]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": "the secret-shared analytics' ADD combine: an XLA "
                        "segment sum in JAX (cognn_tpu/mpc/analytics.py:"
                        "236-244), no Pallas kernel",
            "launches": an["ring_launches"],
            "shape": f"{PAGERANK_SWEEPS} secret-shared pagerank sweeps, one "
                     f"a sweep: 2 shares, D = 1, {pr_csr}",
            **an["ring"],
        }, {
            "name": f"spmm_csr_i32[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/spmm.cu",
            "replaces": replaces,
            "jax_path": f"RING32 share instantiation (_bcsr_agg_shares, "
                        f"cognn_tpu/mpc/engine.py:269, one limb): {jax_path}",
            "launches": r32["counts"]["spmm_csr_i32"],
            "training_launches": r32["epoch_counts"]["spmm_csr_i32"],
            "launches_per_epoch": r32["epoch_counts"]["spmm_csr_i32"]
            // EPOCHS_CHECKED,
            "shape": f"one RING32 secret-shared forward ({FORWARDS} counted):"
                     f" 2 int32 shares, D in {list(widths)}, {csr}",
            **r32["spmm"],
        }, {
            "name": f"ring_matmul_i32[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
            "replaces": RING_MATMUL_REPLACES,
            "jax_path": "ring_matmul(bits=32), cognn_tpu/ops/intmatmul.py:"
                        "58-100: the 64-bit byte dots, limb 0 kept",
            "launches": r32["counts"]["ring_matmul_i32"],
            "training_launches": r32["epoch_counts"]["ring_matmul_i32"],
            "launches_per_epoch": r32["epoch_counts"]["ring_matmul_i32"]
            // EPOCHS_CHECKED,
            "shape": f"one RING32 secret-shared forward ({FORWARDS} counted):"
                     f" {k3_32}",
            **r32["k3"],
        }, {
            "name": f"ring_matmul_i32[{cell} train]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
            "replaces": RING_MATMUL_REPLACES,
            "jax_path": "none: JAX's RING32 training crashes "
                        "(cognn_tpu/mpc/engine.py:1218 -> :898)",
            "launches": r32["epoch_counts"]["ring_matmul_i32"],
            "launches_per_epoch": r32["epoch_counts"]["ring_matmul_i32"]
            // EPOCHS_CHECKED,
            "shape": f"the RING32 epoch's other shapes (launches: all of "
                     f"{EPOCHS_CHECKED} epochs): {k3_32_train}",
            **r32["k3_train"],
        }, {
            "name": f"gcn_metrics_f32[{cell}]",
            "route": "cuda",
            "source": "cognn_tpu_torch/csrc/metrics.cu",
            "replaces": METRICS_REPLACES,
            "jax_path": "cognn_tpu/engine/gas.py gcn_metrics (plain jnp)",
            "launches": graphed["forward_counts"]["gcn_metrics"] // FORWARDS,
            "launches_per_epoch":
                graphed["epoch_counts"]["gcn_metrics"] // EPOCHS_CHECKED,
            **metrics_k,
        }]
        if dense is not None:
            opt = dense["counts"][f"{cell} dense opt mpc"]
            kernels.append({
                "name": f"ring_matmul_i64[{cell} dense]",
                "route": "cuda",
                "source": "cognn_tpu_torch/csrc/ring_matmul.cu",
                "replaces": RING_MATMUL_REPLACES,
                "jax_path": "the dense share aggregation "
                            "(_dense_agg_shares_i8, "
                            "cognn_tpu/mpc/engine.py:252-266), byte planes "
                            "on the MXU: XLA, not Pallas",
                "launches": opt["forward"]["ring_matmul_i64"],
                "training_launches": opt["epochs"]["ring_matmul_i64"],
                "launches_per_epoch": opt["epochs"]["ring_matmul_i64"]
                // EPOCHS_CHECKED,
                "launches_by_path": dense["counts"],
                "shape": "aggregation = A^T [sh_0 | sh_1]: " + ", ".join(
                    f"[{b},{n},{k}]@[{b},{k},{m}]"
                    for b, n, k, m in dense["shapes"])
                    + " (opt at D = 16, 7; unopt layer 0 at D = 1433); "
                    "launches: the dense opt mpc forwards' K3, "
                    "aggregations and matmuls",
                **dense["k3"],
            })

    kernels += gat_phase(mac_ms)
    kernels += citeseer_phase(mac_ms)

    # the sharded mode: one process a party
    for cell, dataset, parties, replaces, _ in CELLS:
        kernels += sharded_phase(cell, dataset, parties, replaces, mac_ms)

    cli_phase()
    matrix_phase()
    tools_phase()

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
    main(sys.argv[1:])
