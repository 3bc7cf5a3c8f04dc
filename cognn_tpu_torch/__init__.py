"""cognn_tpu_torch — the PyTorch/CUDA port of ``cognn_tpu``.

The layout mirrors the JAX package, so each module has a counterpart of the
same name there. The port imports ``torch`` and numpy and nothing of JAX or of
``cognn_tpu``: it keeps its own copies of the pure-numpy modules it needs.

  config        GNN hyperparameters (``GNNParam``)
  utils/        glibc ``rand()`` Glorot init, device selection, party
                process groups over ``torch.distributed``
  graph/        partitioned graph container (``PartyGraph``), the
                reference's file formats (parsed by a native C++ reader)
  harness/      synthetic Planetoid-statistics datasets, the CLI
  models/       the float64 numpy oracle of the GAS schedules (a test
                reference on the host)
  core/         Z_2^64 ring on int64 and Z_2^32 on int32, fixed-point
                codec, additive shares
  ops/          CSR structure, segment sum, the SpMM kernels (f32 rows and
                int64 or int32 shares), the exact mod-2^64 / mod-2^32
                matmul, the kernel loader
  csrc/         CUDA C++ kernel sources (built for sm_90a on first use)
                and the host graph file parser
  tools/        the evaluation-matrix driver, its summarizer, the golden
                accuracy runs, data transform, kernel benchmarks
  engine/       device plan and the GAS engine (CoGNN-Opt and CoGNN
                inference and training, parties stacked or sharded), the
                vertex analytics, the communication model
  mpc/          secret-sharing protocol, the secret-shared GAS engine
                (the same schedules, stacked or sharded) and analytics
  convert       weights and secret-shared state carried over from the JAX
                engines

Entry points default to ``device="cuda"`` and raise when there is no card;
CPU runs must ask for ``device="cpu"``.
"""

__version__ = "0.1.0"
