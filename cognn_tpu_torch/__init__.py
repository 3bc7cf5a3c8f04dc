"""cognn_tpu_torch — the PyTorch/CUDA port of ``cognn_tpu``.

The layout mirrors the JAX package, so each module has a counterpart of the
same name there. The port imports ``torch`` and numpy and nothing of JAX or of
``cognn_tpu``: it keeps its own copies of the pure-numpy modules it needs.

  config        GNN hyperparameters (``GNNParam``)
  utils/        glibc ``rand()`` Glorot init, device selection
  graph/        partitioned graph container (``PartyGraph``)
  harness/      synthetic Planetoid-statistics datasets
  core/         Z_2^64 ring on int64, fixed-point codec, additive shares
  ops/          CSR structure, segment sum, the SpMM kernels (f32 rows and
                int64 shares), the exact mod-2^64 matmul, the kernel loader
  csrc/         CUDA C++ kernel sources (built for sm_90a on first use)
  engine/       device plan and the stacked-party GAS engine (CoGNN-Opt
                inference and training)
  mpc/          secret-sharing protocol and the stacked-party secret-shared
                GAS engine (CoGNN-Opt inference and training)
  convert       weights and secret-shared state carried over from the JAX
                engines

Entry points default to ``device="cuda"`` and raise when there is no card;
CPU runs must ask for ``device="cpu"``.
"""

__version__ = "0.1.0"
