"""cognn_tpu_torch — the PyTorch/CUDA port of ``cognn_tpu``.

The layout mirrors the JAX package, so each module has a counterpart of the
same name there. The port imports ``torch`` and numpy and nothing of JAX or of
``cognn_tpu``: it keeps its own copies of the pure-numpy modules it needs.

  config        GNN hyperparameters (``GNNParam``)
  utils/        glibc ``rand()`` Glorot init, device selection
  graph/        partitioned graph container (``PartyGraph``)
  harness/      synthetic Planetoid-statistics datasets
  ops/          CSR structure, segment sum, the SpMM kernel and its loader
  csrc/         CUDA C++ kernel sources (built for sm_90a on first use)
  engine/       device plan and the stacked-party GAS engine (inference)
  convert       weights carried over from the JAX engine

Entry points default to ``device="cuda"`` and raise when there is no card;
CPU runs must ask for ``device="cpu"``.
"""

__version__ = "0.1.0"
