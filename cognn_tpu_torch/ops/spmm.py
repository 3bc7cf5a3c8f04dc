"""Sparse aggregation U = Aᵀ·H over a fixed edge-count matrix A: the CUDA
kernel ``csrc/spmm.cu`` and its plain PyTorch version.

The kernel replaces the TPU kernels ``cognn_tpu/ops/pallas_spmm.py``
``_kernel`` (:class:`PallasSpmm`) and ``_tiled_kernel``
(:class:`PallasSpmmTiled`), which compute the same function over dense
128x128 blocks of A. On the H100 it is bound by bytes: the CSR structure, H
once and the output once; its design (one warp per destination row, lanes
over features, no atomics) is described in the source.

:class:`Spmm` is built once from an edge list. Called on a CUDA tensor it
launches the kernel (and raises if the launch fails); on a CPU tensor it runs
:func:`spmm_plain`, which the tests compare against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.ops.bcsr import build_csr_by_dst


@functools.cache
def _kernel():
    fn = _build.load("spmm").cognn_spmm_csr_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_plain(indptr: torch.Tensor, indices: torch.Tensor,
               counts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``out[d] = Σ counts[e]·h[indices[e]]``
    over the entries ``e`` of destination ``d`` (zero for no entries)."""
    n_dst = indptr.numel() - 1
    dst = torch.repeat_interleave(
        torch.arange(n_dst, device=h.device), indptr.diff().to(torch.int64),
        output_size=indices.numel())
    out = h.new_zeros(n_dst, h.shape[1])
    return out.index_add_(0, dst, h.index_select(0, indices) * counts[:, None])


class Spmm:
    """U = Aᵀ·H for the [n_src, n_dst] edge-count matrix of an edge list
    (duplicate edges accumulate), held as destination-sorted CSR on
    ``device``. ``launches`` counts kernel launches."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int,
                 n_dst: int, device: torch.device):
        m = build_csr_by_dst(src, dst, n_src, n_dst)
        self.n_src, self.n_dst, self.nnz = n_src, n_dst, m.nnz
        self.indptr = torch.as_tensor(m.indptr).to(device)
        self.indices = torch.as_tensor(m.indices).to(device)
        self.counts = torch.as_tensor(m.counts).to(device)
        self.launches = 0

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        """h: f32 [n_src, D], contiguous, on this structure's device ->
        f32 [n_dst, D]."""
        if h.device != self.indptr.device:
            raise ValueError(f"h is on {h.device}, the structure on "
                             f"{self.indptr.device}")
        if h.dtype != torch.float32:
            raise TypeError(f"h must be float32, got {h.dtype}")
        if h.dim() != 2 or h.shape[0] != self.n_src:
            raise ValueError(f"h must be [{self.n_src}, D], got "
                             f"{tuple(h.shape)}")
        if not h.is_contiguous():
            raise ValueError("h must be contiguous")
        if h.device.type == "cpu":
            return spmm_plain(self.indptr, self.indices, self.counts, h)
        if h.device.type != "cuda":
            raise ValueError(f"no kernel for device {h.device}")
        D = h.shape[1]
        out = torch.empty((self.n_dst, D), dtype=h.dtype, device=h.device)
        if self.n_dst == 0 or D == 0:
            return out
        with torch.cuda.device(h.device):
            err = _kernel()(self.indptr.data_ptr(), self.indices.data_ptr(),
                            self.counts.data_ptr(), h.data_ptr(),
                            out.data_ptr(), self.n_dst, D,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"spmm kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out
