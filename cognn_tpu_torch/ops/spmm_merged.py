"""Block-merged SpMM U = Aᵀ·H on the tensor cores: the CUDA kernel of
``csrc/spmm_merged.cu`` (K4) and its plain PyTorch version.

The kernel replaces the TPU kernel ``cognn_tpu/ops/pallas_spmm.py``
``_merged_kernel`` (``PallasSpmmMerged``): the same function as the CSR
kernel of :mod:`cognn_tpu_torch.ops.spmm`, with both operands rounded to
bf16 as the TPU kernel rounds them (edge counts stored bf16, H cast in the
kernel), the products exact in f32 and summed in f32. A is held as 16x16
tiles compressed to their entries
(:func:`~cognn_tpu_torch.ops.bcsr.build_tiles_by_dst`); the warps of one
block expand a destination tile's source tiles and their H rows in shared
memory and contract them with ``mma.sync``, then sum their accumulators in
a fixed order. The source describes the design.

No engine routes through it (the JAX engines never call their K4 either);
the microbenchmark :mod:`cognn_tpu_torch.tools.bench_spmm` does.
:class:`SpmmMerged` called on a CUDA tensor launches the kernel (and raises
if the launch fails); on a CPU tensor it runs :func:`spmm_merged_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.ops.bcsr import build_csr_by_dst, build_tiles_by_dst
from cognn_tpu_torch.ops.spmm import check_rows, spmm_plain
from cognn_tpu_torch.utils.device import resolve_device

@functools.cache
def _kernel():
    fn = _build.load("spmm_merged").cognn_spmm_tiles_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_merged_plain(indptr: torch.Tensor, indices: torch.Tensor,
                      counts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: :func:`spmm_plain` on the f32 CSR with
    the counts and ``h`` rounded to bf16 first (a count above 256 rounds
    as in the kernel's bf16 tiles)."""
    return spmm_plain(indptr, indices, counts.to(torch.bfloat16).float(),
                      h.to(torch.bfloat16).float())


class SpmmMerged:
    """U = Aᵀ·H in bf16 operands for the [n_src, n_dst] edge-count matrix
    of an edge list (duplicate edges accumulate), held on ``device`` as
    compressed 16x16 tiles for the kernel and as destination CSR for the
    plain version. ``launches`` counts launches of the kernel."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int,
                 n_dst: int, device="cuda"):
        dev = resolve_device(device)
        m = build_csr_by_dst(src, dst, n_src, n_dst)
        t = build_tiles_by_dst(src, dst, n_src, n_dst)
        self.n_src, self.n_dst, self.nnz = n_src, n_dst, m.nnz
        self.n_tiles, self.tile_bytes = t.n_tiles, t.nbytes
        self.indptr = torch.as_tensor(m.indptr).to(dev)
        self.indices = torch.as_tensor(m.indices).to(dev)
        self.counts = torch.as_tensor(m.counts).to(dev)
        self.dptr = torch.as_tensor(t.dptr).to(dev)
        self.entries = torch.as_tensor(t.entries).to(dev)
        self.esrc = torch.as_tensor(t.esrc).to(dev)
        self.launches = 0

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        """h: f32 [n_src, D], contiguous, on this structure's device ->
        f32 [n_dst, D]."""
        if check_rows(h, self.indptr.device, torch.float32, self.n_src):
            return spmm_merged_plain(self.indptr, self.indices, self.counts,
                                     h)
        D = h.shape[1]
        out = torch.empty((self.n_dst, D), dtype=h.dtype, device=h.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(h.device):
            err = _kernel()(self.dptr.data_ptr(), self.entries.data_ptr(),
                            self.esrc.data_ptr(), h.data_ptr(),
                            out.data_ptr(), self.n_dst, D,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"merged spmm kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out
