"""Per-edge scores (SDDMM) ``scores[e] = <a[src_e], b[dst_e]>``: the CUDA
kernel of ``csrc/sddmm.cu`` (K5) and its plain PyTorch version.

The kernel replaces the TPU kernel ``cognn_tpu/ops/pallas_sddmm.py``
``_kernel`` (``PallasSddmm``), which computes every non-zero 128x128 block
of scores densely, masks it by the block's edges, and leaves
``PallasSddmm.edge_scores`` to pick the edges out. Here the result is what
those two give together: one f32 score per input edge, in input order (a
duplicated edge is scored once per copy), with no block formed. It is bound
by bytes (gathered rows, indices, scores); the source describes the design.

:class:`Sddmm` called on CUDA tensors launches the kernel (and raises if the
launch fails); on CPU tensors it runs :func:`sddmm_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.ops.bcsr import edge_arrays
from cognn_tpu_torch.ops.spmm import check_rows
from cognn_tpu_torch.utils.device import resolve_device


@functools.cache
def _kernel():
    fn = _build.load("sddmm").cognn_sddmm_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sddmm_plain(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (the port's copy of the JAX package's
    ``sddmm_reference``): per-edge ``<a[src], b[dst]>``."""
    return (a[src] * b[dst]).sum(-1)


class Sddmm:
    """Per-edge scores over a fixed edge list, held on ``device`` as int32
    endpoints. ``launches`` counts launches of the kernel."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int,
                 n_dst: int, device="cuda"):
        dev = resolve_device(device)
        src, dst = edge_arrays(src, dst, n_src, n_dst)
        self.n_src, self.n_dst, self.n_edges = n_src, n_dst, len(src)
        self.src = torch.as_tensor(src.astype(np.int32)).to(dev)
        self.dst = torch.as_tensor(dst.astype(np.int32)).to(dev)
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a: f32 [n_src, D], b: f32 [n_dst, D], contiguous, on this edge
        list's device -> f32 [n_edges]."""
        on_cpu = check_rows(a, self.src.device, torch.float32, self.n_src,
                            name="a")
        check_rows(b, self.src.device, torch.float32, self.n_dst, name="b")
        if a.shape[1] != b.shape[1]:
            raise ValueError(f"a has D = {a.shape[1]}, b has {b.shape[1]}")
        if on_cpu:
            return sddmm_plain(self.src, self.dst, a, b)
        out = torch.empty(self.n_edges, dtype=a.dtype, device=a.device)
        if self.n_edges == 0:
            return out
        with torch.cuda.device(a.device):
            err = _kernel()(self.src.data_ptr(), self.dst.data_ptr(),
                            a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            self.n_edges, a.shape[1],
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sddmm kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out
