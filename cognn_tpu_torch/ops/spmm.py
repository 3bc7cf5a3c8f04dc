"""Sparse aggregation U = Aᵀ·H over a fixed edge-count matrix A: the CUDA
kernels of ``csrc/spmm.cu`` (f32 rows, and int64 ring shares) and their plain
PyTorch version.

The kernel replaces the TPU kernels ``cognn_tpu/ops/pallas_spmm.py``
``_kernel`` (:class:`PallasSpmm`) and ``_tiled_kernel``
(:class:`PallasSpmmTiled`), which compute the same function over dense
128x128 blocks of A. On the H100 it is bound by bytes: the CSR structure, H
once and the output once; its design (one warp per destination row, lanes
over features, no atomics) is described in the source.

The ring instantiation (:meth:`Spmm.ring`) replaces the same two kernels in
their share instantiation (``cognn_tpu/mpc/engine.py`` ``_bcsr_agg_shares``,
byte planes of uint32 limbs): it sums int64 shares with int64 edge counts,
wrapping mod 2^64, both shares in one launch. Exact for any multiplicity and
in-degree, so none of the JAX package's byte-plane guards carry over.

:class:`Spmm` is built once from an edge list. Called on a CUDA tensor it
launches a kernel (and raises if the launch fails); on a CPU tensor it runs
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


@functools.cache
def _ring_kernel():
    fn = _build.load("spmm").cognn_spmm_csr_i64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_plain(indptr: torch.Tensor, indices: torch.Tensor,
               counts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels: ``out[..., d, :] = Σ counts[e]·h[...,
    indices[e], :]`` over the entries ``e`` of destination ``d`` (zero for
    no entries), for ``h [..., n_src, D]``. On int64 the products and sums
    wrap mod 2^64."""
    n_dst = indptr.numel() - 1
    dst = torch.repeat_interleave(
        torch.arange(n_dst, device=h.device), indptr.diff().to(torch.int64),
        output_size=indices.numel())
    out = h.new_zeros(*h.shape[:-2], n_dst, h.shape[-1])
    return out.index_add_(-2, dst,
                          h.index_select(-2, indices) * counts[:, None])


class Spmm:
    """U = Aᵀ·H for the [n_src, n_dst] edge-count matrix of an edge list
    (duplicate edges accumulate), held as destination-sorted CSR on
    ``device``. ``launches`` counts launches of the f32 kernel,
    ``ring_launches`` those of the ring kernel."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int,
                 n_dst: int, device: torch.device):
        m = build_csr_by_dst(src, dst, n_src, n_dst)
        self.n_src, self.n_dst, self.nnz = n_src, n_dst, m.nnz
        self.indptr = torch.as_tensor(m.indptr).to(device)
        self.indices = torch.as_tensor(m.indices).to(device)
        self.counts = torch.as_tensor(m.counts).to(device)
        self.launches = 0
        self.ring_launches = 0

    @functools.cached_property
    def counts_i64(self) -> torch.Tensor:
        """The edge counts as int64, for :meth:`ring`; made on first use,
        so a structure that only aggregates f32 rows never holds them."""
        return self.counts.to(torch.int64)

    def _check(self, h: torch.Tensor, dtype: torch.dtype, lead: int) -> bool:
        """Validates ``h`` ([n_src, D] after ``lead`` leading axes);
        returns True when it lies on the CPU (run the plain version)."""
        if h.device != self.indptr.device:
            raise ValueError(f"h is on {h.device}, the structure on "
                             f"{self.indptr.device}")
        if h.dtype != dtype:
            raise TypeError(f"h must be {dtype}, got {h.dtype}")
        if h.dim() != lead + 2 or h.shape[lead] != self.n_src:
            raise ValueError(f"h must be [{'S, ' * lead}{self.n_src}, D], "
                             f"got {tuple(h.shape)}")
        if not h.is_contiguous():
            raise ValueError("h must be contiguous")
        if h.device.type == "cpu":
            return True
        if h.device.type != "cuda":
            raise ValueError(f"no kernel for device {h.device}")
        return False

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        """h: f32 [n_src, D], contiguous, on this structure's device ->
        f32 [n_dst, D]."""
        if self._check(h, torch.float32, 0):
            return spmm_plain(self.indptr, self.indices, self.counts, h)
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

    def ring(self, h: torch.Tensor) -> torch.Tensor:
        """h: int64 shares [S, n_src, D], contiguous, on this structure's
        device -> [S, n_dst, D] with ``out[s, d] = Σ counts[e]·h[s,
        indices[e]]`` mod 2^64, all S shares in one launch."""
        if self._check(h, torch.int64, 1):
            return spmm_plain(self.indptr, self.indices, self.counts_i64, h)
        S, _, D = h.shape
        out = torch.empty((S, self.n_dst, D), dtype=h.dtype, device=h.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(h.device):
            err = _ring_kernel()(self.indptr.data_ptr(),
                                 self.indices.data_ptr(),
                                 self.counts_i64.data_ptr(), h.data_ptr(),
                                 out.data_ptr(), S, self.n_src, self.n_dst, D,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ring spmm kernel launch failed: CUDA error "
                               f"{err}")
        self.ring_launches += 1
        return out
