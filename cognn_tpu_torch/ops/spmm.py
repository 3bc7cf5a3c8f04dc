"""Sparse aggregation U = Aᵀ·H over a fixed edge-count matrix A: the CUDA
kernels of ``csrc/spmm.cu`` (f32 rows, and int64 ring shares) and their plain
PyTorch version.

The kernel replaces the TPU kernels ``cognn_tpu/ops/pallas_spmm.py``
``_kernel`` (:class:`PallasSpmm`) and ``_tiled_kernel``
(:class:`PallasSpmmTiled`), which compute the same function over dense
128x128 blocks of A. On the H100 it is bound by bytes: the CSR structure, H
once and the output once; its design (a group of lanes a destination row,
lanes over features, entries in batches, no atomics) is described in the
source. :func:`launch_shape` picks its instantiation: 16-byte loads where
every row start is aligned, else scalar ones, and the lanes a row.

The ring instantiation (:meth:`Spmm.ring`) replaces the same two kernels in
their share instantiation (``cognn_tpu/mpc/engine.py`` ``_bcsr_agg_shares``,
byte planes of uint32 limbs): it sums int64 shares with int64 edge counts,
wrapping mod 2^64, both shares of a row from one read of its entries. Exact
for any multiplicity and in-degree, so none of the JAX package's byte-plane
guards carry over.

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


def bind(lib: ctypes.CDLL) -> tuple:
    """The f32 and the ring entry points of a built ``csrc/spmm.cu``
    library, with their C signatures."""
    f32, ring = lib.cognn_spmm_csr_f32, lib.cognn_spmm_csr_i64
    f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    ring.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    f32.restype = ring.restype = ctypes.c_int
    return f32, ring


@functools.cache
def _kernels() -> tuple:
    return bind(_build.load("spmm"))


def launch_shape(d: int, elem_bytes: int, ptrs, share_elems=()) -> tuple:
    """The kernel instantiation for rows of ``d`` elements of
    ``elem_bytes``: ``(vec, lanes)``. ``vec`` is the elements a lane loads
    at once: 16 bytes' worth when every row start is 16-byte aligned (each
    of ``ptrs``, the row pitch, and each share stride of ``share_elems``
    elements), else 1. ``lanes`` is the power of two, at most 32, that
    covers the row in loads of ``vec``. (The kernel gives a row 2 of these
    groups side by side where they fit a warp, 1 at 32 lanes; a row wider
    than 32 loads takes a block row for each chunk of 32 loads.)"""
    vec = 16 // elem_bytes
    steps = (*ptrs, d * elem_bytes, *(n * elem_bytes for n in share_elems))
    if any(x % 16 for x in steps):
        vec = 1
    return vec, min(32, 1 << (-(-d // vec) - 1).bit_length())


def check_rows(x: torch.Tensor, device: torch.device, dtype: torch.dtype,
               n_rows: int, lead: int = 0, name: str = "h") -> bool:
    """Validates a kernel operand ``x``: ``dtype``, [n_rows, D] after
    ``lead`` leading axes, contiguous, on ``device`` (where the kernel's
    structure lives). Returns True when it lies on the CPU (run the plain
    version); raises for a device with no kernel."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the structure on "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != lead + 2 or x.shape[lead] != n_rows:
        raise ValueError(f"{name} must be [{'S, ' * lead}{n_rows}, D], "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


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

    def edge_list(self) -> tuple:
        """The edges as numpy int64 ``(src, dst)``, destination-major with
        sources ascending, each as often as its count."""
        indptr = self.indptr.cpu().numpy()
        counts = self.counts.cpu().numpy().astype(np.int64)
        src = self.indices.cpu().numpy().astype(np.int64)
        dst = np.repeat(np.arange(self.n_dst), np.diff(indptr))
        return np.repeat(src, counts), np.repeat(dst, counts)

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        """h: f32 [n_src, D], contiguous, on this structure's device ->
        f32 [n_dst, D]."""
        if check_rows(h, self.indptr.device, torch.float32, self.n_src):
            return spmm_plain(self.indptr, self.indices, self.counts, h)
        D = h.shape[1]
        out = torch.empty((self.n_dst, D), dtype=h.dtype, device=h.device)
        if self.n_dst == 0 or D == 0:
            return out
        shape = launch_shape(D, 4, (h.data_ptr(), out.data_ptr()))
        with torch.cuda.device(h.device):
            err = _kernels()[0](self.indptr.data_ptr(),
                                self.indices.data_ptr(),
                                self.counts.data_ptr(), h.data_ptr(),
                                out.data_ptr(), self.n_dst, D, *shape,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"spmm kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out

    def ring(self, h: torch.Tensor) -> torch.Tensor:
        """h: the two int64 shares [2, n_src, D], contiguous, on this
        structure's device -> [2, n_dst, D] with ``out[s, d] = Σ
        counts[e]·h[s, indices[e]]`` mod 2^64, both shares in one launch."""
        cpu = check_rows(h, self.indptr.device, torch.int64, self.n_src, 1)
        if h.shape[0] != 2:
            raise ValueError(f"h must hold 2 shares, got {h.shape[0]}")
        if cpu:
            return spmm_plain(self.indptr, self.indices, self.counts_i64, h)
        S, _, D = h.shape
        out = torch.empty((S, self.n_dst, D), dtype=h.dtype, device=h.device)
        if out.numel() == 0:
            return out
        shape = launch_shape(D, 8, (h.data_ptr(), out.data_ptr()),
                             (self.n_src * D, self.n_dst * D))
        with torch.cuda.device(h.device):
            err = _kernels()[1](self.indptr.data_ptr(),
                                self.indices.data_ptr(),
                                self.counts_i64.data_ptr(), h.data_ptr(),
                                out.data_ptr(), S, self.n_src, self.n_dst, D,
                                *shape,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ring spmm kernel launch failed: CUDA error "
                               f"{err}")
        self.ring_launches += 1
        return out
