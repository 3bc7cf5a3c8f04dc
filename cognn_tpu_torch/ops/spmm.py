"""Sparse aggregation U = Aᵀ·H over a fixed edge-count matrix A: the CUDA
kernels of ``csrc/spmm.cu`` (f32 rows, and int64 or int32 ring shares) and
their plain PyTorch version.

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
guards carry over. On int32 shares (RING32) it launches the 32-bit
instantiation, which wraps mod 2^32.

:class:`Spmm` is built once from an edge list. Called on a CUDA tensor it
launches a kernel (and raises if the launch fails); on a CPU tensor it runs
:func:`spmm_plain`, which the tests compare against the JAX package.

:class:`WeightedSpmm` is the attention-weighted ring instantiation of the
GAT layers (``mpc/gat.py``): one ring tensor, one entry an edge, and a ring
weight an entry and a head in place of the count; :func:`wsum_plain` is its
plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.ops.bcsr import build_csr_by_dst, edge_arrays
from cognn_tpu_torch.utils import logging_utils as trace


def bind(lib: ctypes.CDLL) -> tuple:
    """The f32, the int64 ring and the int32 ring entry points of a built
    ``csrc/spmm.cu`` library, with their C signatures."""
    f32 = lib.cognn_spmm_csr_f32
    rings = lib.cognn_spmm_csr_i64, lib.cognn_spmm_csr_i32
    f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for ring in rings:
        ring.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    for fn in (f32, *rings):
        fn.restype = ctypes.c_int
    return (f32, *rings)


@functools.cache
def _kernels() -> tuple:
    return bind(_build.load("spmm"))


@functools.cache
def _wsum_kernels() -> dict:
    """The attention-weighted entry points by the ring's dtype."""
    lib = _build.load("spmm")
    out = {torch.int64: lib.cognn_spmm_csr_wsum_i64,
           torch.int32: lib.cognn_spmm_csr_wsum_i32}
    for fn in out.values():
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return out


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
    no entries), for ``h [..., n_src, D]``. On int64 (int32) the products
    and sums wrap mod 2^64 (2^32)."""
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
    ``ring_launches`` those of the int64 ring kernel and ``ring32_launches``
    those of the int32 one."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int,
                 n_dst: int, device: torch.device):
        m = build_csr_by_dst(src, dst, n_src, n_dst)
        self.n_src, self.n_dst, self.nnz = n_src, n_dst, m.nnz
        self.indptr = torch.as_tensor(m.indptr).to(device)
        self.indices = torch.as_tensor(m.indices).to(device)
        self.counts = torch.as_tensor(m.counts).to(device)
        self.launches = 0
        self.ring_launches = 0
        self.ring32_launches = 0

    @functools.cached_property
    def counts_i64(self) -> torch.Tensor:
        """The edge counts as int64, for :meth:`ring`; made on first use,
        so a structure that only aggregates f32 rows never holds them."""
        return self.counts.to(torch.int64)

    @functools.cached_property
    def counts_i32(self) -> torch.Tensor:
        """The edge counts as int32, for :meth:`ring` on int32 shares."""
        return self.counts.to(torch.int32)

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
        """h: the two shares [2, n_src, D], int64 (Z_2^64) or int32
        (Z_2^32), contiguous, on this structure's device -> [2, n_dst, D]
        with ``out[s, d] = Σ counts[e]·h[s, indices[e]]`` mod 2^bits, both
        shares in one launch."""
        wide = h.dtype != torch.int32
        cpu = check_rows(h, self.indptr.device,
                         torch.int64 if wide else torch.int32, self.n_src, 1)
        if h.shape[0] != 2:
            raise ValueError(f"h must hold 2 shares, got {h.shape[0]}")
        counts = self.counts_i64 if wide else self.counts_i32
        if cpu:
            return spmm_plain(self.indptr, self.indices, counts, h)
        S, _, D = h.shape
        out = torch.empty((S, self.n_dst, D), dtype=h.dtype, device=h.device)
        if out.numel() == 0:
            return out
        shape = launch_shape(D, h.element_size(),
                             (h.data_ptr(), out.data_ptr()),
                             (self.n_src * D, self.n_dst * D))
        with torch.cuda.device(h.device):
            err = _kernels()[1 if wide else 2](
                self.indptr.data_ptr(), self.indices.data_ptr(),
                counts.data_ptr(), h.data_ptr(), out.data_ptr(), S,
                self.n_src, self.n_dst, D, *shape,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ring spmm kernel launch failed: CUDA error "
                               f"{err}")
        if wide:
            self.ring_launches += 1
        else:
            self.ring32_launches += 1
        return out


def wsum_plain(indptr: torch.Tensor, indices: torch.Tensor, w: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """Plain version of the attention-weighted kernels: ``out[d, k·f + j] =
    Σ w[e, k]·h[indices[e], k·f + j]`` over the entries ``e`` of
    destination ``d``, for ``w [entries, H]`` and ``h [n_src, H·f]``; the
    products and sums wrap mod 2^64 (int64) or 2^32 (int32)."""
    n_dst = indptr.numel() - 1
    E, H = w.shape
    dst = torch.repeat_interleave(
        torch.arange(n_dst, device=h.device), indptr.diff().to(torch.int64),
        output_size=E)
    terms = h.index_select(0, indices).view(E, H, h.shape[1] // H) \
        * w[:, :, None]
    return h.new_zeros(n_dst, h.shape[1]).index_add_(0, dst,
                                                     terms.view(E, -1))


class WeightedSpmm:
    """``out[d, k·f + j] = Σ_e w[e, k]·h[src_e, k·f + j]`` over a fixed edge
    list sorted by destination, one entry an edge (a repeated edge is two
    entries), on ring values: a GAT layer's attention-weighted aggregation
    of its H heads of f features (``w`` the attention coefficients of the
    entries, in the list's order). Held as destination-sorted CSR on
    ``device``; ``ring_launches`` and ``ring32_launches`` count the int64
    and int32 kernels' launches."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int,
                 n_dst: int, device: torch.device):
        src, dst = edge_arrays(src, dst, n_src, n_dst)
        if np.any(np.diff(dst) < 0):
            raise ValueError("the edges must be sorted by destination")
        indptr = np.zeros(n_dst + 1, np.int32)
        np.cumsum(np.bincount(dst, minlength=n_dst), out=indptr[1:])
        self.n_src, self.n_dst, self.nnz = n_src, n_dst, len(src)
        self.indptr = torch.as_tensor(indptr).to(device)
        self.indices = torch.as_tensor(src.astype(np.int32)).to(device)
        self.ring_launches = 0
        self.ring32_launches = 0

    def __call__(self, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """w: [nnz, H] and h: [n_src, H·f], both int64 (Z_2^64) or both
        int32 (Z_2^32), contiguous, on this structure's device -> [n_dst,
        H·f]."""
        if h.dtype not in (torch.int64, torch.int32):
            raise TypeError(f"h must be int64 or int32, got {h.dtype}")
        dev = self.indptr.device
        cpu = check_rows(h, dev, h.dtype, self.n_src)
        check_rows(w, dev, h.dtype, self.nnz, name="w")
        H = w.shape[1]
        if H == 0 or h.shape[1] % H:
            raise ValueError(f"h's width {h.shape[1]} is not {H} heads")
        if cpu:
            return wsum_plain(self.indptr, self.indices, w, h)
        D = h.shape[1]
        out = torch.empty((self.n_dst, D), dtype=h.dtype, device=h.device)
        if out.numel() == 0:
            return out
        shape = launch_shape(D, h.element_size(),
                             (h.data_ptr(), out.data_ptr()))
        with torch.cuda.device(h.device):
            err = _wsum_kernels()[h.dtype](
                self.indptr.data_ptr(), self.indices.data_ptr(),
                w.data_ptr(), h.data_ptr(), out.data_ptr(), self.n_dst, H,
                D // H, *shape, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"weighted ring spmm kernel launch failed: "
                               f"CUDA error {err}")
        if h.dtype == torch.int64:
            self.ring_launches += 1
        else:
            self.ring32_launches += 1
        trace.count("gat.wagg.kernel")
        return out
