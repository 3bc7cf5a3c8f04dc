"""Per-edge scores (SDDMM) ``scores[e] = <a[src_e], b[dst_e]>``: the CUDA
kernel of ``csrc/sddmm.cu`` (K5) and its plain PyTorch version.

The kernel replaces the TPU kernel ``cognn_tpu/ops/pallas_sddmm.py``
``_kernel`` (``PallasSddmm``), which computes every non-zero 128x128 block
of scores densely, masks it by the block's edges, and leaves
``PallasSddmm.edge_scores`` to pick the edges out. Here the result is what
those two give together: one f32 score per input edge, in input order (a
duplicated edge is scored once per copy), with no block formed. It is bound
by bytes (gathered rows, indices, scores); the source describes the design
(a group of lanes an edge, edges in batches whose index and row loads are
all issued before any sum). :func:`launch_shape` picks its instantiation:
16-byte loads where every row start is aligned, else scalar ones, and the
lanes an edge (``ops/spmm.py`` :func:`launch_shape`, as for the SpMM).

:class:`Sddmm` called on CUDA tensors launches the kernel (and raises if the
launch fails) and counts the launch in its ``launches`` and in this
module's :data:`launches`; on CPU tensors it runs :func:`sddmm_plain`.

:meth:`Sddmm.ring` is the ring multi-head instantiation, the backward of a
GAT layer's attention-weighted aggregation (``mpc/gat.py``): per edge and
head, a dot product of int64 (or int32) ring rows over the head's features,
wrapping; :func:`heads_plain` is its plain version and :func:`heads_shape`
picks its instantiation.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.ops.bcsr import edge_arrays
from cognn_tpu_torch.ops.spmm import check_rows, launch_shape
from cognn_tpu_torch.utils import logging_utils as trace
from cognn_tpu_torch.utils.device import resolve_device

# kernel launches made by every Sddmm (a plain count for checks and smoke
# runs)
launches = 0


def bind(lib: ctypes.CDLL):
    """The entry point of a built ``csrc/sddmm.cu`` library, with its C
    signature."""
    fn = lib.cognn_sddmm_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return bind(_build.load("sddmm"))


@functools.cache
def _heads_kernels() -> dict:
    """The ring multi-head entry points by the ring's dtype."""
    lib = _build.load("sddmm")
    out = {torch.int64: lib.cognn_sddmm_heads_i64,
           torch.int32: lib.cognn_sddmm_heads_i32}
    for fn in out.values():
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return out


def heads_shape(f: int, elem_bytes: int, ptrs) -> tuple:
    """The ring multi-head instantiation for heads of ``f`` elements of
    ``elem_bytes``: ``(vec, lanes)``, ``vec`` 16 bytes' worth of elements a
    load where f is a multiple of it and every row start of ``ptrs`` is
    16-byte aligned, else 1; ``lanes`` (a head's) the power of two that
    covers f in loads of vec, at most 32."""
    vec = 16 // elem_bytes
    if f % vec or any(p % 16 for p in ptrs):
        vec = 1
    lanes = 1 << (-(-f // vec) - 1).bit_length()
    if lanes > 32:
        raise ValueError(f"heads of {f} elements: at most {32 * vec}")
    return vec, lanes


def sddmm_plain(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (the port's copy of the JAX package's
    ``sddmm_reference``): per-edge ``<a[src], b[dst]>``."""
    return (a[src] * b[dst]).sum(-1)


def heads_plain(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of the ring multi-head kernels: per edge and head,
    ``Σ_j a[src, k·f + j]·b[dst, k·f + j]``, wrapping in the ring's
    dtype."""
    shape = (src.numel(), heads, a.shape[1] // heads)
    prod = a[src].view(shape) * b[dst].view(shape)
    return prod.sum(-1, dtype=a.dtype)


class Sddmm:
    """Per-edge scores over a fixed edge list, held on ``device`` as int32
    endpoints. ``launches`` counts launches of the f32 kernel,
    ``ring_launches`` and ``ring32_launches`` those of the int64 and int32
    multi-head ones."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_src: int,
                 n_dst: int, device="cuda"):
        dev = resolve_device(device)
        src, dst = edge_arrays(src, dst, n_src, n_dst)
        self.n_src, self.n_dst, self.n_edges = n_src, n_dst, len(src)
        self.src = torch.as_tensor(src.astype(np.int32)).to(dev)
        self.dst = torch.as_tensor(dst.astype(np.int32)).to(dev)
        self.launches = 0
        self.ring_launches = 0
        self.ring32_launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a: f32 [n_src, D], b: f32 [n_dst, D], contiguous, on this edge
        list's device -> f32 [n_edges]."""
        global launches
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
        D = a.shape[1]
        shape = launch_shape(D, 4, (a.data_ptr(), b.data_ptr()))
        with torch.cuda.device(a.device):
            err = _kernel()(self.src.data_ptr(), self.dst.data_ptr(),
                            a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            self.n_edges, D, *shape,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sddmm kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        launches += 1
        return out

    def ring(self, a: torch.Tensor, b: torch.Tensor,
             heads: int) -> torch.Tensor:
        """a: [n_src, H·f], b: [n_dst, H·f], both int64 (Z_2^64) or both
        int32 (Z_2^32), contiguous, on this edge list's device -> [n_edges,
        H] with ``out[e, k] = Σ_j a[src_e, k·f + j]·b[dst_e, k·f + j]`` mod
        2^bits (``heads`` = H)."""
        if a.dtype not in (torch.int64, torch.int32):
            raise TypeError(f"a must be int64 or int32, got {a.dtype}")
        on_cpu = check_rows(a, self.src.device, a.dtype, self.n_src,
                            name="a")
        check_rows(b, self.src.device, a.dtype, self.n_dst, name="b")
        if a.shape[1] != b.shape[1] or heads < 1 or a.shape[1] % heads:
            raise ValueError(f"a has D = {a.shape[1]}, b {b.shape[1]}: not "
                             f"one width of {heads} heads")
        if on_cpu:
            return heads_plain(self.src, self.dst, a, b, heads)
        out = torch.empty((self.n_edges, heads), dtype=a.dtype,
                          device=a.device)
        if self.n_edges == 0 or a.shape[1] == 0:
            return out.zero_()
        f = a.shape[1] // heads
        shape = heads_shape(f, a.element_size(), (a.data_ptr(), b.data_ptr()))
        with torch.cuda.device(a.device):
            err = _heads_kernels()[a.dtype](
                self.src.data_ptr(), self.dst.data_ptr(), a.data_ptr(),
                b.data_ptr(), out.data_ptr(), self.n_edges, heads, f, *shape,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ring sddmm kernel launch failed: CUDA error "
                               f"{err}")
        if a.dtype == torch.int64:
            self.ring_launches += 1
        else:
            self.ring32_launches += 1
        trace.count("gat.sddmm.kernel")
        return out
