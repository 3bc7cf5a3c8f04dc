"""Exact integer matmul mod 2^64: the CUDA kernel ``csrc/ring_matmul.cu``
and its plain PyTorch version (port of ``cognn_tpu/ops/intmatmul.py``).

Secret-shared fixed-point values live in Z_2^64; the share-space product
(X0+X1)·(W0+W1) reduces to ONE exact matmul mod 2^64 of the reconstructed
ring values, then truncation and re-sharing (:mod:`cognn_tpu_torch.mpc`).

The JAX package builds this product out of int8 MXU dots on byte limbs
(``ring_matmul`` :58, 36 dots for any operands; ``ring_matmul_small_prepped``
:147, 24 dots when both operands fit int32, picked by the protocol's
``matmul_path``). cuBLAS has no 64-bit integer GEMM and PyTorch's int64
``bmm`` does not run on CUDA, so the port has a kernel of its own, exact for
any 64-bit operands. With one kernel for every operand the ``"small"`` /
``"full"`` choice, which traded MXU dots, has nothing left to choose, and the
A-side prep of the reference shrinks to hoisting the reconstruct.

:func:`ring_matmul` on CUDA tensors launches the kernel and counts the launch
in :data:`launches`; on CPU tensors it runs :func:`ring_matmul_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cognn_tpu_torch.ops import _build

# kernel launches made by ring_matmul (a plain count for checks and smoke runs)
launches = 0

_CHUNK_BYTES = 256 << 20  # the plain version's per-chunk product tensor


@functools.cache
def _kernel():
    fn = _build.load("ring_matmul").cognn_ring_matmul_i64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ring_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``a [B, N, K] @ b [B, K, M]`` mod 2^64,
    as int64 products summed over K in chunks (each chunk's product tensor
    under 256 MB). Elementwise int64 ``*`` and ``sum`` wrap on both devices,
    while ``torch.bmm`` has no int64 path on CUDA, so this form serves as
    the reference on the card too."""
    B, N, K = a.shape
    M = b.shape[-1]
    kc = max(1, _CHUNK_BYTES // max(1, 8 * B * N * M))
    out = torch.zeros((B, N, M), dtype=torch.int64, device=a.device)
    for k0 in range(0, K, kc):
        k1 = min(K, k0 + kc)
        out += (a[:, :, k0:k1, None] * b[:, None, k0:k1, :]).sum(-2)
    return out


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a [B, N, K] @ b [B, K, M]`` mod 2^64 on int64, batched over
    the leading (party) axis."""
    global launches
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"ring_matmul takes int64, got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} are "
                         "not [B, N, K] @ [B, K, M]")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return ring_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    a, b = a.contiguous(), b.contiguous()
    B, N, K = a.shape
    M = b.shape[-1]
    out = torch.empty((B, N, M), dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, K,
                        M, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ring_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
