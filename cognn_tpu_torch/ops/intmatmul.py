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
any 64-bit operands: the 36 byte-limb products with ``i + j <= 7`` on the
int8 tensor cores, summed per shift in int32 and flushed into uint64 every
:data:`K_CHUNK` of K (the source gives the proof that this is exact). With
one kernel for every operand the ``"small"`` / ``"full"`` choice has nothing
left to choose, and the A-side prep of the reference shrinks to hoisting the
reconstruct.

:func:`ring_matmul` on CUDA tensors launches the kernel and counts the launch
in :data:`launches`; on CPU tensors it runs :func:`ring_matmul_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cognn_tpu_torch.ops import _build

# kernel launches made by ring_matmul (a plain count for checks and smoke runs)
launches = 0

_CHUNK_BYTES = 256 << 20  # the plain version's per-chunk product tensor

# K between the kernel's flushes of its int32 shift sums into uint64
# (kChunkK of csrc/ring_matmul.cu): 8 pairs * 255^2 * 4096 < 2^31 - 1
K_CHUNK = 4096
STAGE_K = 128  # the kernel's K slices are whole stages of B's limb planes
BLOCK_ROWS, BLOCK_COLS = 64, 16  # C a block owns
BLOCKS_PER_SM = 3  # resident blocks an SM holds (kBlocksPerSm)


@functools.cache
def _kernel():
    fn = _build.load("ring_matmul").cognn_ring_matmul_i64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
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


def k_slice(batch: int, n: int, k: int, m: int, sms: int) -> int:
    """The K of one kernel block: K is split into slices of whole stages
    only as far as the blocks of all slices still fit on the card's ``sms``
    SMs at once (one wave: a second, part-filled wave costs more than the
    split saves); with more than one slice the blocks' partial C add into a
    zeroed C with wrapping 64-bit atomics."""
    stages = max(1, math.ceil(k / STAGE_K))
    blocks = batch * math.ceil(n / BLOCK_ROWS) * math.ceil(m / BLOCK_COLS)
    slices = min(stages, max(1, BLOCKS_PER_SM * sms // blocks))
    return math.ceil(stages / slices) * STAGE_K


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if B * N * M == 0 or K == 0:
        return torch.zeros((B, N, M), dtype=torch.int64, device=a.device)
    ks = k_slice(B, N, K, M, _sms(a.device.index or 0))
    out = (torch.empty if ks >= K else torch.zeros)(
        (B, N, M), dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, K,
                        M, ks, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ring_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
