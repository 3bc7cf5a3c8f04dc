"""Integer ring Z_2^64 on plain ``torch.int64`` (port of
``cognn_tpu/core/ring.py``).

A ring element is one int64 in two's complement: addition, subtraction,
negation and multiplication wrap mod 2^64, and ``>>`` is the arithmetic shift
that fixed-point truncation needs. The JAX package carries the same value as
two uint32 limbs on a leading axis, because the TPU has no 64-bit integer
datapath; the port has no limb axis. ``torch.uint64`` is not used: it has no
right shift on the CPU.

Host converters take numpy uint64 (the JAX package's host type) and give back
int64 tensors with the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_LO32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class RingSpec:
    bits: int  # 32 or 64

    @property
    def mask(self) -> int:
        return (1 << self.bits) - 1


RING64 = RingSpec(64)


def ring_from_u64(x: np.ndarray, *, device) -> torch.Tensor:
    """numpy uint64 -> int64 tensor with the same bits, on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.uint64).view(np.int64)).to(device)


def ring_to_u64(a: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bits (host side)."""
    return a.detach().cpu().numpy().view(np.uint64)


def ring_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def ring_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def ring_neg(a: torch.Tensor) -> torch.Tensor:
    return -a


def ring_mul(a: torch.Tensor, b) -> torch.Tensor:
    """Elementwise product mod 2^64 (``b`` a tensor or a Python int that
    fits int64)."""
    return a * b


def ring_arith_shift_right(a: torch.Tensor, f: int) -> torch.Tensor:
    """Arithmetic shift right of the two's-complement value by f bits."""
    return a >> f if f else a


def ring_to_f32(a: torch.Tensor, f: int) -> torch.Tensor:
    """Signed fixed-point ring value -> float32, by the reference's float32
    formula step for step (``cognn_tpu/core/ring.py:170-182``): the low 32
    bits as int32, a carry into the high word when they are negative, the
    high word plus carry wrapping in int32, then
    ``(hi_adj * 2^32 + lo_signed) / 2^f`` in float32. Every intermediate is
    formed without int64 overflow."""
    lo = a & _LO32
    neg_lo = lo >> 31  # 1 where the low word is negative as int32
    lo_signed = lo - (neg_lo << 32)
    hi_adj = (a >> 32) + neg_lo  # in [-2^31, 2^31]
    hi_adj = ((hi_adj + (1 << 31)) & _LO32) - (1 << 31)  # int32 wrap
    # powers of two are exact in float32, so the scalars change nothing
    return (hi_adj.to(torch.float32) * 2.0**32
            + lo_signed.to(torch.float32)) / 2.0**f


def ring_from_f32(x: torch.Tensor, f: int) -> torch.Tensor:
    """float32 -> signed fixed-point ring value: ``x * 2^f`` in float32,
    truncated toward zero (C's ``static_cast<int64>``)."""
    return torch.trunc(x.to(torch.float32) * 2.0**f).to(torch.int64)
