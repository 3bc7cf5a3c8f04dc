"""Fixed-point codec over the share ring (port of
``cognn_tpu/core/fixedpoint.py``).

Encoding follows C: ``(int64)(x * 2^f)``, truncation toward zero, stored as a
two's-complement ring element. ``f`` is the reference's ``SCALER_BIT_LENGTH``
(default 16). Host side, numpy uint64 in and out, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cognn_tpu_torch.core.ring import RING64, RingSpec


@dataclasses.dataclass(frozen=True)
class FixedPointSpec:
    ring: RingSpec = RING64
    frac_bits: int = 16

    def __post_init__(self):
        if self.ring.bits != 64:
            raise NotImplementedError(
                f"a {self.ring.bits}-bit ring comes with a later slice of the "
                "port; the secret-shared inference slice runs Z_2^64")

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits


DEFAULT_FP = FixedPointSpec()


def fp_encode(x, spec: FixedPointSpec = DEFAULT_FP) -> np.ndarray:
    """double -> uint64 ring value (numpy, host side)."""
    fixed = np.trunc(np.asarray(x, np.float64) * spec.scale).astype(np.int64)
    return fixed.astype(np.uint64)


def fp_decode(u, spec: FixedPointSpec = DEFAULT_FP) -> np.ndarray:
    """uint64 ring value -> double (numpy, host side)."""
    signed = np.asarray(u, np.uint64).astype(np.int64)
    return signed.astype(np.float64) / spec.scale
