"""Additive secret sharing over Z_2^64 or Z_2^32 (port of
``cognn_tpu/core/shares.py``): a value x splits into (r, x - r) with r
uniform over all 2^bits words; merge is addition mod 2^bits.

Device side: int64 or int32 tensors, randomness from an explicit
``torch.Generator`` (the JAX package's ``jax.random`` keys; the two give
other bits from the same seed, which is why tests compare reconstructed
values, never share bits). Host side: numpy uint64.
"""

from __future__ import annotations

import numpy as np
import torch

from cognn_tpu_torch.core.ring import RING64, RingSpec
from cognn_tpu_torch.utils.logging_utils import phase


def random_words(gen: torch.Generator, shape,
                 dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Uniform words over all 2^64 (int64) or 2^32 (int32) values on
    ``gen``'s device. An int64 word is two 32-bit draws, ``hi * 2^32 + lo``
    with hi signed, so nothing overflows. The draws are the tracer's
    ``prng`` phase; the words' assembly takes the caller's."""
    kw = dict(device=gen.device, generator=gen)
    if dtype == torch.int32:
        with phase("prng"):
            return torch.randint(-(1 << 31), 1 << 31, tuple(shape),
                                 dtype=torch.int32, **kw)
    if dtype != torch.int64:
        raise TypeError(f"ring words are int64 or int32, got {dtype}")
    with phase("prng"):
        hi = torch.randint(-(1 << 31), 1 << 31, tuple(shape),
                           dtype=torch.int64, **kw)
        lo = torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64,
                           **kw)
    return hi * (1 << 32) + lo


def share_split(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Ring value -> [2, *x.shape] shares (r, x - r) of x's dtype."""
    r = random_words(gen, x.shape, x.dtype)
    return torch.stack([r, x - r])


def share_merge(s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    return s0 + s1


def share_split_np(x_u64: np.ndarray, rng: np.random.Generator,
                   spec: RingSpec = RING64):
    x_u64 = np.asarray(x_u64, dtype=np.uint64)
    r = rng.integers(0, 1 << 64, size=x_u64.shape, dtype=np.uint64)
    mask = np.uint64(spec.mask)
    return r & mask, (x_u64 - r) & mask


def share_merge_np(s0: np.ndarray, s1: np.ndarray,
                   spec: RingSpec = RING64) -> np.ndarray:
    return (np.asarray(s0, np.uint64) + np.asarray(s1, np.uint64)) \
        & np.uint64(spec.mask)
