"""Additive secret sharing over Z_2^64 (port of ``cognn_tpu/core/shares.py``):
a value x splits into (r, x - r) with r uniform over all 2^64 words; merge is
addition mod 2^64.

Device side: int64 tensors, randomness from an explicit ``torch.Generator``
(the JAX package's ``jax.random`` keys; the two give other bits from the same
seed, which is why tests compare reconstructed values, never share bits).
Host side: numpy uint64.
"""

from __future__ import annotations

import numpy as np
import torch


def random_words(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform int64 words over all 2^64 values on ``gen``'s device, from
    two 32-bit draws: ``hi * 2^32 + lo`` with hi signed, so nothing
    overflows."""
    kw = dict(dtype=torch.int64, device=gen.device, generator=gen)
    hi = torch.randint(-(1 << 31), 1 << 31, tuple(shape), **kw)
    lo = torch.randint(0, 1 << 32, tuple(shape), **kw)
    return hi * (1 << 32) + lo


def share_split(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """int64 ring value -> int64 [2, *x.shape] shares (r, x - r)."""
    r = random_words(gen, x.shape)
    return torch.stack([r, x - r])


def share_merge(s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    return s0 + s1


def share_split_np(x_u64: np.ndarray, rng: np.random.Generator):
    x_u64 = np.asarray(x_u64, dtype=np.uint64)
    r = rng.integers(0, 1 << 64, size=x_u64.shape, dtype=np.uint64)
    return r, x_u64 - r


def share_merge_np(s0: np.ndarray, s1: np.ndarray) -> np.ndarray:
    return np.asarray(s0, np.uint64) + np.asarray(s1, np.uint64)
