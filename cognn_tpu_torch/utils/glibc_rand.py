"""Bit-exact glibc ``rand()`` and the reference's Glorot initializer
(port of ``cognn_tpu/utils/glibc_rand.py``; both packages start from the
same weights).

The reference initializes GCN weights with C ``std::srand(42)`` +
``std::rand()/RAND_MAX`` (reference `optimize-gcn/gcn.h:838-852`, `initWeight`).

Algorithm (glibc stdlib/random_r.c, the default TYPE_3 generator):
  r[0]   = seed
  r[i]   = (16807 * r[i-1]) mod 2147483647          for i in 1..30
  r[i]   = r[i-31]                                   for i in 31..33
  r[i]   = (r[i-3] + r[i-31]) mod 2^32               for i >= 34
  output k-th call (k>=0): r[344+k] >> 1
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647


class GlibcRand:
    """Stateful bit-exact clone of glibc ``srand``/``rand``."""

    def __init__(self, seed: int = 1):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            r[i] = (16807 * r[i - 1]) % 2147483647
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        self._r = r
        self._idx = 344

    def rand(self) -> int:
        r = self._r
        i = self._idx
        val = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        r.append(val)
        self._idx += 1
        return val >> 1

    def rand_array(self, n: int) -> np.ndarray:
        """n consecutive rand() outputs."""
        return np.array([self.rand() for _ in range(n)], np.int64)


def glorot_init(dim0: int, dim1: int, seed: int = 42) -> np.ndarray:
    """The reference's Glorot init (reference `optimize-gcn/gcn.h:838-852`).

    Each call re-seeds (the reference calls ``std::srand(42)`` inside
    ``initWeight``, so both layers draw the same stream):
      W[i][j] = rand()/RAND_MAX * 2*limit - limit,  limit = sqrt(6/(dim0+dim1))
    """
    rng = GlibcRand(seed)
    limit = np.sqrt(6.0 / (dim0 + dim1))
    draws = rng.rand_array(dim0 * dim1).astype(np.float64)
    w = draws / RAND_MAX * 2.0 * limit - limit
    return w.reshape(dim0, dim1)
