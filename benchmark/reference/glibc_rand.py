"""glibc ``rand()`` and the reference's Glorot initialiser, a frozen copy
of the port's ``cognn_tpu_torch/utils/glibc_rand.py``: the reference draws
its weights itself.

The CoGNN reference initialises each layer's weights after ``srand(seed)``
with ``rand() / RAND_MAX`` (``optimize-gcn/gcn.h:838-852``), glibc's
default TYPE_3 generator:

  r[0] = seed; r[i] = 16807 r[i-1] mod (2^31 - 1) for i in 1..30;
  r[i] = r[i-31] for i in 31..33; r[i] = r[i-3] + r[i-31] mod 2^32 after;
  the k-th call returns r[344 + k] >> 1.
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647


def glibc_rand(seed: int, count: int) -> np.ndarray:
    """The first ``count`` outputs of ``rand()`` after ``srand(seed)``."""
    seed = seed & 0xFFFFFFFF or 1
    r = [0] * 34
    r[0] = seed
    for i in range(1, 31):
        r[i] = (16807 * r[i - 1]) % 2147483647
    for i in range(31, 34):
        r[i] = r[i - 31]
    for i in range(34, 344 + count):
        r.append((r[i - 3] + r[i - 31]) & 0xFFFFFFFF)
    return np.array(r[344:], np.int64) >> 1


def glorot_init(dim0: int, dim1: int, seed: int) -> np.ndarray:
    """float64 [dim0, dim1]: rand()/RAND_MAX * 2 limit - limit with
    limit = sqrt(6 / (dim0 + dim1)), re-seeded for each layer."""
    limit = np.sqrt(6.0 / (dim0 + dim1))
    draws = glibc_rand(seed, dim0 * dim1).astype(np.float64)
    return (draws / RAND_MAX * 2.0 * limit - limit).reshape(dim0, dim1)
