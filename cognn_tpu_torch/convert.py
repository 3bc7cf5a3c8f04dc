"""Carry state over from the JAX package."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cognn_tpu_torch.utils.device import resolve_device


def weights_from_jax(weights: Sequence[np.ndarray],
                     device="cuda") -> List[torch.Tensor]:
    """``cognn_tpu`` ``GasEngine.weights`` (one [P, d_in, d_out] array per
    layer, as numpy) -> the port's ``GasEngine.weights`` on ``device``."""
    dev = resolve_device(device)
    out = []
    for l, w in enumerate(weights):
        a = np.asarray(w)
        if a.ndim != 3:
            raise ValueError(f"layer {l}: expected [P, d_in, d_out], got "
                             f"shape {a.shape}")
        out.append(torch.tensor(a, dtype=torch.float32, device=dev))
    return out
