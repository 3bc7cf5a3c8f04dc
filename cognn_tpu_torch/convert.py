"""Carry state over from the JAX package (plaintext weights; the
secret-shared engine's encoded shares and normalizers)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def _limbs_to_int64(a: np.ndarray, limb_axis: int, dev) -> torch.Tensor:
    """uint32 limbs (limb 0 least significant) on ``limb_axis`` -> the
    port's int64 ring values (``lo | hi << 32``, same bits)."""
    a = np.asarray(a)
    if a.dtype != np.uint32 or a.shape[limb_axis] != 2:
        raise ValueError(f"expected uint32 with 2 limbs on axis {limb_axis}, "
                         f"got {a.dtype} {a.shape}")
    lo, hi = (np.take(a, i, axis=limb_axis).astype(np.uint64)
              for i in (0, 1))
    return torch.from_numpy((lo | (hi << np.uint64(32))).view(np.int64)).to(
        dev)


def mpc_state_from_jax(x0_sh: np.ndarray, weights_sh: Sequence[np.ndarray],
                       n0_fp: np.ndarray, device="cuda"
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  torch.Tensor]:
    """``cognn_tpu`` ``MpcGasEngine`` state (as numpy uint32 limb arrays)
    -> the port's, for :meth:`cognn_tpu_torch.mpc.MpcGasEngine.
    install_state`: ``x0_sh [2(share), 2(limb), P, V, F]`` -> int64
    ``[2, P, V, F]``; each ``weights_sh`` layer ``[2, 2, P, d_in, d_out]``
    -> ``[2, P, d_in, d_out]``; ``n0_fp [2(limb), P, V]`` -> ``[P, V]``."""
    dev = resolve_device(device)
    return (_limbs_to_int64(x0_sh, 1, dev),
            [_limbs_to_int64(w, 1, dev) for w in weights_sh],
            _limbs_to_int64(n0_fp, 0, dev))
