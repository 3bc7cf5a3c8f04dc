"""The GAT in float64, in plain PyTorch (no kernel or engine of the port,
no JAX): :func:`gat_float`, the published forward (Veličković et al., ICLR
2018, arXiv:1710.10903) under the secret-shared engine's recipe (no
dropout, self-loops, one replica of the leaves a party), differentiated by
autograd, is the independent check of the hand-written backward
(:mod:`cognn_tpu_torch.mpc.gat`). The plain fixed-point reference the
engine must equal bit for bit is the benchmark's
(``benchmark/reference/gat_fixed.py`` ``GatFixed``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def gat_float(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              leaves: Sequence[torch.Tensor], heads: Sequence[int],
              slope: float = 0.2) -> torch.Tensor:
    """The logits ``[P, Vr, C]`` of the GAT on stacked rows ``x [P, Vr,
    F]``: ``src``, ``dst`` index the flat P·Vr rows (self-loops included);
    ``leaves`` are ``W [P, d_in, H·f]``, ``a_l``, ``a_r [P, H, f]`` a layer
    (party p's rows use party p's replica); ``heads`` the heads of each
    layer, concatenated after ELU on the hidden layers, averaged on the
    last."""
    P, Vr = x.shape[:2]
    N, L = P * Vr, len(heads)
    h = x
    for l in range(L):
        W, a_l, a_r = leaves[3 * l:3 * l + 3]
        H = heads[l]
        z = torch.bmm(h, W).reshape(P, Vr, H, -1)
        el = (z * a_l[:, None]).sum(-1).reshape(N, H)
        er = (z * a_r[:, None]).sum(-1).reshape(N, H)
        e = torch.nn.functional.leaky_relu(el[src] + er[dst], slope)
        index = dst[:, None].expand_as(e)
        top = e.new_full((N, H), -np.inf).scatter_reduce(
            0, index, e.detach(), "amax")
        ex = torch.exp(e - top[dst])
        alpha = ex / ex.new_zeros(N, H).index_add(0, dst, ex)[dst]
        zf = z.reshape(N, H, -1)
        y = zf.new_zeros(zf.shape).index_add(0, dst,
                                             alpha[..., None] * zf[src])
        h = (y.mean(1) if l == L - 1 else
             torch.nn.functional.elu(y.reshape(N, -1))).reshape(P, Vr, -1)
    return h


def train_loss(logits: torch.Tensor, labels: torch.Tensor,
               train_mask: torch.Tensor) -> torch.Tensor:
    """The cross-entropy summed over the training rows: its gradient with
    respect to the logits is the engine's ``p - y`` on those rows."""
    logp = torch.log_softmax(logits, -1)
    picked = logp.gather(-1, labels[..., None]).squeeze(-1)
    return -(picked * train_mask).sum()
