"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``benchmark/reference``), each number held to
its limit from ``limits/<cell>.json``.

Training: each party's loss of the first steps, the norm of the first
gradient as the optimizer got it (``(W0 - W1) / lr``, from the weights
before and after step 1) and the norm of the weights' change after the
steps, each by its worst leaf: the gap between the program's norm and the
reference's, over the larger of that leaf's reference norm and the median
leaf's. A leaf is a layer's weights, all the parties' replicas. Leaves
whose reference gradient is under a thousandth of the median leaf's are
left out (none of these cells has one).

Serving: the largest gap between a sampled served answer's logit and the
reference's, over the reference's largest logit, on every real vertex.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

TINY_LEAF = 1e-3  # leaves whose gradient is under this share of the median


def _norms(leaves: List[np.ndarray]) -> List[float]:
    return [float(np.linalg.norm(x.ravel())) for x in leaves]


def _worst_leaf(prog: List[np.ndarray], ref: List[np.ndarray],
                keep: List[int]) -> float:
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn[i] for i in keep)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.max([np.float64(abs(pn[i] - rn[i])) / max(rn[i], med)
                             for i in keep]))


def train_numbers(prog: dict, ref: dict, lr: float) -> Dict[str, float]:
    """``prog``/``ref``: {"loss" [P, steps], "w0", "w1", "wn": float64
    [P, d_in, d_out] a layer}."""
    loss_p = np.asarray(prog["loss"], np.float64)
    loss_r = np.asarray(ref["loss"], np.float64)
    if loss_p.shape != loss_r.shape:
        return {"loss_gap": float("nan"), "grad_gap": float("nan"),
                "change_gap": float("nan")}
    grad_p = [(a - b) / lr for a, b in zip(prog["w0"], prog["w1"])]
    grad_r = [(a - b) / lr for a, b in zip(ref["w0"], ref["w1"])]
    rn = _norms(grad_r)
    med = statistics.median(rn)
    keep = [i for i, x in enumerate(rn) if x >= TINY_LEAF * med]
    change_p = [b - a for a, b in zip(prog["w0"], prog["wn"])]
    change_r = [b - a for a, b in zip(ref["w0"], ref["wn"])]
    return {
        "loss_gap": float(np.max(np.abs(loss_p - loss_r) / np.abs(loss_r))),
        "grad_gap": _worst_leaf(grad_p, grad_r, keep),
        "change_gap": _worst_leaf(change_p, change_r, keep),
    }


def serve_numbers(answers: List[np.ndarray], ref_logits: np.ndarray,
                  valid: np.ndarray) -> Dict[str, float]:
    """``answers``: sampled served logits in the reference's layout
    [P, Vr, C]; ``valid`` [P, Vr] marks the real vertices."""
    if not answers:
        return {"logit_gap": float("nan")}
    ref = ref_logits[valid]
    scale = float(np.abs(ref).max())
    gap = float(np.max([np.abs(a[valid] - ref).max() for a in answers]))
    return {"logit_gap": gap / scale}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (NaN fails), and every limit
    read."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in numbers)
