"""Synthetic datasets (port of the generator half of
``cognn_tpu/harness/datasets.py``; the file loaders and writers come with the
harness slice).

:func:`synthetic_planetoid` makes deterministic graphs with the same
(n, m, f, c) statistics as Cora/CiteSeer/PubMed and label-homophilous
structure. It draws from numpy exactly as the JAX package does, so both
packages see the same dataset for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from cognn_tpu_torch.config import GNNParam

# (num_samples, num_directed_edges, input_dim, num_labels, lr, train/val/test)
DATASET_STATS: Dict[str, tuple] = {
    "cora": (2708, 10556, 1433, 7, 0.5, (0.2, 0.2, 0.6)),
    "citeseer": (3312, 10016, 3703, 6, 0.8, (0.2, 0.2, 0.6)),
    "pubmed": (19717, 128146, 500, 3, 8.0, (0.05, 0.15, 0.8)),
    "cora_small": (64, 256, 16, 3, 0.5, (0.2, 0.2, 0.6)),
}


@dataclasses.dataclass
class Dataset:
    name: str
    src: np.ndarray
    dst: np.ndarray
    features: np.ndarray
    labels: np.ndarray
    param: GNNParam


def gnn_param_for(name: str, hidden_dim: int = 16,
                  num_layers: int = 2) -> GNNParam:
    n, m, f, c, lr, (tr, va, te) = DATASET_STATS[name]
    return GNNParam(num_layers=num_layers, num_labels=c, input_dim=f,
                    hidden_dim=hidden_dim, num_samples=n, num_edges=m,
                    learning_rate=lr, train_ratio=tr, val_ratio=va,
                    test_ratio=te)


def synthetic_planetoid(name: str, seed: int = 0,
                        homophily: float = 0.85) -> Dataset:
    """Synthetic dataset with the named Planetoid's statistics."""
    n, m, f, c, lr, _ = DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n)
    # sample undirected edges with label homophily
    target_pairs = m // 2
    src_list, dst_list = [], []
    seen = set()
    trials = 0
    # src_list counts directed edges (2 per accepted pair)
    while len(src_list) < 2 * target_pairs and trials < 100 * target_pairs:
        trials += 1
        u = int(rng.integers(0, n))
        if rng.random() < homophily:
            # pick a same-label partner
            v = int(rng.integers(0, n))
            if labels[v] != labels[u]:
                continue
        else:
            v = int(rng.integers(0, n))
        if u == v or (u, v) in seen:
            continue
        seen.add((u, v))
        seen.add((v, u))
        src_list += [u, v]
        dst_list += [v, u]
    src = np.array(src_list, np.int64)
    dst = np.array(dst_list, np.int64)
    # sparse bag-of-words-like features with label signal; PubMed (lr=8.0,
    # TF-IDF in the original) gets row-normalized rows, Cora/CiteSeer keep
    # unit entries
    feats = (rng.random((n, f)) < 0.015).astype(np.float64)
    sig = min(8, f)
    block = (labels[:, None] * sig + np.arange(sig)[None, :]) % f
    feats[np.arange(n)[:, None], block] += 1.0
    if name == "pubmed":
        feats /= np.maximum(feats.sum(axis=1, keepdims=True), 1.0)
    return Dataset(name, src, dst, feats, labels, gnn_param_for(name))
