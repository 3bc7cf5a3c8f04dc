"""A cell's inputs, drawn from the run's seed: the graph, its features and
labels, and the seeds of the weights and of the share randomness.

:func:`draw_graph` is a frozen copy of the port's ``synthetic_planetoid``
(``cognn_tpu_torch/harness/datasets.py``): undirected label-homophilous
edges until the configuration's directed edge count is reached, sparse
bag-of-words features with a label signal, PubMed's rows normalised. Its
sizes come from the configuration file, so every seed gives the same
vertex, edge, feature and label counts; only which vertices they join
differs. Nothing here imports the port: the reference reads the same
inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """One drawn graph: ``src``/``dst`` directed edges (both directions of
    each undirected pair), ``features`` float64 [n, F], ``labels`` [n]."""

    n: int
    src: np.ndarray
    dst: np.ndarray
    features: np.ndarray
    labels: np.ndarray


@dataclasses.dataclass(frozen=True)
class Seeds:
    """The seeds one ``--seed`` gives: the graph's numpy generator, the
    Glorot initialiser's ``srand`` and the engine's share generator."""

    graph: int
    glorot: int
    shares: int


def seeds_of(seed: int) -> Seeds:
    """Independent streams from one ``--seed`` (any non-negative integer;
    the driver's exceed 32 bits)."""
    if seed < 0:
        raise ValueError(f"--seed {seed}: a non-negative integer")
    words = np.random.SeedSequence(seed).generate_state(3, np.uint64)
    return Seeds(graph=int(words[0]),
                 glorot=int(words[1] & np.uint64(0x7FFFFFFF)) or 1,
                 shares=int(words[2] >> np.uint64(1)))


def draw_graph(cfg: dict, seed: int) -> Graph:
    """The graph of configuration ``cfg`` from ``seed``: a frozen copy of
    ``synthetic_planetoid``, with its statistics from ``cfg``."""
    n, m = cfg["num_samples"], cfg["num_edges"]
    f, c = cfg["input_dim"], cfg["num_labels"]
    homophily = cfg["homophily"]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n)
    target_pairs = m // 2
    src_list, dst_list = [], []
    seen = set()
    trials = 0
    while len(src_list) < 2 * target_pairs and trials < 100 * target_pairs:
        trials += 1
        u = int(rng.integers(0, n))
        if rng.random() < homophily:
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
    if len(src_list) != 2 * target_pairs:
        raise RuntimeError(f"drew {len(src_list)} of {2 * target_pairs} "
                           "edges")
    feats = (rng.random((n, f)) < cfg["feature_density"]).astype(np.float64)
    sig = min(8, f)
    block = (labels[:, None] * sig + np.arange(sig)[None, :]) % f
    feats[np.arange(n)[:, None], block] += 1.0
    if cfg["row_normalize_features"]:
        feats /= np.maximum(feats.sum(axis=1, keepdims=True), 1.0)
    return Graph(n, np.array(src_list, np.int64), np.array(dst_list, np.int64),
                 feats, labels.astype(np.int64))


def party_of(n: int, parties: int) -> np.ndarray:
    """The reference's partition: vertex v to party v mod P."""
    return np.arange(n) % parties
