"""GNN hyperparameters (port of ``cognn_tpu/config.py``).

:class:`GNNParam` parses the reference's ``key : value`` config files
(reference `include/task/task.h:78-170`), so the reference's
`build_from_source/config/*.txt` files work unmodified.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple


@dataclasses.dataclass
class GNNParam:
    """GNN hyperparameters (reference `task/task.h:78-105`)."""

    num_layers: int = 2
    num_labels: int = 7
    input_dim: int = 1433
    hidden_dim: int = 16
    num_samples: int = 2708
    num_edges: int = 10556
    learning_rate: float = 0.5
    train_ratio: float = 0.2
    val_ratio: float = 0.2
    test_ratio: float = 0.6

    _INT_KEYS = {
        "num_layers",
        "num_labels",
        "input_dim",
        "hidden_dim",
        "num_samples",
        "num_edges",
    }
    _FLOAT_KEYS = {"learning_rate", "train_ratio", "val_ratio", "test_ratio"}

    @classmethod
    def read_config(cls, path: str | Path) -> "GNNParam":
        """Parse a ``key : value`` config file (reference `task/task.h:106-169`).

        Unknown keys are ignored; ``#`` starts a comment.
        """
        param = cls()
        for raw in Path(path).read_text().splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip()
            if key in cls._INT_KEYS:
                setattr(param, key, int(value))
            elif key in cls._FLOAT_KEYS:
                setattr(param, key, float(value))
        return param

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        """(input_dim, hidden_dim, ..., num_labels) — one entry per layer edge."""
        return (
            self.input_dim,
            *([self.hidden_dim] * (self.num_layers - 1)),
            self.num_labels,
        )
