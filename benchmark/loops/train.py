"""The ``train`` loop: a closed-loop training job, dispatched
``epochs_per_dispatch`` epochs at a time, each dispatch's stacked metrics
fetched to the host, training on from the weights the last dispatch left.

Set-up runs the first ``checked_steps`` epochs through the window's own
call and keeps what the check reads of them: each party's losses and the
weights before the first, after the first and after the last. The window
reports ``epoch_ms``: its wall time over the epochs completed in it. The
check compares those steps with the reference's.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Tuple

import numpy as np

from benchmark.harness import check

UNIT = "epoch"  # what one unit of work is
ROLE = "train"  # the suffix of this loop's per-layer metrics


class Job:
    def __init__(self, sut, traffic: dict, seed: int):
        self.sut, self.traffic = sut, traffic
        self.n = traffic["epochs_per_dispatch"]
        self.trace_warmup, self.trace_steps = 1, traffic["traced_dispatches"]
        t0 = time.time()
        steps = traffic["checked_steps"]
        w0 = sut.weights()
        first = sut.epochs(1)["loss"]
        w1 = sut.weights()
        rest = sut.epochs(steps - 1)["loss"]
        self.prog = {"loss": np.concatenate([first, rest], axis=1),
                     "w0": w0, "w1": w1, "wn": sut.weights()}
        print(f"set-up: {steps} checked epochs {time.time() - t0:.3f} s",
              file=sys.stderr, flush=True)
        sut.epochs(self.n)  # the window's shape: n stacked epochs

    def step(self, k: int) -> int:
        """``k`` dispatches; the epochs they ran."""
        for _ in range(k):
            self.sut.epochs(self.n)
        return k * self.n

    def window(self, seconds: float) -> Tuple[int, Dict[str, float]]:
        units, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            units += self.step(1)
        wall = time.perf_counter() - t0
        return units, ({"epoch_ms": 1e3 * wall / units} if units else {})

    def close(self) -> None:
        self.sut = None

    def numbers(self, reference, cfg: dict, graph, seeds, device
                ) -> Dict[str, float]:
        ref = reference.for_config(cfg, graph, seeds, device)
        return check.train_numbers(
            self.prog, ref.readings(self.traffic["checked_steps"]),
            cfg["learning_rate"])
