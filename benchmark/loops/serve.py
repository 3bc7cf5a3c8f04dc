"""The ``serve`` loop: closed loop, one client. The parties answer one
full-graph inference at a time on the weights of ``train_epochs`` epochs of
training, each answer's revealed logits fetched to the host.

The window reports ``request_p50_ms`` and ``request_p95_ms`` of every
request in it, each from the call to its answer on the host. They are read
from CUDA events recorded at the call and after the answer is on the host:
the device's clock over the same interval, since a reading of the host's
clock is trusted only over spans of a quarter of a second or more. The
check compares a sample of the window's answers, drawn from the seed, with
the reference's logits.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import check

UNIT = "request"
ROLE = "serve"


class Sample:
    """A reservoir of ``k`` served answers, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0
        self.kept: List[torch.Tensor] = []

    def offer(self, answer: torch.Tensor) -> None:
        if len(self.kept) < self.k:
            self.kept.append(answer)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = answer
        self.seen += 1


class Job:
    def __init__(self, sut, traffic: dict, seed: int):
        self.sut, self.traffic = sut, traffic
        self.trace_warmup = traffic["warm_requests"]
        self.trace_steps = traffic["traced_requests"]
        sut.epochs(traffic["train_epochs"])
        self.sample = Sample(traffic["sampled_answers"], seed)
        for _ in range(traffic["warm_requests"]):
            sut.request()
        self.answers: List[np.ndarray] = []

    def step(self, k: int) -> int:
        for _ in range(k):
            self.sample.offer(self.sut.request())
        return k

    def window(self, seconds: float) -> Tuple[int, Dict[str, float]]:
        cuda = self.sut.device.type == "cuda"  # the tests' CPU runs: no times
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        lat: List[float] = []
        units, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if cuda:
                start.record()
            units += self.step(1)
            if cuda:
                end.record()
                end.synchronize()
                lat.append(start.elapsed_time(end))
        if not lat:
            return units, {}
        return units, {"request_p50_ms": float(np.percentile(lat, 50)),
                       "request_p95_ms": float(np.percentile(lat, 95))}

    def close(self) -> None:
        self.answers = [self.sut.rows(z) for z in self.sample.kept]
        self.sut = None

    def numbers(self, reference, cfg: dict, graph, seeds, device
                ) -> Dict[str, float]:
        ref = reference.for_config(cfg, graph, seeds, device)
        logits, valid = ref.served(self.traffic["train_epochs"])
        return check.serve_numbers(self.answers, logits, valid)

