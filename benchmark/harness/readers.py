"""What the per-layer metrics read, and the readings that each of
``metrics/<name>.py`` takes from it. A reader returns None where its cell
gives it nothing to read (another loop, no device operation of its kind in
the trace), and the harness leaves that metric out of the line. Work
counts come from the configuration's shapes (:mod:`benchmark.harness.work`
for the GCN's); a later metric brings its own reader, and its own counts
where it needs them."""

from __future__ import annotations

import dataclasses
from typing import Optional

from benchmark.harness.trace import Stretch

K3 = "ring_matmul"  # csrc/ring_matmul.cu: ring_matmul_u8_mma
SPMM = "csr_gather_sum"  # csrc/spmm.cu
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync")


@dataclasses.dataclass
class Reading:
    """A traced run's material: the loop's ``role`` (``ROLE``: "train",
    "serve") and ``unit`` ("epoch", "request"), the configuration, the
    cards, the traced stretch, and the untraced rest of the traced window
    (``after_units`` units in ``after_s`` seconds, the card's utilization
    counter over it, %)."""

    role: str
    unit: str
    cfg: dict
    chips: int
    stretch: Stretch
    after_units: int
    after_s: float
    utilization: Optional[float] = None


def _device(r: Reading, match) -> float:
    return sum(s for name, s in r.stretch.device_s.items() if match(name))


def idle_share(r: Reading, role: str) -> Optional[float]:
    """% of the untraced rest of the window in which no kernel runs on the
    card: 100 less the card's utilization counter over that same stretch
    (the profiler's own host work would count as idle in the traced
    one)."""
    if r.role != role or r.utilization is None:
        return None
    return 100.0 - r.utilization


def mfu(r: Reading, role: str, flops_per_unit: float,
        peak_per_card: float) -> Optional[float]:
    """% of the cards' peak that ``flops_per_unit`` a unit reaches over the
    untraced rest of the traced window (host clock: seconds of work)."""
    if r.role != role or r.after_units <= 0 or r.after_s <= 0:
        return None
    return (100.0 * flops_per_unit * r.after_units
            / (r.after_s * r.chips * peak_per_card))


def roofline(r: Reading, role: str, kernel: str, bound_per_unit: float
             ) -> Optional[float]:
    """% of the launches' device time that their least time
    (``bound_per_unit`` seconds a unit, from the shapes) is."""
    t = _device(r, lambda name: kernel in name)
    if r.role != role or t <= 0:
        return None
    return 100.0 * bound_per_unit * r.stretch.units / t


def others_us(r: Reading, role: str) -> Optional[float]:
    """Device µs a unit of every operation that is neither K3 nor the ring
    SpMM: the share arithmetic of the protocol layer."""
    if r.role != role or not r.stretch.device_s:
        return None
    t = _device(r, lambda n: not any(k in n for k in (K3, SPMM)))
    return 1e6 * t / r.stretch.units


def host_launches(r: Reading, role: str) -> Optional[float]:
    """The host's launch calls (graph launches, kernel launches, async
    copies) a unit."""
    calls = sum(n for name, n in r.stretch.host_calls.items()
                if name.startswith(LAUNCH_CALLS))
    if r.role != role or calls == 0:
        return None
    return calls / r.stretch.units
