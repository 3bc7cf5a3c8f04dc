"""Device time of a kernel call on the card, and the card's memory rate for
byte bounds, shared by ``chip_smoke.py`` and the microbenchmark
``cognn_tpu_torch.tools.bench_spmm``."""

from __future__ import annotations

import torch

from cognn_tpu_torch.utils.device import resolve_device

WARMUP = 5  # untimed calls before each window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)


def device_ms(fn, calls: int = 100, device="cuda") -> float:
    """Device time of one ``fn()``: CUDA events around ``calls`` back-to-back
    calls, queued behind a sleep kernel so host launch overhead leaves no
    gaps on the device. ``fn`` runs ``WARMUP + calls`` times. Inputs stay
    L2-resident (warm) where they fit. Raises unless ``device`` is a CUDA
    device that is present: there is no host-clock fallback."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_ms times CUDA work, not {dev}")
    with torch.cuda.device(dev):
        for _ in range(WARMUP):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25 ms: time to queue the calls
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / calls
