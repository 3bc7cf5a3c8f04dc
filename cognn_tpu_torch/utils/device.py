"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no card is present (there is no silent CPU fallback: CPU runs ask for
    ``device="cpu"``).

    On CUDA this also switches TF32 off for matmuls and cuDNN, so float32
    products stay float32 as in the JAX reference (TF32 keeps ~3 digits)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
