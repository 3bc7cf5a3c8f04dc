"""The GCN's per-party loss, accuracies and border count: the CUDA kernel of
``csrc/metrics.cu`` and its plain PyTorch version.

The kernel replaces no TPU kernel: the JAX package computes the metrics
with plain ops that XLA fuses into its jitted forward and epoch, and the
port ran them as some 55 small PyTorch operations, each a node of its CUDA
graphs. The kernel computes the whole dict in one pass over ``prob``, a
cluster of blocks a party (the source describes the design), with the
plain version's definitions; its float64 loss sum runs in another order,
so equality with the plain version rests on the one rounding to f32.

:func:`gcn_metrics` called on CUDA tensors launches the kernel (and raises
if the launch fails) and counts the launch in this module's
:data:`launches` and in the tracer's counter ``gcn_metrics.kernel``; on CPU
tensors it runs :func:`gcn_metrics_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from cognn_tpu_torch.ops import _build
from cognn_tpu_torch.utils import logging_utils as trace

# kernel launches (a plain count for checks and smoke runs)
launches = 0

# the most labels the kernel takes: a row fits its tile of shared memory
# (kTileFloats in csrc/metrics.cu)
MAX_CLASSES = 8192

# the f32 outputs in the kernel's order; then num_border (int64)
F32_KEYS = ("loss", "full_acc", "train_acc", "border_train_acc", "test_acc",
            "border_test_acc")


def bind(lib: ctypes.CDLL):
    """The entry point of a built ``csrc/metrics.cu`` library, with its C
    signature."""
    fn = lib.cognn_gcn_metrics_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return bind(_build.load("metrics"))


def gcn_metrics_plain(prob: torch.Tensor, labels: torch.Tensor,
                      valid: torch.Tensor, train: torch.Tensor,
                      val: torch.Tensor, border: torch.Tensor,
                      num_local: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Plain version of the kernel: the metric definitions of the
    plaintext engine, which the secret-shared engine uses on its revealed
    prediction too."""
    test = valid & ~train & ~val

    y_hot = torch.nn.functional.one_hot(labels, prob.shape[-1]).to(
        prob.dtype)
    clamped = torch.where(prob == 0.0, 0.001, prob)
    loss_rows = -(y_hot * torch.log(clamped)).sum(-1)
    # summed in float64 and rounded once: a CUDA float32 row sum splits
    # a row by how many rows there are, so a party's loss would change
    # in its last bit between the stacked [P, V] and the sharded [1, V]
    # engine
    loss = (torch.where(valid, loss_rows, 0.0).to(torch.float64).sum(-1)
            / num_local).to(prob.dtype)

    hit = prob.argmax(-1) == labels

    def acc(mask):
        n = mask.sum(-1)
        return torch.where(n > 0, (hit & mask).sum(-1) / n.clamp(min=1),
                           0.0)

    return {
        "loss": loss,
        "full_acc": acc(valid),
        "train_acc": acc(train),
        "border_train_acc": acc(train & border),
        "test_acc": acc(test),
        "border_test_acc": acc(test & border),
        "num_border": (valid & border).sum(-1),
    }


def _check(name: str, x: torch.Tensor, device: torch.device,
           dtype: torch.dtype, shape: tuple) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, prob on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gcn_metrics(prob: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor, train: torch.Tensor, val: torch.Tensor,
                border: torch.Tensor,
                num_local: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-party metrics of ``prob`` f32 [P, V, C] (C >= 1): ``labels``
    int64 [P, V], the masks ``valid`` (the party's rows), ``train``,
    ``val`` and ``border`` bool [P, V], ``num_local`` int64 [P], all
    contiguous on one device -> {"loss", "full_acc", "train_acc",
    "border_train_acc", "test_acc", "border_test_acc"} f32 [P] and
    "num_border" int64 [P]. CPU tensors take :func:`gcn_metrics_plain`,
    CUDA tensors the kernel (C up to MAX_CLASSES); raises for any other
    device."""
    global launches
    if prob.dim() != 3 or prob.shape[-1] < 1:
        raise ValueError(f"prob must be [P, V, C] with C >= 1, got "
                         f"{list(prob.shape)}")
    P, V, C = prob.shape
    dev = prob.device
    _check("prob", prob, dev, torch.float32, (P, V, C))
    _check("labels", labels, dev, torch.int64, (P, V))
    for name, mask in (("valid", valid), ("train", train), ("val", val),
                       ("border", border)):
        _check(name, mask, dev, torch.bool, (P, V))
    _check("num_local", num_local, dev, torch.int64, (P,))
    if dev.type == "cpu":
        return gcn_metrics_plain(prob, labels, valid, train, val, border,
                                 num_local)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if V >= 2**31 or C > MAX_CLASSES:
        raise ValueError(f"prob {list(prob.shape)}: the kernel takes V below "
                         f"2^31 and C up to {MAX_CLASSES}")
    f32 = torch.empty((len(F32_KEYS), P), dtype=torch.float32, device=dev)
    num_border = torch.empty(P, dtype=torch.int64, device=dev)
    if P:
        with torch.cuda.device(dev):
            err = _kernel()(prob.data_ptr(), labels.data_ptr(),
                            valid.data_ptr(), train.data_ptr(),
                            val.data_ptr(), border.data_ptr(),
                            num_local.data_ptr(), P, V, C, f32.data_ptr(),
                            num_border.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gcn_metrics kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
        trace.count("gcn_metrics.kernel")
    return {**dict(zip(F32_KEYS, f32)), "num_border": num_border}
