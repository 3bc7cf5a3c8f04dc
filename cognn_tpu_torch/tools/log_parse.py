"""Log parsing of the per-party logs (port of the repo's
``tools/plot/log_parse.py``, used by
:mod:`cognn_tpu_torch.tools.summarize_matrix`).

Parses the per-party log format both packages and the reference emit
(reference `tools/plot/plot_duration_breakdown_and_comm.py:23-47` greps the
same lines)."""

from __future__ import annotations

import json
import re
from pathlib import Path

DUR_RE = re.compile(r"^::(\S+) took ([0-9.eE+-]+)")
ACC_RE = re.compile(r"^(.*) accuracy = ([0-9.eE+-]+)")
LOSS_RE = re.compile(r"^cross-entropy-loss = ([0-9.eE+-]+)")


def parse_party_log(path: str | Path) -> dict:
    """Returns {"durations": {tag: [secs...]}, "accuracy": {name: [...]},
    "loss": [...]}"""
    durations: dict = {}
    accuracy: dict = {}
    loss = []
    for line in Path(path).read_text().splitlines():
        m = DUR_RE.match(line)
        if m:
            durations.setdefault(m.group(1), []).append(float(m.group(2)))
            continue
        m = LOSS_RE.match(line)
        if m:
            loss.append(float(m.group(1)))
            continue
        m = ACC_RE.match(line)
        if m:
            accuracy.setdefault(m.group(1).strip(), []).append(
                float(m.group(2)))
    return {"durations": durations, "accuracy": accuracy, "loss": loss}


def parse_comm_file(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())


def epoch_durations(durs: list, iters_per_epoch: int) -> list:
    """Group per-iteration spans into per-epoch sums
    (reference `plot_duration_and_comm_scale.py:128-134`)."""
    out = []
    for i in range(0, len(durs) - iters_per_epoch + 1, iters_per_epoch):
        out.append(sum(durs[i:i + iters_per_epoch]))
    return out
