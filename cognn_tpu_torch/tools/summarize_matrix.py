"""Summarize an evaluation-matrix run of the port into one markdown table
(port of the repo's ``tools/summarize_matrix.py``).

Walks ``<log-root>/<setting>/gcn_test_<dataset>_<p>.log`` and
``<comm-root>/<setting>/`` (the reference's layout, written by
:mod:`cognn_tpu_torch.tools.run_cluster`) and emits one accuracy, duration
and comm row per (setting, dataset) cell, in the columns and order of the
JAX package's summary (``results/matrix/SUMMARY.md``). The header names the
device the runs took, as the caller passes it (on the card: ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``).

  python -m cognn_tpu_torch.tools.summarize_matrix --log-root log \\
      --comm-root comm --out results/matrix_h100/SUMMARY.md \\
      --device "$(nvidia-smi --query-gpu=name,power.limit \\
                  --format=csv,noheader)"
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

from cognn_tpu_torch.tools.log_parse import parse_comm_file, parse_party_log

COLUMNS = ("| setting | dataset | P | loss | test acc | border test acc | "
           "us/iter | iters | MB/party | rounds/epoch | sharded backend |")


def one_cell(logdir: Path, commdir: Path, dataset: str):
    """Aggregate all parties of one (setting, dataset) cell: accuracies
    the mean over parties of each one's last, loss the last party's last,
    us/iter the mean ``::iteration took`` span, comm the mean over the
    parties' ``.comm`` files."""
    logs = sorted(Path(logdir).glob(f"gcn_test_{dataset}_*.log"))
    if not logs:
        return None
    acc = {}
    iters = []
    loss = None
    for lg in logs:
        d = parse_party_log(lg)
        for k, v in d["accuracy"].items():
            if v:
                acc.setdefault(k, []).append(v[-1])
        if d["loss"]:
            loss = d["loss"][-1]
        iters.extend(d["durations"].get("iteration", []))
    sent = recv = rounds = nc = 0
    backend = mode = ""
    for cf in sorted(Path(commdir).glob(f"{dataset}_*.comm")):
        c = parse_comm_file(cf)
        sent += c.get("sent_MB", 0) or 0
        recv += c.get("recv_MB", 0) or 0
        rounds += (c.get("per_epoch_rounds") or {}).get("total", 0)
        backend = c.get("backend", backend)
        mode = c.get("mode", mode)
        nc += 1
    mean = lambda xs: sum(xs) / len(xs) if xs else float("nan")  # noqa
    return {
        "parties": len(logs),
        "loss": loss,
        "test_acc": mean(acc.get("test set", [])),
        "border_test_acc": mean(acc.get("border test set", [])),
        "iter_us": mean(iters) * 1e6 if iters else float("nan"),
        "n_iters": len(iters) // max(len(logs), 1),
        "sent_MB": sent / nc if nc else float("nan"),
        "rounds": rounds / nc if nc else float("nan"),
        "backend": backend,
        "mode": mode,
    }


def cells(log_root: Path, comm_root: Path):
    """[(setting, dataset, cell)] of every setting directory under
    ``log_root``, in the JAX summary's order (settings, then datasets,
    sorted)."""
    rows = []
    for setting_dir in sorted(Path(log_root).iterdir()):
        if not setting_dir.is_dir():
            continue
        setting = setting_dir.name
        datasets = sorted({re.match(r"gcn_test_(.+)_\d+\.log", f.name)[1]
                           for f in setting_dir.glob("gcn_test_*.log")})
        for ds in datasets:
            cell = one_cell(setting_dir, Path(comm_root) / setting, ds)
            if cell:
                rows.append((setting, ds, cell))
    return rows


def row_line(setting: str, ds: str, c: dict) -> str:
    fmt = lambda v, f="{:.4f}": ("-" if v is None or v != v  # noqa
                                 else f.format(v))
    return (f"| {setting} | {ds} | {c['parties']} | {fmt(c['loss'])} | "
            f"{fmt(c['test_acc'])} | {fmt(c['border_test_acc'])} | "
            f"{fmt(c['iter_us'], '{:.1f}')} | {c['n_iters']} | "
            f"{fmt(c['sent_MB'], '{:.2f}')} | "
            f"{fmt(c['rounds'], '{:.0f}')} | {c['backend'] or '-'} |")


def summary(rows, device: str) -> str:
    lines = [
        f"# Evaluation matrix ({device}) — summary",
        "",
        "Produced by `python -m cognn_tpu_torch.tools.summarize_matrix` "
        "from the outputs of `python -m cognn_tpu_torch.tools.run_cluster` "
        f"on {device} (one row per (setting, dataset) cell; accuracy = "
        "final epoch, mean over parties; per-iteration time = mean "
        "`::iteration took` span of a timed window of the whole run, "
        "parties stacked on one device; comm = per-party wire bytes of the "
        "sharded deployment of the same run, counted at its collectives in "
        "party processes over gloo, or analytic where the `.comm` file "
        "says `\"measured\": false`).",
        "",
        COLUMNS,
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    lines += [row_line(setting, ds, c) for setting, ds, c in rows]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cognn_tpu_torch.tools.summarize_matrix")
    ap.add_argument("--log-root", default="log")
    ap.add_argument("--comm-root", default="comm")
    ap.add_argument("--out", default="results/matrix_h100/SUMMARY.md")
    ap.add_argument("--device", required=True,
                    help="the device the runs took, for the header (on the "
                         "card: nvidia-smi's name and power limit)")
    args = ap.parse_args(argv)
    rows = cells(Path(args.log_root), Path(args.comm_root))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(summary(rows, args.device))
    print(f"wrote {out} ({len(rows)} cells)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
