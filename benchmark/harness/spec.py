"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), which names the system under
test (``systems/<system>.py``) and its plain reference
(``reference/<reference>.py``); its traffic mix (``traffic/<mix>.json``),
which names the loop that drives it (``loops/<loop>.py``); the limits of
its comparison (``limits/<cell>.json``); and each per-layer metric's
reader (``metrics/<metric>.py``). A later cell, mix, loop, system,
reference or metric is a new file."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK_JSON) -> dict:
    return json.loads(Path(path).read_text())


def cell(bench: dict, workload: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                   f"{[c['name'] for c in bench['workloads']]}")


def _json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no {path}")
    return json.loads(path.read_text())


def config(bench: dict, name: str) -> dict:
    """The configuration file that ``BENCHMARK.json`` names for ``name``."""
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(workload: str) -> Dict[str, float]:
    return _json("limits", workload)


def end_to_end(bench: dict, workload: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def module(kind: str, name: str) -> ModuleType:
    """The module of ``<kind>/<name>.py``, loaded once a process (as
    ``benchmark.<kind>.<name>`` where the name allows)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no {path}")
    full = (f"benchmark.{kind}.{name}" if name.isidentifier() else
            f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"))
    if full not in sys.modules:
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
    return sys.modules[full]


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    return module("metrics", name).read
