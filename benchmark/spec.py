"""Discovery: a cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* configuration ``c``: the ``file`` of its entry in ``configs``;
* traffic mix ``t``: ``benchmark/traffic/<t>.json``, which names the
  program's entry point (a method of ``solver.PoissonSolver``) and how to
  read its result;
* end-to-end metric ``m``: ``benchmark/end_to_end/<m>.py``;
* per-layer metric ``m``: ``benchmark/metrics/<m>.py``.

Each metric module has ``read(run) -> float | None`` (``None``: nothing to
read in this run, and the metric is left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    workload: dict  # its entry in ``workloads``
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, bench: dict = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in reported]
    return Cell(name, w, config, traffic, e2e, per_layer)


def reader(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module of metric ``name``: ``benchmark/<kind>/<name>.py``."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
