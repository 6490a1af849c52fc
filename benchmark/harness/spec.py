"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration's file, its traffic mix's file, its limits and the
per-layer metrics that the cell reports.

A cell names a configuration and a traffic mix. The configuration's file
is the one its ``configs`` entry names; the traffic mix is
``benchmark/traffic/<traffic>.json``, which names the module that runs
it (``benchmark/drivers/<name>.py``) and holds its parameters; the limits
on the numbers that ``correct`` compares are
``benchmark/limits/<cell>.json``; each per-layer metric is read by
``benchmark/metrics/<metric>.py``. Adding a configuration, a mix, a cell
or a metric therefore adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import json
import os

BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: str | None = None
    workloads: tuple | None = None

    def in_cell(self, cell: str) -> bool:
        """True when ``cell`` reports this metric: it is listed, or no
        list names the cells."""
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    """One run's inputs: the cell, its configuration, its traffic mix, its
    limits and the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def params(self) -> dict:
        return self.traffic.get("params", {})


def metric(entry: dict) -> Metric:
    w = entry.get("workloads")
    return Metric(name=entry["name"], unit=entry["unit"], moves=entry.get("moves"),
                  workloads=tuple(w) if w is not None else None)


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def traffic_path(root: str, traffic: str) -> str:
    return os.path.join(root, BENCH_DIR, "traffic", f"{traffic}.json")


def limits_path(root: str, cell: str) -> str:
    return os.path.join(root, BENCH_DIR, "limits", f"{cell}.json")


def metric_path(root: str, name: str) -> str:
    return os.path.join(root, BENCH_DIR, "metrics", f"{name}.py")


def load_cell(root: str, cell: str, bench: dict | None = None) -> Cell:
    """The cell named ``cell``; raises ``KeyError`` for a name that
    ``BENCHMARK.json`` does not hold."""
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json (has {sorted(work)})")
    w = work[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(traffic_path(root, w["traffic"])) as f:
        traffic = json.load(f)
    with open(limits_path(root, cell)) as f:
        limits = json.load(f)
    e2e = {m["name"]: metric(m) for m in bench["end_to_end"]}
    per_layer = [metric(m) for m in bench["per_layer"]]
    return Cell(
        name=cell, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in e2e.values() if m.in_cell(cell)],
        per_layer=[m for m in per_layer if m.in_cell(cell)],
        limits=limits,
    )
