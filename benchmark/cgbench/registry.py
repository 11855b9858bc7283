"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``benchmark/traffic/<traffic>.json``.
``benchmark/workloads/<cell>.json`` holds what belongs to the cell alone:
the limits of the comparison. A per-layer metric, reported in the cells
its ``workloads`` list, is read by ``benchmark/metrics/<metric>.py``, whose
``read(ctx)`` returns a number or None; an end-to-end metric is reported
in every cell, or in those its ``workloads`` list. A configuration's
``model`` names its family: ``cgbench/programs/<model>.py`` and
``cgbench/reference/<model>.py``. Adding a cell, a configuration, a family
or a metric adds files and an entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, with its name
    traffic: dict         # the traffic mix's file, with its name
    workload: dict        # the cell's own file
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    w = entries[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(load_json(root / cfg_entry["file"]), name=w["config"])
    traffic = dict(load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    workload = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    missing = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if missing:
        raise ValueError(f"per-layer metrics {missing} list no workloads")
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, int(w["chips"]), config, traffic, workload, e2e, per_layer)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "cgbench_metric_" + re.sub(r"\W", "_", metric), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, ctx, root: Path = ROOT) -> dict:
    """{name: value} of the cell's per-layer metrics that find something
    to read; a reader that returns None leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
