"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; the harness finds
``configs/<config>.json`` (through the configuration's ``file`` entry),
``traffic/<traffic>.json``, ``limits/<cell>.json`` and one reader
``metrics/<metric>.py`` for every metric the cell reports.  Adding a
cell, a configuration, a mix or a metric adds files and entries and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    config_name: str
    traffic: dict           # the traffic mix file's contents
    traffic_name: str
    limits: dict            # number compared -> its limit
    end_to_end: List[dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_reader(name: str, base: str = HERE) -> Callable:
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(base, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without the key follows its end-to-end metric
    moves = metric.get("moves")
    return moves is None or moves in reported


def resolve(cell_name: str, root: str = ROOT, base: str = HERE) -> Cell:
    """The cell ``cell_name`` of ``<root>/BENCHMARK.json`` with every
    file it names loaded; raises KeyError for an unknown cell and
    FileNotFoundError for a file that is missing."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(base, "limits", f"{cell_name}.json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, cell_name, reported)]
    cell = Cell(cell_name, int(w["chips"]), config, w["config"], traffic,
                w["traffic"], limits, e2e, per_layer)
    for m in e2e + per_layer:
        cell.readers[m["name"]] = load_reader(m["name"], base)
    return cell
