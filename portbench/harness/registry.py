"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells and the
metrics; everything else a cell needs is a file of its own under this
folder, found by the names the cell's file gives: ``cells/<cell>.json``
(config, traffic, entry, judge, limits, sample), ``configs/<config>
.json`` (with its pool's file), ``traffic/<mix>.json``,
``entries/<entry>.py``, ``reference/<judge>.py``, ``metrics/<metric>.py``,
``data/<pool>.npz``.
Adding a cell, a configuration, a mix or a metric adds files and edits
none.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import List

from .pool import load_pool
from .traffic import request_table

__all__ = ["Cell", "load_cell", "metric_names", "reader", "entry"]

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys a traffic file may hold: what traffic.py and the runner read
TRAFFIC_KEYS = frozenset({"name", "why", "table", "rounds_over",
                          "spread_over", "warmup"})


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict          # the cell's own file
    workload: dict      # its entry in BENCHMARK.json
    config: dict
    traffic: dict
    pool: dict
    table: List[dict]


def load_cell(bench: dict, name: str, root: str | None = None) -> Cell:
    root = root or HERE
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = _json(root, "cells", f"{name}.json")
    if (spec["config"], spec["traffic"]) != (work[0]["config"],
                                             work[0]["traffic"]):
        raise ValueError(f"{name}: cells/{name}.json and BENCHMARK.json "
                         "name different configs or traffic")
    config = _json(root, "configs", f"{spec['config']}.json")
    traffic = _json(root, "traffic", f"{spec['traffic']}.json")
    unread = set(traffic) - TRAFFIC_KEYS
    if unread:
        raise ValueError(f"traffic/{spec['traffic']}.json: keys that no "
                         f"code reads: {sorted(unread)}")
    pool = load_pool(root, config["pool"]["file"])
    return Cell(name, spec, work[0], config, traffic, pool,
                request_table(pool, traffic))


def metric_names(bench: dict, cell: str, kind: str) -> List[str]:
    """The metrics of `kind` (end_to_end or per_layer) that `cell`
    reports: those without a workloads list and those whose list holds
    it."""
    return [m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    """metrics/<name>.py's read function."""
    return importlib.import_module(f"portbench.metrics.{name}").read


def entry(name: str):
    """entries/<name>.py's Entry class."""
    return importlib.import_module(f"portbench.entries.{name}").Entry
