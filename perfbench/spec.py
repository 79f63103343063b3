"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout and
the files it names.  A cell ``<name>`` is found by its name alone:

* ``perfbench/workloads/<name>.json``: the cell's set-up (remat, AdamW,
  warm-up and traced steps, the limits of the comparison that decides
  ``correct``);
* the configuration's ``file`` (``perfbench/configs/<config>.json``): the
  sizes, the source and the cut, and the family that builds it;
* ``perfbench/traffic/<traffic>.json``: the batches' parameters.

The metrics a cell reports are the entries of ``end_to_end`` and
``per_layer`` whose ``workloads`` name it, or that have no ``workloads``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, List

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def reports(metric: Dict[str, Any], cell: str) -> bool:
    """True where ``metric`` is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]          # the cell's entry in BENCHMARK.json
    spec: Dict[str, Any]           # perfbench/workloads/<name>.json
    config: Dict[str, Any]         # the configuration's file
    traffic: Dict[str, Any]        # perfbench/traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files;
    raises KeyError for a name the file does not list."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, entry=entry,
        spec=load_json(root / "perfbench" / "workloads" / f"{name}.json"),
        config=load_json(root / conf["file"]),
        traffic=load_json(root / "perfbench" / "traffic"
                          / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])
