"""Finding a cell's parts by name: ``BENCHMARK.json`` at the repository's
root names each cell's configuration and traffic; their files, the cell's
limits and the metric readers sit under this folder:

    configs/<configuration>.json   (the file BENCHMARK.json names)
    traffic/<traffic>.json
    limits/<cell>.json
    metrics/<metric>.py            (def read(run) -> float or None)

A new cell, configuration, traffic mix or metric is new files and new
entries; no file here needs an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _read(ROOT / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(ROOT / configs[w["config"]]["file"])
    traffic = _read(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _read(HERE / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``, loaded by path."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"cascade_bench_metrics_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_values(metrics: List[dict], run) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
