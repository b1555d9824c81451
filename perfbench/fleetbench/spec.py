"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells; everything
that belongs to one configuration, one traffic mix or one metric is a file
of its own, found from the name there:

* a configuration: the ``file`` its entry names (``perfbench/configs/``);
* a traffic mix: ``perfbench/traffic/<traffic>.json``;
* a metric: ``perfbench/metrics/<name>.py``, a module with ``read(run)``
  that returns the metric's value, or ``None`` where it finds nothing to
  read (the metric is then left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list          # entries of BENCHMARK.json that this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def metric_cells(metric: dict, bench: dict) -> list:
    """The cells that report ``metric``: its ``workloads``, or every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return list(metric["workloads"])
    if "moves" not in metric:
        return [w["name"] for w in bench["workloads"]]
    moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return metric_cells(moved, bench)


def find_cell(bench: dict, name: str, trace: bool,
              root: Path = ROOT) -> Cell:
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if name in metric_cells(m, bench)]
    return Cell(name=name, chips=int(wl["chips"]), config=config,
                traffic=traffic, metrics=metrics)


def reader(metric_name: str, here: Path = HERE):
    """The ``read`` function of ``perfbench/metrics/<metric_name>.py``."""
    path = here / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
