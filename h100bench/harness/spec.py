"""A cell's files, found by the names in ``BENCHMARK.json``.

- ``configs``' entry names the configuration's file;
- ``h100bench/traffic/<traffic>.json`` is the traffic mix, read by the
  driver its ``driver`` key names (``h100bench/drivers/<driver>.py``);
- ``h100bench/limits/<cell>.json`` holds the limits of the comparison
  that decides ``correct``;
- ``h100bench/metrics/<metric>.py`` reads one per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    ws = metric.get("workloads")
    return ws is None or cell in ws


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    # a per-layer metric applies where it lists the cell, or, without a
    # list, in every cell that reports the end-to-end metric it moves
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if _applies(m, name) and m["moves"] in e2e_names]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per)


def driver(traffic: Dict[str, Any]):
    return importlib.import_module(f"h100bench.drivers.{traffic['driver']}")


def metric_reader(name: str):
    """The ``read(window) -> float | None`` of per-layer metric ``name``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
