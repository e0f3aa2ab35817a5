"""What a run is made of, found by name: the cell in `BENCHMARK.json`, its
configuration file, its traffic mix (`traffic/<name>.json`), its limits
(`checks/<cell>.json`), the driver the mix names (`vpbench/drivers/<name>.py`)
and the reader of each per-layer metric (`metrics/<metric>.py` or `<stem>.py`). Adding a
cell, a configuration, a mix or a metric adds files; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict            # the configuration file's contents
    traffic_name: str
    traffic: dict           # the mix's parameters
    checks: dict            # {number: limit}
    end_to_end: List[dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, all_cells: List[str]) -> bool:
    return cell in metric.get("workloads", all_cells)


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = os.path.join(root, os.path.relpath(BENCH_DIR, ROOT))
    cells = list(wl)
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, cells)]
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name, [c for c in cells
                                       if any(e["name"] == m["moves"] for e in spec["end_to_end"]
                                              if _reports(e, c, cells))])]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_load_json(os.path.join(root, cfg["file"])),
                traffic_name=w["traffic"],
                traffic=_load_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
                checks=_load_json(os.path.join(bench, "checks", name + ".json")),
                end_to_end=e2e, per_layer=per_layer)


def driver(traffic: dict):
    """The module `vpbench.drivers.<traffic["driver"]>`."""
    return importlib.import_module(f"vpbench.drivers.{traffic['driver']}")


def metric_reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """`read(run) -> float | None` from `metrics/<metric>.py`, or where there
    is none from `metrics/<stem>.py`, the stem being the name up to its
    first dot: one reader serves a quantity split by the end-to-end metric
    it moves (`mfu.serve`, `mfu.train`). A name may hold dots, so the file
    is loaded by path."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(bench_dir, "metrics", metric.split(".")[0] + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"vpbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run, bench_dir: str = BENCH_DIR
                 ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "unit"}} of each metric whose reader found something."""
    out: Dict[str, Dict[str, float]] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
