"""Finds a cell's files by the names in `BENCHMARK.json` and in its
configuration: the cell, its configuration (`configs/<config>.json`), its
traffic mix (`traffic/<traffic>.json`), the limits of its correctness
check (`limits/<workload>.json`), the readers of its per-layer metrics
(`metrics/<metric>.py`), and the modules the configuration names: the
system under test (`systems/<system>.py`), its comparison with the plain
reference (`checks/<system>.py`), its inputs (`inputs/<data>.py`) and a
test function (`functions/<function>.py`)."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def _reports(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


_MODULES = {}


def load_module(folder: str, name: str):
    """`<folder>/<name>.py` under the benchmark's folder, loaded once."""
    key = (folder, name)
    if key not in _MODULES:
        path = BENCH_DIR / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder}/{name}.py in {BENCH_DIR}")
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def metric_reader(metric: str):
    """The `read(trace)` function of `metrics/<metric>.py`."""
    return load_module("metrics", metric).read
