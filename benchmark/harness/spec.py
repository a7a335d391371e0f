"""A cell's files, found by the names that ``BENCHMARK.json`` gives.

* the configuration's ``file`` (``configs/<config>.json``): the deployment
  (parameter set, DB kind and
  sizes, moduli and levels the program must use, guarantees);
* ``traffic/<traffic>.json``: the traffic mix, read by ``traffic.py``;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(trace)``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list            # the metric entries this cell reports with --trace 0
    per_layer: list             # and with --trace 1
    readers: dict = field(default_factory=dict)   # per-layer name -> read(trace)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, metrics_dir: Path = BENCH_DIR / "metrics"):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` (by default the checkout's
    ``BENCHMARK.json``); configuration files are relative to the checkout."""
    if bench is None:
        bench = load_json(REPO / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in the benchmark")
    w = found[0]
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(REPO / conf["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=layer,
        readers={m["name"]: load_reader(m["name"], bench_dir / "metrics") for m in layer})
