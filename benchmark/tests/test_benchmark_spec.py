"""BENCHMARK.json against the contract, and every cell's files found by name."""

import json
import re

import pytest

from harness.spec import BENCH_DIR, REPO, load_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_a_full_check():
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51
    runs = 2 + 14 * 24
    assert runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    (w,) = [w for w in BENCH["workloads"] if w["name"] == cell]
    c = load_cell(cell)
    assert c.config["name"] == w["config"]
    assert c.traffic == json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "queries_per_s"}
    assert c.per_layer and all(callable(c.readers[m["name"]]) for m in c.per_layer)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    path = REPO / conf["file"]
    assert path.resolve().is_relative_to(BENCH_DIR)
    cfg = json.loads(path.read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert key in cfg
    # the parameter set is the published one, key for key
    published = json.loads((REPO / "parameters" / f"{conf['name']}.json").read_text())
    assert cfg["params"] == published
    assert {"security", "result", "mask", "levels"} <= set(cfg["guarantees"])
