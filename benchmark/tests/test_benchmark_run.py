"""A run of the harness on the CPU at small parameter sets: the reference
agrees with the port, the control fails, each fault planted under the timed
path makes ``correct`` false, and the line has the contract's keys."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import trace
from harness.cell import run_cell
from harness.spec import BENCH_DIR, REPO, load_cell, load_json

SEED = 2_900_000_017   # larger than 32 signed bits hold
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _small_bench() -> dict:
    """The committed BENCHMARK.json with two small parameter sets' cells in
    place of its configurations and workloads: the metrics are the ones the
    benchmark reports."""
    bench = load_json(REPO / "BENCHMARK.json")
    names = ("100K-1", "256K-2048-com")
    bench["configs"] = [{"name": n, "file": f"benchmark/tests/configs/{n}.json"} for n in names]
    bench["workloads"] = [{"name": f"{n}.stream", "config": n, "traffic": "stream", "chips": 1}
                          for n in names]
    return bench


SMALL = _small_bench()


def run(cell_name, traced=False, seconds=0.3, control=False):
    cell = load_cell(cell_name, SMALL, BENCH_DIR)
    return run_cell(cell, SEED, seconds, traced, "cpu", time.perf_counter(), control=control)


def test_reference_agrees_and_control_fails():
    line = run("100K-1.stream", control=True)
    c = line["checks"]
    assert line["correct"] and c["wrong_slots"]["value"] == 0
    assert c["responses_checked"]["value"] >= 5          # 4 warm-ups and the window's last
    assert c["control_wrong_slots"] > 0.99 * c["slots_checked"]


def test_line_has_the_contract_keys():
    line = run("100K-1.stream")
    assert list(line) == LINE_KEYS
    assert set(line["metrics"]) == {m["name"] for m in SMALL["end_to_end"]
                                    if "workloads" not in m}
    assert {"queries_per_s", "setup_s"} <= set(line["metrics"])
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    json.dumps(line)


def test_traced_run_reads_the_host_side_metrics():
    line = run("100K-1.stream", traced=True)
    assert line["correct"]
    assert {"host_ms.query", "powers_ms.query", "eval_ms.query"} <= set(line["metrics"])
    # no card: nothing device-side is read, and nothing reads 0 in its place
    assert not {"glue_ms.query", "ntt_ms.query", "k2_roofline", "k3_roofline",
                "device_idle.query"} & set(line["metrics"])


def _patch_run_query(monkeypatch, change):
    from apsu_tpu_torch.api.parties import Receiver

    real = Receiver.run_query
    state = {}

    def broken(self, req, timings=None):
        return change(real(self, req, timings=timings), state)

    monkeypatch.setattr(Receiver, "run_query", broken)


def _stale(resp, state):
    """A step that returns its state unchanged: every query answers with the
    first response."""
    state.setdefault("first", resp)
    return state["first"]


def _half_batch(resp, state):
    """Half of the batch left out: the second half of the bundles' results
    never computed (zeros)."""
    res = resp.results.clone()
    res[res.shape[0] // 2:] = 0
    resp.results = res
    return resp


@pytest.mark.parametrize("cell_name, fault", [
    ("100K-1.stream", _stale),
    ("256K-2048-com.stream", _half_batch),
])
def test_broken_responses_are_not_correct(monkeypatch, cell_name, fault):
    _patch_run_query(monkeypatch, fault)
    line = run(cell_name, seconds=0.1)
    assert not line["correct"] and line["checks"]["wrong_slots"]["value"] > 0


def test_one_answer_altered_where_it_is_produced(monkeypatch):
    """The mask of slot (0, 0, 0) raised by one inside the evaluation
    program: one slot of each response is wrong, and the run is not
    correct."""
    from apsu_tpu_torch.engine import programs

    real = programs.matching

    def altered(bfv, powers, cache, const_slots, mask, eval_level):
        mask = mask.clone()
        mask[0, 0, 0] = (mask[0, 0, 0] + 1) % bfv.t
        return real(bfv, powers, cache, const_slots, mask, eval_level)

    monkeypatch.setattr(programs, "matching", altered)
    line = run("100K-1.stream")
    c = line["checks"]
    assert not line["correct"]
    assert c["wrong_slots"]["value"] == c["responses_checked"]["value"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "16M-4096.stream",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 2 and out.stdout == ""


def test_trace_reduction():
    """Busy time is the union of device operations inside the queries'
    window; each idle gap goes to the innermost host span open when it
    began."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench:query", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench:prepare", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "bench:powers", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "ntt_kernel<13>", "ts": 32, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "ps_inner_kernel", "ts": 50, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 5},
        {"ph": "X", "cat": "user_annotation", "name": "bench:response", "ts": 85, "dur": 15},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 200, "dur": 5},
    ]
    r = trace.reduce_trace(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(53e-6)
    assert r["kernels"] == ["ntt_kernel<13>", "ps_inner_kernel"]
    assert r["idle_gaps"] == pytest.approx({"prepare": 32e-6, "between": 10e-6,
                                            "response": 5e-6})


def test_readers_on_a_synthetic_trace():
    from harness.spec import load_reader

    tr = {"cache_shape": [4, 6, 1312, 4, 8192], "ps_low_degree": 44, "max_items_per_bin": 1304,
          "window": {"queries": 2, "seconds": 0.03, "wall_s": [0.015, 0.015],
                     "powers_s": [0.004, 0.004], "eval_s": [0.009, 0.009], "programs_s": 0.024},
          "profile": {"queries": 2, "kernels": ["ps_inner_kernel<false>", "ntt_kernel<13>", "add"],
                      "ops": {"ps_inner_kernel<false>": [0.003, 2], "ntt_kernel<13>": [0.004, 106],
                              "add": [0.002, 50], "Memcpy HtoD": [0.004, 8]}}}
    read = {n: load_reader(n) for n in ("host_ms.query", "glue_ms.query", "ntt_ms.query",
                                        "k2_roofline", "k3_roofline", "device_idle.query")}
    assert read["host_ms.query"](tr) == pytest.approx(2.0)
    assert read["glue_ms.query"](tr) == pytest.approx(1.0)
    assert read["ntt_ms.query"](tr) == pytest.approx(2.0)
    assert read["k2_roofline"](tr) == pytest.approx(100 * 4.2425e9 / 3.35e12 / 0.0015, rel=1e-3)
    assert read["k3_roofline"](tr) is None
    assert read["device_idle.query"](tr) == pytest.approx(20.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["16M-4096.stream", "1M-2048-cmp.stream"])
def test_cells_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell_name,
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["queries_per_s"]["value"])
