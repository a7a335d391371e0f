"""The regime of the benchmark's ``1M-256-288.stream`` cell at a small size:
a set with no Paterson–Stockmeyer, one bundle and a DB built from items,
whose power wavefront puts 21 products in its one level (three batched
multiply + relinearize groups of ``MUL_CHUNK``), as 1M-256-288 puts 457 in
58 (``benchmark/tests/configs/wide-dot.json``: N=256, t=147457, K=30, nine
query powers, 500 receiver items against senders of 16).

On the CPU: ``harness.cell.run_cell`` is exact against the plain reference
(``benchmark/reference/``) and its control reads nearly every slot wrong;
the counters ``powers.products`` and ``powers.groups`` gain what the plan
gives a query; the readers ``powers_launches.query`` and
``powers_us.product`` read nothing without their counters and the right
value on a planted recorder; ``benchmark/configs/1M-256-288.json`` states
the parameter file and the port's moduli and levels; a query of each of the
benchmark's configurations counts its wavefront's products and groups.  On
a card: the counter ``program.powers.kernels`` gains, at each replay, every
kernel node of the powers program's graph.
"""

import json
import math
import time
from pathlib import Path

import pytest
import torch

from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.measured_levels import powers_at_eval, query_level
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine.evaluator import MUL_CHUNK, wavefront_work
from apsu_tpu_torch.engine.powers import plan_powers, plan_query
from apsu_tpu_torch.utils import stopwatch
from apsu_tpu_torch.utils.stopwatch import GLOBAL, Stopwatch

REPO = Path(__file__).resolve().parents[1]
SEED = 2_900_000_029   # larger than 32 signed bits hold
READERS = ("powers_launches.query", "powers_us.product")


@pytest.fixture(scope="module")
def harness():
    """The benchmark's ``harness`` package, imported as ``benchmark/run.py``
    imports it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO / "benchmark"))
        from harness import cell, spec
        yield cell, spec


def _cell(spec):
    bench = spec.load_json(REPO / "BENCHMARK.json")
    bench["configs"] = [{"name": "wide-dot", "file": "benchmark/tests/configs/wide-dot.json"}]
    bench["workloads"] = [{"name": "wide-dot.stream", "config": "wide-dot",
                           "traffic": "stream", "chips": 1}]
    return spec.load_cell("wide-dot.stream", bench, spec.BENCH_DIR)


def _plan_work(cfg: dict) -> tuple:
    """(products in the widest level, products, groups) of the set's plan."""
    qp, tp = cfg["params"]["query_params"], cfg["params"]["table_params"]
    levels = plan_powers(qp["query_powers"], tp["max_items_per_bin"]).levels
    return (max(len(lvl) for lvl in levels), sum(len(lvl) for lvl in levels),
            sum(math.ceil(len(lvl) / MUL_CHUNK) for lvl in levels))


def test_wide_dot_cell_matches_the_reference_and_counts_its_wavefront(harness):
    cell, spec = harness
    c = _cell(spec)
    cfg = c.config
    params = PSUParams.from_dict(cfg["params"])
    assert cfg["params"]["query_params"]["ps_low_degree"] == 0
    assert params.bundle_idx_count == 1 and cfg["db"]["kind"] == "items"
    widest, products, groups = _plan_work(cfg)
    assert widest >= 17 and groups >= 3

    counts0, queries0 = GLOBAL.counts(), GLOBAL.stats("program.powers")
    line = cell.run_cell(c, SEED, 0.3, True, "cpu", time.perf_counter(), control=True)
    checks = line["checks"]
    assert line["correct"] and checks["wrong_slots"]["value"] == 0
    assert checks["responses_checked"]["value"] >= 5     # 4 warm-ups and the window's last
    assert checks["control_wrong_slots"] > 0.99 * checks["slots_checked"]

    queries = GLOBAL.stats("program.powers").count - (queries0.count if queries0 else 0)
    gained = {k: GLOBAL.counts().get(k, 0) - counts0.get(k, 0)
              for k in ("powers.products", "powers.groups", "program.powers.kernels")}
    assert queries >= 5
    assert gained == {"powers.products": products * params.bundle_idx_count * queries,
                      "powers.groups": groups * queries,
                      "program.powers.kernels": 0}   # no graph on the CPU
    # the traced line: the products' reader reads, the graph's has nothing
    assert line["metrics"]["powers_us.product"]["value"] > 0
    assert "powers_launches.query" not in line["metrics"]


# ---------------------------------------------------------------------------
# the readers and the configuration
# ---------------------------------------------------------------------------

def _planted() -> Stopwatch:
    """Three queries' powers programs, 922 kernels and 457 products each."""
    sw = Stopwatch()
    for q in range(3):
        sw.records.append(("program.powers", 0, 1_000_000, "query", q, None))
        sw.count("program.powers.kernels", 922)
        sw.count("powers.products", 457)
    return sw


def test_the_wavefront_readers_read_the_counters(monkeypatch, harness):
    _, spec = harness
    monkeypatch.setattr(stopwatch, "GLOBAL", _planted())
    trace = {"window": {"powers_s": [0.004, 0.002, 0.003]}}
    got = {name: spec.load_reader(name)(trace) for name in READERS}
    assert got["powers_launches.query"] == 922
    assert got["powers_us.product"] == pytest.approx(1e6 * 0.003 / 457)


@pytest.mark.parametrize("recorder", [Stopwatch, object], ids=["empty", "no_counters"])
def test_the_wavefront_readers_find_nothing(monkeypatch, harness, recorder):
    _, spec = harness
    monkeypatch.setattr(stopwatch, "GLOBAL", recorder())
    trace = {"window": {"powers_s": [0.004]}}
    assert {name: spec.load_reader(name)(trace) for name in READERS} == dict.fromkeys(READERS)
    # counters without a window's timings: the product's reader reads nothing
    monkeypatch.setattr(stopwatch, "GLOBAL", _planted())
    assert spec.load_reader("powers_us.product")({}) is None


def test_the_1m_256_288_configuration_is_the_parameter_file():
    cfg = json.loads((REPO / "benchmark/configs/1M-256-288.json").read_text())
    assert cfg["params"] == json.loads((REPO / "parameters/1M-256-288.json").read_text())
    params = PSUParams.from_dict(cfg["params"])
    sp = params.seal_params
    assert cfg["moduli"] == {"data": list(sp.data_modulus), "special": sp.special_modulus,
                             "plain": sp.plain_modulus}
    db = ReceiverDB(params, device="cpu")
    assert cfg["levels"] == {"query": query_level(params, len(sp.data_modulus)),
                             "eval": db.eval_level(), "result": db.eval_level()}
    assert not powers_at_eval(params)
    assert cfg["reduced"] == [] and cfg["db"] == {"kind": "items", "items": 1 << 20}
    # one bundle of 520 planes (K + 1, padded) at the evaluation level's limbs
    B, _, planes, limbs, n = cfg["cache_shape"]
    assert (B, limbs, n) == (params.bundle_idx_count, db.eval_level(), params.poly_degree)
    assert planes >= params.table_params.max_items_per_bin + 1
    widest, products, groups = _plan_work(cfg)
    assert (widest, products, groups) == (457, 457, 58)


@pytest.mark.parametrize("name, per_query", [
    ("1M-256-288", (457, 58)), ("1M-2048-cmp", (295, 8)),
    ("16M-4096", (264, 9)),    # low [10, 30] and high [3, 9, 14] zipped: [13, 39, 14]
    ("1M-2048-com", (70, 2))])
def test_a_query_of_each_cell_counts_its_wavefront(name, per_query):
    """What the counters ``powers.products`` and ``powers.groups`` gain a
    query in each of the benchmark's configurations."""
    cfg = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())
    params = PSUParams.from_dict(cfg["params"])
    qp = params.query_params
    plan = plan_query(qp.query_powers, params.table_params.max_items_per_bin, qp.ps_low_degree)
    products, groups = wavefront_work(plan)
    assert (products * params.bundle_idx_count, groups) == per_query


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_the_powers_kernel_counter_is_the_graphs_kernel_nodes(harness):
    """Two queries of the small set through the programs on the card: the
    powers program's graph holds ``kernels`` kernel nodes, as
    ``counts.kernel_names`` reads them, and each replay adds that many to
    ``program.powers.kernels``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from harness import inputs

    from apsu_tpu_torch.api.parties import Receiver
    from apsu_tpu_torch.mpc.prg import CsRng
    from apsu_tpu_torch.ops import counts

    _, spec = harness
    c = _cell(spec)
    params, db, pool, inp = inputs.make(c.config, c.traffic, SEED, "cuda", [])
    recv = Receiver(params, db, rng=CsRng(inp.mask_key))
    recv.run_query(pool[0])   # captures both programs and replays them once
    (prog,) = [p for p in db.bfv.programs.values() if p.counter == "program.powers.kernels"]
    nodes = len(counts.kernel_names(prog.graph))
    assert prog.kernels == nodes > 0
    before = GLOBAL.counts().get("program.powers.kernels", 0)
    recv.run_query(pool[1])
    torch.cuda.synchronize()
    assert GLOBAL.counts()["program.powers.kernels"] - before == nodes
