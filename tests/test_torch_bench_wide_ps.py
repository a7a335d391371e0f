"""The benchmark's run of a cell (``benchmark/harness/cell.py:run_cell``) on
the CPU, at a small Paterson–Stockmeyer set whose DB is built from items and
whose data primes are 29, 29 and 28 bits wide, as 1M-2048-com's are: every
checked response of the port is exact against the plain reference
(``benchmark/reference/``), and the control, each response held against the
next query's mask, reads nearly every slot wrong.

The set is ``tests/test_torch_ps_wide.py``'s small one (N=256, K=43,
ps_low_degree 10, so the inner sums span two 8-product chunks), at 1500
receiver items against senders of 64 (``benchmark/tests/configs/wide-ps.json``).
"""

import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SEED = 2_900_000_017   # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def harness():
    """The benchmark's ``harness`` package, imported as ``benchmark/run.py``
    imports it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO / "benchmark"))
        from harness import cell, spec
        yield cell, spec


def test_wide_prime_ps_cell_matches_the_reference(harness):
    cell, spec = harness
    bench = spec.load_json(REPO / "BENCHMARK.json")
    bench["configs"] = [{"name": "wide-ps", "file": "benchmark/tests/configs/wide-ps.json"}]
    bench["workloads"] = [{"name": "wide-ps.stream", "config": "wide-ps", "traffic": "stream",
                           "chips": 1}]
    c = spec.load_cell("wide-ps.stream", bench, spec.BENCH_DIR)
    # 1M-2048-com's widths: two data primes at or above 2^28
    assert [q.bit_length() for q in c.config["moduli"]["data"]] == [29, 29, 28]
    assert c.config["params"]["query_params"]["ps_low_degree"] >= 2
    assert c.config["db"]["kind"] == "items"

    line = cell.run_cell(c, SEED, 0.3, False, "cpu", time.perf_counter(), control=True)
    checks = line["checks"]
    assert line["correct"] and checks["wrong_slots"]["value"] == 0
    assert checks["responses_checked"]["value"] >= 5     # 4 warm-ups and the window's last
    assert checks["control_wrong_slots"] > 0.99 * checks["slots_checked"]
