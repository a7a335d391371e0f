"""The port's spans and counters (``apsu_tpu_torch/utils/stopwatch.py``) on
the CPU: the recorder itself (nesting, parents, query ids, the ring's
bound, counters, the report the CLIs print); one ``Receiver.run_query`` at
a small PS set with its exact span tree and byte counters; the same query's
``apsu:`` ranges in a profiler's chrome trace, and no range entered without
a profiler; the benchmark's five readers of the spans on a planted
recorder; and a DB build's spans, counters and two readers.  No test here
asserts a duration."""

import contextlib
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from apsu_tpu_torch.api.parties import Receiver, Sender
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db import receiver_db
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine import programs
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.utils import stopwatch
from apsu_tpu_torch.utils.stopwatch import GLOBAL, RECORD, RING, Stopwatch

REPO = Path(__file__).resolve().parents[1]
PS = {  # tests/test_torch_programs.py's small PS set
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 16},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 3, "query_powers": [1, 2, 3, 4, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [48, 48, 48, 28]},
}
# a warm query's spans on the CPU, in the order they close: (name, parent)
QUERY_TREE = [
    ("prepare.validate", "query"),
    ("prepare.upload", "query"),
    ("prepare.mask", "query"),
    ("program.copy_in", "program.powers"),
    ("program.powers", "query"),
    ("program.copy_in", "program.eval"),
    ("program.clone", "program.eval"),
    ("program.eval", "query"),
    ("query", None),
    ("to_host", None),
]
# the same spans in the order they open
QUERY_OPENS = ["query", "prepare.validate", "prepare.upload", "prepare.mask", "program.powers",
               "program.copy_in", "program.eval", "program.copy_in", "program.clone", "to_host"]
READERS = ("mask_ms.query", "upload_ms.query", "download_ms.query",
           "program_host_ms.query", "program_captures")


def _field(record, name):
    return record[RECORD.index(name)]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_with_parents_and_query_ids():
    sw = Stopwatch()
    with sw.span("setup"):
        pass
    sw.query = 7
    with sw.span("outer"):
        with sw.span("inner", nbytes=12):
            pass
        with sw.span("inner"):
            pass
    sw.query = 8
    with sw.span("after"):
        pass
    got = [(_field(r, "name"), _field(r, "parent"), _field(r, "query"), _field(r, "nbytes"))
           for r in sw.records]
    assert got == [("setup", None, None, None), ("inner", "outer", 7, 12),
                   ("inner", "outer", 7, None), ("outer", None, 7, None),
                   ("after", None, 8, None)]
    (outer,) = [r for r in sw.records if _field(r, "name") == "outer"]
    for r in sw.records:
        assert _field(r, "start_ns") <= _field(r, "end_ns")
        if _field(r, "parent") == "outer":
            assert _field(outer, "start_ns") <= _field(r, "start_ns")
            assert _field(r, "end_ns") <= _field(outer, "end_ns")
    assert sw.stats("inner").count == 2 and sw.stats("outer").count == 1
    assert sw.stats("never") is None
    with sw.span("main"):   # another thread's spans open in none of this one's
        t = threading.Thread(target=lambda: sw.span("other").__enter__().__exit__())
        t.start()
        t.join(timeout=60)
    assert [(_field(r, "name"), _field(r, "parent")) for r in sw.records][-2:] == [
        ("other", None), ("main", None)]


def test_a_span_closes_on_an_exception():
    sw = Stopwatch()
    with pytest.raises(ValueError):
        with sw.span("outer"):
            with sw.span("inner"):
                raise ValueError
    with sw.span("next"):
        pass
    assert [(_field(r, "name"), _field(r, "parent")) for r in sw.records] == [
        ("inner", "outer"), ("outer", None), ("next", None)]


def test_the_ring_is_bounded_and_the_aggregate_is_not(monkeypatch):
    assert (RING, stopwatch.TRIM) == (1 << 17, 1 << 12)
    monkeypatch.setattr(stopwatch, "RING", 4)
    monkeypatch.setattr(stopwatch, "TRIM", 2)
    sw = Stopwatch()
    for q in range(10):
        sw.query = q
        with sw.span("s", nbytes=q):
            assert len(sw.records) <= 6
    assert [_field(r, "query") for r in sw.records] == [6, 7, 8, 9]
    s = sw.stats("s")
    assert s.count == 10 and s.vmin <= s.total / 10 <= s.vmax
    assert sw.counts() == {"s.bytes": sum(range(10))}
    assert sw.report().count("\n") == 2


def test_threads_keep_their_own_parents_and_lose_no_span(monkeypatch):
    """Sixteen threads closing spans into one small ring at a short switch
    interval: each span's parent is its own thread's, and the aggregate and
    the counters count every span once."""
    monkeypatch.setattr(stopwatch, "RING", 64)
    monkeypatch.setattr(stopwatch, "TRIM", 16)
    sw, threads_n, spans_n = Stopwatch(), 16, 500
    wrong = []

    def work(i):
        for _ in range(spans_n):
            with sw.span(f"outer{i}"):
                with sw.span("inner", nbytes=1):
                    sw.count("n", 1)
        wrong.extend(r for r in list(sw.records)
                     if _field(r, "name") == "inner" and not _field(r, "parent").startswith("outer"))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
    assert sw.stats("inner").count == threads_n * spans_n
    assert sw.counts() == {"n": threads_n * spans_n, "inner.bytes": threads_n * spans_n}
    assert len(sw.records) <= 64 + 16 + threads_n


def test_counters_and_the_report():
    sw = Stopwatch()
    sw.count("words", 5)
    sw.count("words", 6)
    with sw.span("copy", nbytes=100):
        pass
    with sw.span("copy", nbytes=28):
        pass
    assert sw.counts() == {"words": 11, "copy.bytes": 128}
    lines = sw.report().splitlines()
    assert lines[0] == "--- timing report ---"
    (copy,) = [ln for ln in lines if ln.split()[0] == "copy"]
    assert "n=   2" in copy and "total=" in copy and "avg=" in copy and "min=" in copy
    assert [ln.split() for ln in lines if ln.split()[0] in ("words", "copy.bytes")] == [
        ["copy.bytes", "128"], ["words", "11"]]
    assert not hasattr(sw, "event")


# ---------------------------------------------------------------------------
# one query on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ps_query():
    pp = PSUParams.from_dict(PS)
    rng = np.random.default_rng(1)
    items = rng.integers(0, 1 << 64, size=(400, 2), dtype=np.uint64)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items)
    snd = Sender(pp, DebugOprf(), rng=np.random.default_rng(21), device="cpu")
    req = snd.create_query(items[:30])
    recv = Receiver(pp, db, rng=np.random.default_rng(22))
    to_u32(recv.run_query(req).results)   # builds the two programs
    return recv, req


def _query(recv, req):
    """One query as the serving loop runs it; its response."""
    resp = recv.run_query(req)
    to_u32(resp.results)
    return resp


def _new_records(run):
    """The records ``run()`` adds to ``GLOBAL``'s ring."""
    n = len(GLOBAL.records)
    run()
    new = list(GLOBAL.records)[n:]
    assert len(GLOBAL.records) == n + len(new)   # nothing trimmed
    return new


def test_a_query_has_its_span_tree(ps_query):
    recv, req = ps_query
    first = _new_records(lambda: _query(recv, req))
    qid = GLOBAL.query
    assert [(_field(r, "name"), _field(r, "parent")) for r in first] == QUERY_TREE
    assert {_field(r, "query") for r in first} == {qid}
    second = _new_records(lambda: _query(recv, req))
    assert GLOBAL.query == qid + 1
    assert [_field(r, "query") for r in second] == [qid + 1] * len(QUERY_TREE)
    (query,) = [r for r in first if _field(r, "name") == "query"]
    for r in first:
        if _field(r, "parent") is not None:
            assert _field(query, "start_ns") <= _field(r, "start_ns")
            assert _field(r, "end_ns") <= _field(query, "end_ns")


def test_the_byte_counters_count_the_tensors(ps_query, monkeypatch):
    recv, req = ps_query
    copied = []
    call = programs.Program.__call__

    def spy(self, bfv, inputs):
        copied.append(sum(x.nbytes for x in inputs))
        return call(self, bfv, inputs)

    monkeypatch.setattr(programs.Program, "__call__", spy)
    before = GLOBAL.counts()
    out = []
    records = _new_records(lambda: out.append(_query(recv, req)))
    (resp,) = out
    # the counters the query moved (the DB build's stay as the fixture left them)
    gained = {k: v - before.get(k, 0) for k, v in GLOBAL.counts().items()
              if v != before.get(k, 0)}
    request = req.powers_data.nbytes + req.relin_key.nbytes
    assert gained == {
        "prepare.upload.bytes": request,
        "prepare.mask.words": recv.last_mask.size,
        "program.copy_in.bytes": sum(copied),
        "to_host.bytes": resp.results.nbytes,
        # the wavefront: y^3 = y·y^2 and y^4 = y^2·y^2 in one bundle, one group
        "powers.products": 2,
        "powers.groups": 1,
    }
    assert len(copied) == 2 and copied[0] == request
    nbytes = {(_field(r, "name"), _field(r, "parent")): _field(r, "nbytes") for r in records}
    assert nbytes[("prepare.upload", "query")] == request
    assert nbytes[("program.copy_in", "program.eval")] == copied[1]
    assert nbytes[("to_host", None)] == resp.results.nbytes
    assert nbytes[("prepare.mask", "query")] is None


def test_the_spans_land_on_the_profilers_timeline(ps_query, tmp_path):
    recv, req = ps_query
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _query(recv, req)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("apsu:")]
    (query,) = [e for e in ranges if e["name"] == "apsu:query"]
    inside = {e["name"] for e in ranges
              if query["ts"] <= e["ts"] and e["ts"] + e["dur"] <= query["ts"] + query["dur"]}
    assert inside == {"apsu:" + name for name, parent in QUERY_TREE if parent is not None} | {
        "apsu:query"}
    (mask,) = [e for e in ranges if e["name"] == "apsu:prepare.mask"]
    assert query["ts"] < mask["ts"]
    assert [e["name"] for e in ranges if e["name"] not in inside] == ["apsu:to_host"]


def test_no_range_without_a_profiler(ps_query, monkeypatch):
    recv, req = ps_query
    entered = []

    def spy(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(stopwatch, "record_function", spy)
    _query(recv, req)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):   # the spy sees a profiled query
        _query(recv, req)
    assert entered == ["apsu:" + name for name in QUERY_OPENS]


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def load_reader():
    """``benchmark/harness/spec.py:load_reader``, its module loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "bench_harness_spec", REPO / "benchmark" / "harness" / "spec.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # its dataclasses look their module up
    try:
        spec.loader.exec_module(mod)
        yield mod.load_reader
    finally:
        del sys.modules[spec.name]


def _planted() -> Stopwatch:
    """Queries 0-3 and a set-up span: query 0 captures its programs."""
    sw = Stopwatch()
    ms = 1_000_000

    def plant(name, query, dur_ms, parent="query"):
        sw.records.append((name, 0, int(dur_ms * ms), parent, query, None))

    plant("prepare.mask", None, 100.0, None)   # set-up: no query id
    plant("to_host", None, 100.0, None)
    for q, (mask, upload, down, powers, ev) in enumerate(
            [(9.0, 9.0, 9.0, 50.0, 60.0), (1.0, 2.0, 0.5, 1.0, 2.0),
             (3.0, 6.0, 1.5, 2.0, 3.0), (2.0, 4.0, 2.5, 1.5, 2.5)]):
        plant("prepare.mask", q, mask)
        plant("prepare.upload", q, upload)
        plant("to_host", q, down, None)
        plant("program.powers", q, powers)
        plant("program.eval", q, ev)
    sw.query = 0
    for _ in range(2):
        with sw.span("program.capture"):
            pass
    return sw


def test_the_readers_read_the_spans(monkeypatch, load_reader):
    monkeypatch.setattr(stopwatch, "GLOBAL", _planted())
    got = {name: load_reader(name)({}) for name in READERS}
    assert got == {"mask_ms.query": 2.5, "upload_ms.query": 5.0, "download_ms.query": 2.0,
                   "program_host_ms.query": 4.0, "program_captures": 2}


@pytest.mark.parametrize("recorder", [Stopwatch, object], ids=["empty", "no_ring"])
def test_the_readers_find_nothing(monkeypatch, load_reader, recorder):
    monkeypatch.setattr(stopwatch, "GLOBAL", recorder())
    assert {name: load_reader(name)({}) for name in READERS} == dict.fromkeys(READERS)


# ---------------------------------------------------------------------------
# the DB build
# ---------------------------------------------------------------------------

# the spans inside ``db.build`` that each build records
BUILD_SPANS = {"set_data": {"db.place", "db.oprf", "db.interpolate", "db.encode"},
               "set_synthetic_dense": {"db.interpolate", "db.encode"}}
DB_READERS = ("db_build_s", "db_interpolate_s")
DB_TENSORS = ("coeff_cache", "const_slots", "ps_const_polys")


def _build(kind: str):
    """A small PS DB built by ``kind``; the items (or roots) it was given."""
    db = ReceiverDB(PSUParams.from_dict(PS), DebugOprf(), device="cpu")
    if kind == "set_data":
        items = np.random.default_rng(1).integers(0, 1 << 64, size=(400, 2), dtype=np.uint64)
        db.set_data(items)
        return db, len(items)
    return db, db.set_synthetic_dense(np.random.default_rng(2), n_caches=2).size


class _Silent:
    """A recorder that records nothing."""

    def span(self, name, nbytes=None):
        return contextlib.nullcontext()

    def count(self, name, n):
        pass


@pytest.mark.parametrize("kind", sorted(BUILD_SPANS))
def test_a_build_has_its_span_tree_and_counters(monkeypatch, kind):
    sw = Stopwatch()
    monkeypatch.setattr(receiver_db, "GLOBAL", sw)
    db, given = _build(kind)
    records = list(sw.records)
    (build,) = [r for r in records if _field(r, "name") == "db.build"]
    assert _field(build, "parent") is None and records[-1] == build
    inside = records[:-1]
    assert {_field(r, "name") for r in inside} == BUILD_SPANS[kind]
    for r in inside:
        assert _field(r, "parent") == "db.build"
        assert _field(build, "start_ns") <= _field(r, "start_ns")
        assert _field(r, "end_ns") <= _field(build, "end_ns")
    assert sw.counts() == {"db.build.items": given,
                           "db.build.bytes": sum(getattr(db, n).nbytes for n in DB_TENSORS)}


@pytest.mark.parametrize("kind", sorted(BUILD_SPANS))
def test_the_spans_change_no_bit_of_the_db(monkeypatch, kind):
    recorded, _ = _build(kind)
    monkeypatch.setattr(receiver_db, "GLOBAL", _Silent())
    silent, _ = _build(kind)
    for name in DB_TENSORS:
        assert torch.equal(getattr(recorded, name), getattr(silent, name)), name
    assert (recorded.eval_lvl, recorded.result_lvl) == (silent.eval_lvl, silent.result_lvl)


def test_the_db_readers_read_the_build(monkeypatch, load_reader):
    sw = Stopwatch()
    monkeypatch.setattr(receiver_db, "GLOBAL", sw)
    monkeypatch.setattr(stopwatch, "GLOBAL", sw)
    _build("set_data")
    got = {name: load_reader(name)({}) for name in DB_READERS}
    assert got == {"db_build_s": sw.stats("db.build").total,
                   "db_interpolate_s": sw.stats("db.interpolate").total}
    assert 0 < got["db_interpolate_s"] < got["db_build_s"]


@pytest.mark.parametrize("recorder", [Stopwatch, object, _planted], ids=["empty", "no_ring",
                                                                          "queries_only"])
def test_the_db_readers_find_nothing(monkeypatch, load_reader, recorder):
    monkeypatch.setattr(stopwatch, "GLOBAL", recorder())
    assert {name: load_reader(name)({}) for name in DB_READERS} == dict.fromkeys(DB_READERS)
