"""The port's wire session, serve loop and CLIs against the JAX package's,
exactly, on the CPU at small_params() (N=256, tests/test_psu_e2e.py's set):

* ``run_psu_mpc`` with the DDH and the OSN PEQT, and a CARDSUM session, in
  both packages from the same seed: equal results, equal bytes on the wire,
  byte-identical transcripts in each direction; and, when one party
  raises, ``run_psu_mpc`` raising at once instead of hanging;
* a reference QueryClient against the port's serve_db_party over localhost
  sockets, and the reverse; reference ECDH and KKRT clients against the
  port's serve_clients (one resident ECDH-built DB), byte for byte;
* a two-query KKRT session through OP_REBIND, equal to the reference's, and
  the two repairs the port makes in the rebind handler: a DB that cannot
  rebind answers OP_REBIND with OP_ERROR (the client raises, nothing hangs),
  and the consumed cache is released before the new one is built;
* the retained placement holds a read-only copy of the caller's items;
* ``pack_residues`` on the port's int32 residues;
* the two-process CLI, port against port (one connection of two queries,
  and a resident DB serving an ECDH and a KKRT sender) and the reference's
  sender against the port's receiver, with ``--device cpu``.

Sockets bind port 0, or a port probed free just before use.  (The set
helpers are copied here: a GPU host may have another package named ``tests``
on its path.)"""

import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest

import apsu_tpu.api.protocol as r_protocol
import apsu_tpu.api.session as r_session
import apsu_tpu.mpc.duplex as r_duplex
import apsu_tpu.net.wire as r_wire
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.mpc.prg import CsRng as RefCsRng
import apsu_tpu_torch.api.protocol as p_protocol
import apsu_tpu_torch.api.session as p_session
import apsu_tpu_torch.mpc.duplex as p_duplex
import apsu_tpu_torch.net.wire as p_wire
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.mpc.prg import CsRng

ROOT = Path(__file__).resolve().parent.parent
SMALL = {
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
}
JOIN_S = 180
REF = dict(session=r_session, duplex=r_duplex, rng=RefCsRng, params=RefParams.from_dict(SMALL))
PORT = dict(session=p_session, duplex=p_duplex, rng=CsRng, params=PSUParams.from_dict(SMALL))


def make_sets(rng, n_db, n_query, n_common):
    """Random 128-bit item sets with a planted intersection (as
    tests/test_psu_e2e.py makes them)."""
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def as_set(a):
    return {(int(x), int(y)) for x, y in np.ascontiguousarray(a).view(np.uint64).reshape(-1, 2)}


def check_oracle(db, query, result):
    """The set algebra of tests/test_psu_e2e.py:check_oracle."""
    dbs, qs = as_set(db), as_set(query)
    trans, union = as_set(result.transferred), as_set(result.union)
    assert trans == qs - dbs
    assert union == dbs | qs
    assert not (trans & dbs)
    assert len(union) == len(dbs) + len(qs - dbs)


class RecordingQueue(queue.Queue):
    """A duplex direction that keeps every encoded frame put on it."""

    def __init__(self):
        super().__init__()
        self.frames = []

    def put(self, item, *args, **kwargs):
        self.frames.append(bytes(item))
        super().put(item, *args, **kwargs)


def recording_pipe_pair(duplex_module, log):
    """pipe_pair of ``duplex_module`` whose two directions record into
    ``log`` (frames query → DB, frames DB → query)."""
    def pipe_pair():
        ab, ba = RecordingQueue(), RecordingQueue()
        log[:] = [ab.frames, ba.frames]
        return duplex_module.QueueDuplex(ab, ba), duplex_module.QueueDuplex(ba, ab)
    return pipe_pair


def run_threads(*fns, timeout=JOIN_S):
    """Run each fn in a thread; returns their results; re-raises the first
    error; fails if one is still running after ``timeout`` s."""
    out, err = [None] * len(fns), []

    def wrap(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # reported below
            err.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a party hung"
    if err:
        raise err[0]
    return out


def _session(pkg, db_items, queries, oprf="kkrt", peqt="ddh", mode="union", values=None):
    """One QueryClient (one query per entry of ``queries``) against
    serve_db_party over a recording pipe pair of ``pkg``; returns (per-query
    DB results, DB timings, transcript)."""
    log = []
    ch_q, ch_db = recording_pipe_pair(pkg["duplex"], log)()
    timings = {}
    extra = {} if pkg is REF else {"device": "cpu"}

    def db():
        return pkg["session"].serve_db_party(
            ch_db, pkg["params"], db_items, pkg["rng"](b"test_torch_session/db"),
            timings=timings, max_queries=None, **extra)

    def client():
        c = pkg["session"].QueryClient(ch_q, rng=pkg["rng"](b"test_torch_session/q"),
                                       params=pkg["params"], oprf=oprf, **extra)
        for q in queries:
            c.query(q, peqt=peqt, mode=mode, values=values)
        c.close()

    per_query, _ = run_threads(db, client)
    return per_query, timings, log


# ---------------------------------------------------------------------------
# run_psu_mpc and CARDSUM, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peqt", ["ddh", "osn"])
def test_run_psu_mpc_matches_reference(peqt, monkeypatch):
    db, query = make_sets(np.random.default_rng(5), n_db=250, n_query=35, n_common=12)
    r_log, p_log = [], []
    monkeypatch.setattr(r_duplex, "pipe_pair", recording_pipe_pair(r_duplex, r_log))
    monkeypatch.setattr(p_protocol, "pipe_pair", recording_pipe_pair(p_duplex, p_log))
    want = r_protocol.run_psu_mpc(REF["params"], query, db, seed=3, peqt=peqt)
    got = p_protocol.run_psu_mpc(PORT["params"], query, db, seed=3, peqt=peqt, device="cpu")
    check_oracle(db, query, got)
    assert np.array_equal(got.transferred, want.transferred)
    assert np.array_equal(got.union, want.union)
    assert got.timings["bytes_on_wire"] == want.timings["bytes_on_wire"]
    assert set(got.timings) == set(want.timings)
    assert [len(d) for d in p_log] == [len(d) for d in r_log]
    assert p_log == r_log, "transcripts differ"


@pytest.mark.parametrize("failing", ["query", "db"])
def test_run_psu_mpc_raises_when_a_party_fails(failing, monkeypatch):
    """A party that raises closes its end of the pipe: the other stops at its
    next receive, and run_psu_mpc raises the first error instead of hanging."""
    def fail(*args, **kwargs):
        raise RuntimeError(f"the {failing} party failed")

    if failing == "query":
        monkeypatch.setattr(p_session.Sender, "create_query", fail)
    else:
        monkeypatch.setattr(ReceiverDB, "set_data", fail)
    db, query = make_sets(np.random.default_rng(4), n_db=100, n_query=20, n_common=5)
    with pytest.raises(RuntimeError, match=f"the {failing} party failed"):
        run_threads(lambda: p_protocol.run_psu_mpc(PORT["params"], query, db, device="cpu"),
                    timeout=60)


def test_cardsum_session_matches_reference():
    db, query = make_sets(np.random.default_rng(8), n_db=200, n_query=30, n_common=10)
    values = np.arange(1, 31, dtype=np.uint64) * 100
    dbs = as_set(db)
    expect = (len(as_set(query) - dbs),
              sum(int(v) for v, it in zip(values, map(tuple, query.tolist())) if it not in dbs))
    want = _session(REF, db, [query], mode="cardsum", values=values)
    got = _session(PORT, db, [query], mode="cardsum", values=values)
    assert got[0] == want[0] == [expect]
    assert got[2] == want[2], "transcripts differ"


# ---------------------------------------------------------------------------
# the serve loop: OP_REBIND
# ---------------------------------------------------------------------------

def _two_queries(seed):
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 1 << 64, size=(250, 2), dtype=np.uint64)
    queries = [np.concatenate([rng.integers(0, 1 << 64, size=(20, 2), dtype=np.uint64),
                               db[rng.choice(250, size=10, replace=False)]])
               for _ in range(2)]
    return db, queries


def test_two_query_kkrt_session_matches_reference():
    """One KKRT session, two queries: the second opens a fresh correlation
    (OP_REBIND) and the DB party rebinds its retained placement."""
    db, queries = _two_queries(29)
    want = _session(REF, db, queries)
    got = _session(PORT, db, queries)
    assert "rebind" in got[1] and set(got[1]) == set(want[1])
    assert len(got[0]) == 2
    for q, g, w in zip(queries, got[0], want[0]):
        assert np.array_equal(g, w)
        assert as_set(g) == as_set(q) - as_set(db)
    assert got[2] == want[2], "transcripts differ"


def test_rebind_releases_the_consumed_cache_first(monkeypatch):
    """Every cache build of a three-query KKRT session finds no earlier
    session cache alive: the consumed one is released before the rebind
    builds its successor, so the device holds one cache at a time."""
    built, alive_at_build = [], []
    build = ReceiverDB._build_cache

    def spy(self, roots, counts, *level):
        alive_at_build.append(sum(ref() is not None for ref in built))
        build(self, roots, counts, *level)
        built.append(weakref.ref(self.coeff_cache))

    monkeypatch.setattr(ReceiverDB, "_build_cache", spy)
    db, queries = _two_queries(31)
    per_query, timings, _ = _session(PORT, db, queries + [queries[0]])
    assert len(per_query) == 3 and "rebind" in timings
    assert alive_at_build == [0, 0, 0]


def test_rebind_on_a_db_that_cannot_rebind_sends_op_error(monkeypatch):
    """A DB without a placement (as ``from_arrays`` makes one) answers
    OP_REBIND with OP_ERROR: the client's next query raises RemoteError at
    once instead of waiting on a closed channel."""
    params = PORT["params"]
    db, queries = _two_queries(33)
    arrays = ReceiverDB(params, DebugOprf(), device="cpu")
    arrays.set_data(db)
    from_arrays = ReceiverDB.from_arrays(
        params, {"coeff_cache": arrays.coeff_cache.numpy(), "const_slots":
                 arrays.const_slots.numpy(), "eval_lvl": arrays.eval_lvl,
                 "result_lvl": arrays.result_lvl}, device="cpu")
    assert arrays.can_rebind and not from_arrays.can_rebind

    set_data = ReceiverDB.set_data

    def set_data_keeping_no_placement(self, items):
        stats = set_data(self, items)
        self._placement = None      # what a from_arrays DB holds
        return stats

    monkeypatch.setattr(ReceiverDB, "set_data", set_data_keeping_no_placement)
    ch_q, ch_db = p_duplex.pipe_pair()
    seen = {}

    def server():
        try:
            p_session.serve_db_party(ch_db, params, db, CsRng(b"test_torch_session/cannot-rebind/db"),
                                     max_queries=None, device="cpu")
        except p_wire.ProtocolError as e:
            seen["server"] = str(e)

    def client():
        c = p_session.QueryClient(ch_q, rng=CsRng(b"test_torch_session/cannot-rebind/q"), params=params,
                                  device="cpu")
        c.query(queries[0])
        with pytest.raises(p_wire.RemoteError, match="cannot rebind"):
            c.query(queries[1])
        seen["client"] = True

    run_threads(server, client, timeout=60)
    assert seen["client"] and "cannot rebind" in seen["server"]


def test_retained_items_are_a_read_only_copy():
    """Changing the caller's array after set_data cannot reach the retained
    placement: a rebind under the same OPRF rebuilds the same cache."""
    params = PORT["params"]
    db_items, _ = make_sets(np.random.default_rng(12), n_db=200, n_query=10, n_common=0)
    db = ReceiverDB(params, DebugOprf(), device="cpu")
    db.set_data(db_items)
    kept = db._placement.items
    assert kept is not db_items and not kept.flags.writeable
    with pytest.raises(ValueError):
        kept[0, 0] = 1
    db_items[:] = 0
    again = db.rebind(DebugOprf())
    assert np.array_equal(again.coeff_cache.numpy(), db.coeff_cache.numpy())
    assert np.array_equal(again.const_slots.numpy(), db.const_slots.numpy())
    assert again.can_rebind and again.stats == db.stats


def test_pack_residues_matches_reference():
    primes = [1073479681, 1072496641, 65537, 12289]
    rng = np.random.default_rng(2)
    shape = (2, 3, len(primes), 64)
    res = np.stack([rng.integers(0, p, size=shape[:2] + (64,)) for p in primes], axis=-2)
    packed = p_wire.pack_residues(res.astype(np.int32), primes)
    assert np.array_equal(packed, r_wire.pack_residues(res.astype(np.uint32), primes))
    assert packed.nbytes == p_wire.packed_nbytes(primes, shape)
    assert np.array_equal(p_wire.unpack_residues(packed, primes, shape), res.astype(np.uint32))


# ---------------------------------------------------------------------------
# cross-package sessions over localhost sockets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg,server_pkg,peqt", [("ref", "port", "osn"),
                                                        ("port", "ref", "ddh")])
def test_cross_package_socket_session(client_pkg, server_pkg, peqt):
    pkgs = {"ref": REF, "port": PORT}
    cpkg, spkg = pkgs[client_pkg], pkgs[server_pkg]
    db, query = make_sets(np.random.default_rng(6), n_db=220, n_query=30, n_common=9)
    want, _, _ = _session(REF, db, [query], peqt=peqt)
    lst = spkg["duplex"].SocketListener(0, "127.0.0.1")
    extra = lambda pkg: {} if pkg is REF else {"device": "cpu"}  # noqa: E731

    def server():
        ch = lst.accept()
        try:
            return spkg["session"].serve_db_party(
                ch, spkg["params"], db, spkg["rng"](b"test_torch_session/db"),
                max_queries=None, **extra(spkg))
        finally:
            ch.sock.close()

    def client():
        ch = cpkg["duplex"].SocketDuplex.connect("127.0.0.1", lst.port)
        try:
            c = cpkg["session"].QueryClient(ch, rng=cpkg["rng"](b"test_torch_session/q"),
                                            params=cpkg["params"], **extra(cpkg))
            c.query(query, peqt=peqt)
            c.close()
            return ch.bytes_sent, ch.bytes_received
        finally:
            ch.sock.close()

    try:
        got, _ = run_threads(server, client)
    finally:
        lst.close()
    assert len(got) == 1 and np.array_equal(got[0], want[0])
    assert as_set(got[0]) == as_set(query) - as_set(db)


class TapSocket:
    """A socket that keeps every byte it sends and receives."""

    def __init__(self, sock):
        self.sock, self.sent, self.received = sock, bytearray(), bytearray()

    def setsockopt(self, *args):
        self.sock.setsockopt(*args)

    def sendall(self, data):
        self.sent += data
        self.sock.sendall(data)

    def recv(self, n):
        chunk = self.sock.recv(n)
        self.received += chunk
        return chunk

    def close(self):
        self.sock.close()


def _serve_clients(pkg, db, sessions):
    """``pkg``'s serve_clients on a localhost listener against one reference
    QueryClient per (oprf, queries) entry of ``sessions``, one after the
    other; returns (per-client results, per-client (sent, received) bytes)."""
    lst = pkg["duplex"].SocketListener(0, "127.0.0.1")
    extra = {} if pkg is REF else {"device": "cpu"}

    def server():
        return pkg["session"].serve_clients(
            lst, pkg["params"], db, pkg["rng"](b"test_torch_session/clients"),
            max_clients=len(sessions), **extra)

    def clients():
        tapes = []
        for k, (oprf, queries) in enumerate(sessions):
            tap = TapSocket(socket.create_connection(("127.0.0.1", lst.port)))
            c = r_session.QueryClient(r_duplex.SocketDuplex(tap),
                                      rng=RefCsRng(b"test_torch_session/client%d" % k),
                                      params=REF["params"], oprf=oprf)
            for q in queries:
                c.query(q, peqt="osn")
            c.close()
            tap.close()
            tapes.append((bytes(tap.sent), bytes(tap.received)))
        return tapes

    try:
        return run_threads(server, clients)
    finally:
        lst.close()


def test_serve_clients_ecdh_and_kkrt_match_reference():
    """serve_clients builds one resident DB with the ECDH OPRF and serves
    reference clients in turn: an ECDH client with two queries on the
    resident cache (an OP_OPRF round each), then a KKRT client, whose session
    DB is rebound from the resident placement.  Every union is exact and the
    port server's byte streams equal the reference server's."""
    db, queries = _two_queries(37)
    sessions = [("ecdh", queries), ("kkrt", queries[:1])]
    want, want_tapes = _serve_clients(REF, db, sessions)
    got, got_tapes = _serve_clients(PORT, db, sessions)
    assert [len(c) for c in got] == [len(c) for c in want] == [2, 1]
    for g_client, w_client, (_, qs) in zip(got, want, sessions):
        for g, w, q in zip(g_client, w_client, qs):
            assert np.array_equal(g, w)
            assert as_set(g) == as_set(q) - as_set(db)
    assert got_tapes == want_tapes, "transcripts differ"


# ---------------------------------------------------------------------------
# the two-process CLI
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_csv(path, strings):
    path.write_text("".join(s + "\n" for s in strings))


def _cli_files(tmp_path, n_queries):
    rng = np.random.default_rng(0)
    db = [f"db-item-{i}" for i in range(300)]
    queries = [[f"q{k}-{i}" for i in range(20)] + list(rng.choice(db, size=9, replace=False))
               for k in range(n_queries)]
    (tmp_path / "params.json").write_text(json.dumps(SMALL))
    _write_csv(tmp_path / "db.csv", db)
    for k, q in enumerate(queries):
        _write_csv(tmp_path / f"query{k}.csv", q)
    return db, queries


def _query_files(tmp_path, ks):
    return ["--query-file"] + [str(tmp_path / f"query{k}.csv") for k in ks]


def _run_cli(tmp_path, receiver, senders, serve):
    """Start the receiver with the flags ``serve``, wait until it listens
    (it logs so once its socket is bound), run each sender (module and
    flags) in turn, and return the receiver's stderr; each process has 240 s."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    port = str(_free_port())
    recv = subprocess.Popen(
        [sys.executable, "-m", receiver, "--params", str(tmp_path / "params.json"),
         "--db-file", str(tmp_path / "db.csv"), "--port", port, "--bind", "127.0.0.1",
         "--out", str(tmp_path / "union.csv"), "--seed", "1", *serve, "--device", "cpu"],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(recv.stderr), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 120
        while not any("listening on" in ln for ln in lines):
            assert recv.poll() is None and time.monotonic() < deadline, "".join(lines)[-2000:]
            time.sleep(0.1)
        for sender in senders:
            send = subprocess.run(
                [sys.executable, "-m", *sender, "--host", "127.0.0.1", "--port", port,
                 "--seed", "2"], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=240)
            assert send.returncode == 0, send.stderr[-3000:]
        assert recv.wait(timeout=240) == 0, "".join(lines)[-3000:]
    finally:
        if recv.poll() is None:
            recv.kill()
            recv.wait()
    reader.join(10)
    return "".join(lines)


PORT_SENDER = ["apsu_tpu_torch.cli.sender_cli", "--device", "cpu"]


def test_cli_two_process_two_queries(tmp_path):
    """Port receiver and port sender over TCP on the CPU: one connection, two
    KKRT queries (the second through OP_REBIND), the OSN PEQT."""
    db, queries = _cli_files(tmp_path, 2)
    recv_log = _run_cli(tmp_path, "apsu_tpu_torch.cli.receiver_cli",
                        [PORT_SENDER + _query_files(tmp_path, [0, 1])], ["--serve", "2"])
    union = set((tmp_path / "union.csv").read_text().split())
    assert union == set(db) | set(queries[0]) | set(queries[1])
    assert "(2 queries, received 40 new)" in recv_log and "'rebind'" in recv_log


def test_cli_resident_db_serves_ecdh_and_kkrt_clients(tmp_path):
    """``receiver_cli --clients 2`` keeps one ECDH-built DB resident: an
    ECDH sender (``sender_cli --oprf ecdh``) makes two queries on it, then a
    KKRT sender gets a session DB rebound from the resident placement."""
    db, queries = _cli_files(tmp_path, 3)
    recv_log = _run_cli(tmp_path, "apsu_tpu_torch.cli.receiver_cli",
                        [PORT_SENDER + ["--oprf", "ecdh"] + _query_files(tmp_path, [0, 1]),
                         PORT_SENDER + _query_files(tmp_path, [2])],
                        ["--clients", "2", "--serve", "0"])
    union = set((tmp_path / "union.csv").read_text().split())
    assert union == set(db).union(*queries)
    assert "(3 queries, received 60 new)" in recv_log


def test_reference_sender_cli_against_port_receiver_cli(tmp_path):
    db, queries = _cli_files(tmp_path, 1)
    _run_cli(tmp_path, "apsu_tpu_torch.cli.receiver_cli",
             [["apsu_tpu.cli.sender_cli", "--platform", "cpu"] + _query_files(tmp_path, [0])],
             ["--serve", "1"])
    union = set((tmp_path / "union.csv").read_text().split())
    assert union == set(db) | set(queries[0])


def test_cli_flags_of_later_slices_and_devices_fail(tmp_path, capsys):
    from apsu_tpu_torch.cli import receiver_cli, sender_cli

    (tmp_path / "params.json").write_text(json.dumps(SMALL))
    base = ["--params", str(tmp_path / "params.json"), "--db-file", "db.csv"]
    for extra, msg in ((["--workers", "127.0.0.1:1", "--clients", "2"], "incompatible"),
                       (["--cache-parts", "2"], "needs --workers")):
        with pytest.raises(SystemExit):
            receiver_cli.main(base + extra)
        assert msg in capsys.readouterr().err
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            receiver_cli.main(base + ["--device", "cuda"])
        with pytest.raises(RuntimeError, match="cuda"):
            sender_cli.main(["--query-file", "q.csv", "--device", "cuda"])
    with pytest.raises(ValueError, match="workers"):
        p_session.serve_db_party(None, PORT["params"], None, cache_parts=2)
