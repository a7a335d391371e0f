"""The port's multi-host DB party against the JAX package's, on the CPU
(twins of tests/test_multihost.py and of
tests/test_cli_two_process.py:test_cli_multihost_workers):

* ``partition_bundles``;
* two workers, and the 2 × 2 (bundle × cache) grid, over in-process pipes:
  the coordinator's ranges, the workers' C, the results and the masks bit
  for bit against the JAX ``DistributedReceiver`` and its workers under the
  same seeds, and the set algebra of ``run_psu`` through the grid;
* a JAX coordinator driving port workers over TCP sockets: the frames the
  coordinator sends, byte for byte, and the answers equal the port
  coordinator's;
* the full MPC stack (KKRT OPRF, OSN PEQT, chosen OT) through the typed
  wire session with a DB partitioned over two workers on TCP sockets, two
  queries through OP_REBIND;
* a worker's rebind releases its consumed cache before it builds the new
  one (the reference builds first);
* four processes — two ``worker_cli`` on ``--port 0``, whose bound ports the
  coordinator reads from their logs, ``receiver_cli --workers`` and
  ``sender_cli`` — with ``--device cpu``.

(The set helpers are copied here: a GPU host may have another package named
``tests`` on its path.)"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import apsu_tpu.mpc.duplex as r_duplex
from apsu_tpu.api.parties import Sender as RefSender
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu.mpc.prg import CsRng as RefCsRng
from apsu_tpu.parallel.multihost import DistributedReceiver as RefDist
from apsu_tpu.parallel.multihost import db_worker as ref_db_worker
from apsu_tpu.parallel.multihost import partition_bundles as ref_partition_bundles
import apsu_tpu_torch.mpc.duplex as p_duplex
from apsu_tpu_torch.api.parties import Sender
from apsu_tpu_torch.api.protocol import run_psu
from apsu_tpu_torch.api.session import QueryClient, serve_db_party
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.mpc.prg import CsRng
from apsu_tpu_torch.parallel import multihost
from apsu_tpu_torch.parallel.multihost import DistributedReceiver, db_worker, partition_bundles

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 180
# 4 bundle indices (N=128, fpi=4 -> 32 items a bundle; table 128), as
# tests/test_multihost.py:_multibundle_params
MULTI = {
    "table_params": {"hash_func_count": 2, "table_size": 128, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 128,
                    "coeff_modulus_bits": [40, 40, 30]},
}
PKG = {
    "ref": dict(params=RefParams, worker=ref_db_worker, dist=RefDist, duplex=r_duplex,
                rng=RefCsRng, sender=RefSender, oprf=RefOprf, kw={}),
    "port": dict(params=PSUParams, worker=db_worker, dist=DistributedReceiver,
                 duplex=p_duplex, rng=CsRng, sender=Sender, oprf=DebugOprf,
                 kw={"device": "cpu"}),
}


def make_sets(rng, n_db, n_query, n_common):
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def as_set(a):
    return {(int(x), int(y)) for x, y in np.ascontiguousarray(a).view(np.uint64).reshape(-1, 2)}


def check_oracle(db, query, result):
    dbs, qs = as_set(db), as_set(query)
    assert as_set(result.transferred) == qs - dbs
    assert as_set(result.union) == dbs | qs


def _grid_sets(cache_parts):
    """tests/test_multihost.py's sets: 400 items for two workers, 700 (bins
    overflowing into several caches) for the 2 × 2 grid."""
    if cache_parts == 1:
        return make_sets(np.random.default_rng(51), 400, 40, 15)
    rng = np.random.default_rng(52)
    db = rng.integers(0, 1 << 64, size=(700, 2), dtype=np.uint64)
    query = np.concatenate([rng.integers(0, 1 << 64, size=(25, 2), dtype=np.uint64),
                            db[rng.choice(700, size=12, replace=False)]])
    return db, query


def _start_workers(worker, chans, params, rng_cls, **kw):
    """``worker`` on each channel in a thread, worker i seeded by its index."""
    errs, threads = [], []
    for i, ch in enumerate(chans):
        def run(ch=ch, i=i):
            try:
                worker(ch, params, rng=rng_cls(b"mh-test-worker-%08d-key" % i), **kw)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        threads.append(th)
    return threads, errs


def _join(threads, errs):
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive(), "a worker did not finish"
    if errs:
        raise errs[0]


def _run_grid(name, n_workers, cache_parts, coordinator=None):
    """Workers of package ``name`` over pipes (or, with ``coordinator``, port
    workers under that package's coordinator over TCP sockets); one seeded
    query through the coordinator.  Returns what the comparison needs."""
    coord = PKG[coordinator or name]
    work = PKG[name]
    params = coord["params"].from_dict(MULTI)
    db_items, query = _grid_sets(cache_parts)
    if coordinator is None:
        pairs = [work["duplex"].pipe_pair() for _ in range(n_workers)]
    else:
        pairs = [_tcp_pair(coord["duplex"], work["duplex"]) for _ in range(n_workers)]
    sent = [[] for _ in pairs]
    for (c, _), log in zip(pairs, sent):   # record the coordinator's frames
        c.send = (lambda real, log, enc: lambda obj: (log.append(enc(obj)), real(obj)))(
            c.send, log, coord["duplex"]._encode)
    threads, errs = _start_workers(work["worker"], [w for _, w in pairs],
                                   work["params"].from_dict(MULTI), work["rng"], **work["kw"])
    dist = coord["dist"](params, [c for c, _ in pairs], db_items, oprf_kind="debug",
                         oprf_key=0x5EED, rng=coord["rng"](b"mh-test-coordinator-key1"),
                         cache_parts=cache_parts, **coord["kw"])
    try:
        snd = coord["sender"](params, coord["oprf"](0x5EED), rng=np.random.default_rng(7),
                              **coord["kw"])
        resp = dist.run_query(snd.create_query(query))
        out = dict(ranges=list(dist.ranges), worker_C=list(dist.worker_C), C=dist.C,
                   results=to_u32(resp.results) if name == "port" and coordinator is None
                   else np.asarray(resp.results), mask=np.array(dist.last_mask),
                   level=resp.eval_level, sent=[list(log) for log in sent])
        if coordinator is None and name == "port":
            snd2 = Sender(params, DebugOprf(0x5EED), rng=np.random.default_rng(8), device="cpu")
            check_oracle(db_items, query, run_psu(params, query, db_items, sender=snd2,
                                                  receiver=dist, device="cpu"))
    finally:
        dist.close()
        _join(threads, errs)
    return out


def _tcp_pair(a_mod, b_mod):
    """A localhost TCP link: a ``a_mod`` SocketDuplex on one end and a
    ``b_mod`` one on the other (ephemeral port)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    c = socket.create_connection(("127.0.0.1", srv.getsockname()[1]))
    conn, _ = srv.accept()
    srv.close()
    return a_mod.SocketDuplex(c), b_mod.SocketDuplex(conn)


def test_partition_bundles():
    assert partition_bundles(4, 2) == [(0, 2), (2, 4)]
    assert partition_bundles(5, 2) == [(0, 3), (3, 5)]
    assert partition_bundles(3, 3) == [(0, 1), (1, 2), (2, 3)]
    for n in range(1, 12):
        for w in range(1, 6):
            assert partition_bundles(n, w) == ref_partition_bundles(n, w)


@pytest.mark.parametrize("n_workers,cache_parts", [(2, 1), (4, 2)])
def test_distributed_receiver_matches_reference(n_workers, cache_parts):
    """Two workers, and the 2 × 2 grid (bundle ranges × cache ranges from the
    global C), in both packages under the same seeds: every coordinator
    frame, the ranges, the workers' C, the results and the masks."""
    ref = _run_grid("ref", n_workers, cache_parts)
    got = _run_grid("port", n_workers, cache_parts)
    if cache_parts > 1:
        assert len({r[2:] for r in got["ranges"]}) > 1   # a real cache split
    for key in ("ranges", "worker_C", "C", "level"):
        assert got[key] == ref[key], key
    assert np.array_equal(got["results"], ref["results"])
    assert np.array_equal(got["mask"], ref["mask"])
    assert got["sent"] == ref["sent"]


def test_reference_coordinator_drives_port_workers():
    """The JAX coordinator over TCP sockets to port workers: it sends the
    port coordinator's frames byte for byte and gets the same answers."""
    got = _run_grid("port", 4, 2, coordinator="ref")
    want = _run_grid("port", 4, 2)
    for key in ("ranges", "worker_C", "C", "level"):
        assert got[key] == want[key], key
    assert np.array_equal(got["results"], want["results"])
    assert np.array_equal(got["mask"], want["mask"])
    assert got["sent"] == want["sent"]


def test_full_mpc_stack_partitioned_over_sockets():
    """tests/test_multihost.py:test_full_mpc_stack_partitioned_over_sockets's
    twin, with two queries: KKRT OPRF set up once at the coordinator (key
    columns shipped to the workers), OSN PEQT and chosen OT, the DB over two
    workers, every link a TCP socket; the second query opens a fresh KKRT
    correlation (OP_REBIND), which every worker rebinds to."""
    rng = np.random.default_rng(53)
    params = PSUParams.from_dict(MULTI)
    db_items, query = make_sets(rng, 400, 40, 15)
    query2 = np.concatenate([db_items[:7], rng.integers(0, 1 << 64, (11, 2), dtype=np.uint64)])
    wpairs = [_tcp_pair(p_duplex, p_duplex) for _ in range(2)]
    ch_q, ch_db = _tcp_pair(p_duplex, p_duplex)
    errs, out = [], {}

    def run(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def client():
        cl = QueryClient(ch_q, rng=CsRng(b"mh-sock-client-keyseed01"), params=params,
                         device="cpu")
        for q in (query, query2):
            cl.query(q, peqt="osn")
        cl.close()

    timings = {}
    fns = [lambda i=i: db_worker(wpairs[i][1], params, device="cpu",
                                 rng=CsRng(b"mh-sock-worker-%08d-key" % i)) for i in range(2)]
    fns.append(lambda: out.setdefault("transferred", serve_db_party(
        ch_db, params, db_items, CsRng(b"mh-sock-coordinator-key1"), timings=timings,
        max_queries=2, workers=[p[0] for p in wpairs], device="cpu")))
    fns.append(client)
    threads = [threading.Thread(target=run, args=(f,), daemon=True) for f in fns]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    if errs:
        raise errs[0]
    got = out["transferred"]
    assert len(got) == 2
    assert as_set(got[0]) == as_set(query) - as_set(db_items)
    assert as_set(got[1]) == as_set(query2) - as_set(db_items)
    assert len(timings["worker_build_s"]) == len(timings["worker_rebind_s"]) == 2
    assert {"dist_scatter_s", "dist_wait_s", "dist_concat_s", "rebind"} <= set(timings)


def test_worker_rebind_releases_the_consumed_cache_first(monkeypatch):
    """A reference fault not copied: apsu_tpu/parallel/multihost.py's worker
    builds the rebound cache while it still holds the consumed one.  The
    port's worker releases it first: when ``ReceiverDB.rebind`` runs, the
    DB it is called on holds no cache."""
    params = PSUParams.from_dict(MULTI)
    db_items, query = make_sets(np.random.default_rng(54), 300, 30, 10)
    seen = []
    real = ReceiverDB.rebind

    def rebind(self, oprf, eval_level=None):
        seen.append(self.coeff_cache is None and self.const_slots is None)
        return real(self, oprf, eval_level)

    monkeypatch.setattr(ReceiverDB, "rebind", rebind)
    key = np.random.default_rng(55)

    def kkrt():
        return multihost._kkrt_from_columns(key.integers(0, 256, (128, 64), dtype=np.uint8),
                                            key.integers(0, 256, 64, dtype=np.uint8))

    pairs = [p_duplex.pipe_pair() for _ in range(2)]
    threads, errs = _start_workers(db_worker, [w for _, w in pairs], params, CsRng,
                                   device="cpu")
    dist = DistributedReceiver(params, [c for c, _ in pairs], db_items, oprf=kkrt(),
                               device="cpu")
    try:
        snd = Sender(params, DebugOprf(), rng=np.random.default_rng(3), device="cpu")
        req = snd.create_query(query)
        first = dist.run_query(req)
        dist.rebind(kkrt())
        second = dist.run_query(req)
    finally:
        dist.close()
        _join(threads, errs)
    assert seen == [True, True]
    assert second.results.shape == first.results.shape
    assert len(dist.worker_rebind_s) == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multihost_workers(tmp_path):
    """tests/test_cli_two_process.py:test_cli_multihost_workers's twin on the
    port with ``--device cpu``: two ``worker_cli`` processes started on
    ``--port 0`` (each logs the port it bound, once bound), ``receiver_cli
    --workers`` as the coordinator and ``sender_cli``."""
    rng = np.random.default_rng(7)
    db = [f"db-item-{i}" for i in range(300)]
    query = [f"q-{i}" for i in range(20)] + list(rng.choice(db, size=9, replace=False))
    (tmp_path / "params.json").write_text(json.dumps(MULTI))
    (tmp_path / "db.csv").write_text("".join(s + "\n" for s in db))
    (tmp_path / "query.csv").write_text("".join(s + "\n" for s in query))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    common = ["--params", str(tmp_path / "params.json"), "--device", "cpu"]
    procs, logs = [], []

    def start(module, *argv):
        p = subprocess.Popen([sys.executable, "-m", f"apsu_tpu_torch.cli.{module}", *argv],
                             cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
        lines = []
        threading.Thread(target=lambda: lines.extend(p.stderr), daemon=True).start()
        procs.append(p)
        logs.append(lines)
        return p, lines

    def wait_for(pattern, p, lines):
        deadline = time.monotonic() + 120
        while True:
            found = re.search(pattern, "".join(lines))
            if found:
                return found
            assert p.poll() is None and time.monotonic() < deadline, "".join(lines)[-2000:]
            time.sleep(0.1)

    try:
        ports = []
        for _ in range(2):
            p, lines = start("worker_cli", *common, "--port", "0", "--bind", "127.0.0.1")
            ports.append(int(wait_for(r"worker listening on 127\.0\.0\.1:(\d+)", p, lines)[1]))
        assert 0 not in ports
        port = str(_free_port())
        recv, recv_lines = start(
            "receiver_cli", *common, "--db-file", str(tmp_path / "db.csv"), "--port", port,
            "--bind", "127.0.0.1", "--out", str(tmp_path / "union.csv"), "--seed", "1",
            "--workers", ",".join(f"127.0.0.1:{q}" for q in ports))
        wait_for("listening on 127.0.0.1:" + port, recv, recv_lines)
        send = subprocess.run(
            [sys.executable, "-m", "apsu_tpu_torch.cli.sender_cli", "--query-file",
             str(tmp_path / "query.csv"), "--host", "127.0.0.1", "--port", port,
             "--device", "cpu", "--seed", "2"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert send.returncode == 0, send.stderr[-3000:]
        for p, lines in zip(procs, logs):
            assert p.wait(timeout=240) == 0, "".join(lines)[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    union = set((tmp_path / "union.csv").read_text().split())
    assert union == set(db) | set(query)
    assert "coordinating 2 DB workers" in "".join(recv_lines)
    assert all("worker done" in "".join(lines) for lines in logs[:2])
