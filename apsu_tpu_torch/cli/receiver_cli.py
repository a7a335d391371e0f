"""Receiver (DB-side) CLI (port of ``apsu_tpu/cli/receiver_cli.py``): load the
params and a CSV DB, listen, serve PSU queries, write union.csv.

Usage:
  python -m apsu_tpu_torch.cli.receiver_cli --params parameters/100K-1.json \\
      --db-file db.csv --port 1212 --out union.csv [--device cpu]

The DB's cache lives on ``--device`` (default ``cuda``; without a card it
raises).  With ``--workers`` the DB is partitioned over ``worker_cli``
processes, ``--cache-parts`` cache ranges to a bundle range, and this
process coordinates them:

  python -m apsu_tpu_torch.cli.receiver_cli ... --workers HOST:PORT,... [--cache-parts 2]
  On a card the last log lines give the process's peak device memory
and the launches of each hand-written kernel.
"""

from __future__ import annotations

import argparse
import json
import sys


def _make_rng(seed: int):
    """OS-entropy CsRng in production; a sha256-derived fixed key when --seed
    is given (reproducible runs for tests only — a 32-bit seed is
    brute-forceable and must never be used against a real counterparty)."""
    import hashlib

    from apsu_tpu_torch.mpc.prg import CsRng

    if seed:
        return CsRng(hashlib.sha256(b"apsu-cli-seed:%d" % seed).digest())
    return CsRng()


def log_device_report(log, device) -> None:
    """On a card: the process's peak device memory and the launch count of
    each hand-written kernel (its wrapper's counter)."""
    import torch

    if device.type != "cuda":
        return
    from apsu_tpu_torch.ops import ntt, polyeval

    log.info("peak device memory: %.4f GB", torch.cuda.max_memory_allocated(device) / 1e9)
    log.info("kernel launches: %s", json.dumps(
        {"ntt": ntt.launches, "ps_inner": polyeval.launches, "eval_dot": polyeval.dot_launches}))


def main(argv=None):
    ap = argparse.ArgumentParser(description="apsu_tpu_torch receiver (DB party)")
    ap.add_argument("--params", required=True, help="parameter JSON file")
    ap.add_argument("--db-file", required=True, help="CSV of DB items")
    ap.add_argument("--port", type=int, default=1212)
    ap.add_argument("--bind", default="0.0.0.0")
    ap.add_argument("--out", default="union.csv")
    ap.add_argument(
        "--serve", type=int, default=1, metavar="N",
        help="serve N queries from one connection before exiting (0 = until "
        "the client disconnects); a KKRT client opens a fresh correlation for "
        "each query after the first (OP_REBIND), an ECDH client reuses the cache",
    )
    ap.add_argument(
        "--clients", type=int, default=1, metavar="M",
        help="accept M successive client connections against one resident "
        "DB before exiting (0 = forever); M != 1 builds the DB with the "
        "ECDH backend up front (KKRT clients get a per-session rebuild)",
    )
    ap.add_argument(
        "--workers", default=None, metavar="HOST:PORT,...",
        help="comma-separated DB worker endpoints (worker_cli processes); the DB "
        "then builds and evaluates as a bundle-range partition across them with "
        "this process as coordinator",
    )
    ap.add_argument(
        "--cache-parts", type=int, default=1,
        help="split each bundle range's cache axis across this many of the "
        "workers (worker count must be bundle_parts*cache_parts)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--silent", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the DB's cache (default cuda)")
    args = ap.parse_args(argv)
    if args.workers and args.clients != 1:
        ap.error("--clients is incompatible with --workers")
    if args.cache_parts != 1 and not args.workers:
        ap.error("--cache-parts needs --workers")

    from apsu_tpu_torch.api.session import serve_clients, serve_db_party
    from apsu_tpu_torch.cli.csv_io import decode_payloads, load_csv, write_union_csv
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.device import resolve
    from apsu_tpu_torch.mpc.duplex import SocketDuplex, SocketListener
    from apsu_tpu_torch.utils.log import configure
    from apsu_tpu_torch.utils.stopwatch import GLOBAL

    device = resolve(args.device)
    log = configure(args.log_level, args.log_file, args.silent)
    params = PSUParams.load_file(args.params)
    items, _, strings = load_csv(args.db_file)
    log.info("DB: %d items; params N=%d table=%d; device %s", len(strings),
             params.poly_degree, params.table_params.table_size, device)

    workers = []
    if args.workers:
        for ep in args.workers.split(","):
            host, _, port = ep.strip().rpartition(":")
            workers.append(SocketDuplex.connect(host or "127.0.0.1", int(port)))
        log.info("coordinating %d DB workers", len(workers))

    rng = _make_rng(args.seed)
    timings = {}
    lst = SocketListener(args.port, args.bind)
    # logged once bound, so a client that waits for this line can connect
    log.info("listening on %s:%d", args.bind, lst.port)
    if args.clients != 1:
        with lst, GLOBAL.span("serve_clients"):
            per_client = serve_clients(
                lst, params, items, rng, timings=timings,
                max_clients=args.clients if args.clients > 0 else None,
                queries_per_client=args.serve if args.serve > 0 else None,
                device=device,
            )
        per_query = [q for client in per_client for q in client]
        ch = None
    else:
        with lst:
            ch = lst.accept()
        with GLOBAL.span("serve_query"):
            per_query = serve_db_party(
                ch, params, items, rng, timings=timings,
                max_queries=args.serve if args.serve > 0 else None,
                workers=workers, cache_parts=args.cache_parts, device=device,
            )
    new_payloads = [p for q in per_query for p in decode_payloads(q)]
    union = sorted(set(strings) | set(new_payloads))
    write_union_csv(args.out, union)
    log.info("union: %d items -> %s (%d queries, received %d new)", len(union),
             args.out, len(per_query), len(new_payloads))
    # values are floats except the workers' build and rebind times (lists)
    log.info("timings: %s", {k: round(v, 3) if isinstance(v, float) else v
                             for k, v in timings.items()})
    if ch is not None:
        log.info("bytes sent=%d received=%d", ch.bytes_sent, ch.bytes_received)
        ch.close()
    for i, w in enumerate(workers):
        log.info("worker %d link: bytes sent=%d received=%d", i, w.bytes_sent, w.bytes_received)
        w.close()
    log_device_report(log, device)
    print(GLOBAL.report(), file=sys.stderr)


if __name__ == "__main__":
    main()
