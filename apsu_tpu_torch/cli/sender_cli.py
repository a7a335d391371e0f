"""Sender (query-side) CLI (port of ``apsu_tpu/cli/sender_cli.py``): load the
query CSV, connect, run the query, transfer the difference set.  The params
come from the DB party; --params only cross-checks them.

Usage:
  python -m apsu_tpu_torch.cli.sender_cli --query-file query.csv \\
      --host 127.0.0.1 --port 1212 [--params parameters/100K-1.json] [--device cpu]

Several query files make several queries on one connection, one after the
other (a receiver started with ``--serve N``); with the KKRT OPRF each query
after the first opens a fresh correlation (OP_REBIND).
"""

from __future__ import annotations

import argparse
import sys

from apsu_tpu_torch.cli.receiver_cli import _make_rng, log_device_report


def main(argv=None):
    ap = argparse.ArgumentParser(description="apsu_tpu_torch sender (query party)")
    ap.add_argument("--query-file", required=True, nargs="+",
                    help="CSV of query items; several files make several queries")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=1212)
    ap.add_argument("--params", default=None, help="optional params cross-check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--silent", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the query's encryption (default cuda)")
    ap.add_argument("--peqt", default="osn", choices=["osn", "ddh"],
                    help="permuted-equality-test variant (default: osn)")
    ap.add_argument("--oprf", default="kkrt", choices=["kkrt", "ecdh"],
                    help="OPRF backend: kkrt (one correlation per query) or "
                    "ecdh (fixed key, one resident cache for every query)")
    args = ap.parse_args(argv)

    from apsu_tpu_torch.api.session import QueryClient
    from apsu_tpu_torch.cli.csv_io import load_csv
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.device import resolve
    from apsu_tpu_torch.mpc.duplex import SocketDuplex
    from apsu_tpu_torch.utils.log import configure
    from apsu_tpu_torch.utils.stopwatch import GLOBAL

    device = resolve(args.device)
    log = configure(args.log_level, args.log_file, args.silent)
    queries = [load_csv(path) for path in args.query_file]
    params = PSUParams.load_file(args.params) if args.params else None
    log.info("query: %s items; connecting to %s:%d",
             "+".join(str(len(s)) for _, _, s in queries), args.host, args.port)

    ch = SocketDuplex.connect(args.host, args.port)
    client = QueryClient(ch, rng=_make_rng(args.seed), params=params, oprf=args.oprf,
                         device=device)
    for items, payloads, _ in queries:
        timings = {}
        with GLOBAL.span("query"):
            client.query(items, payloads=payloads, peqt=args.peqt, timings=timings)
        log.info("query complete; timings: %s", {k: round(v, 3) for k, v in timings.items()})
    client.close()
    log.info("bytes sent=%d received=%d", ch.bytes_sent, ch.bytes_received)
    ch.close()
    log_device_report(log, device)
    print(GLOBAL.report(), file=sys.stderr)


if __name__ == "__main__":
    main()
