"""DB-party worker CLI: one partition host of a multi-host receiver (port of
``apsu_tpu/cli/worker_cli.py``).

Each worker process owns a (bundle-range × cache-range) partition of the DB:
it builds it on ``--device`` from the coordinator's share of the items, then
serves query slices (and KKRT rebinds) until the coordinator says "bye".
Start the workers first, then the coordinator:

  python -m apsu_tpu_torch.cli.worker_cli --params parameters/1M-2048-com.json \\
      --port 1301 [--device cpu]
  python -m apsu_tpu_torch.cli.receiver_cli ... --workers 127.0.0.1:1301,... \\
      [--cache-parts 2]

The worker binds before it logs "worker listening on HOST:PORT", with the
port it bound (``--port 0`` takes a free one).  The link to the coordinator
is intra-party (one trust domain): OPRF key material and masks travel over
it, never to the query party.  On a card the last log lines give the
process's peak device memory and its kernel launches.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="apsu_tpu_torch DB-party worker")
    ap.add_argument("--params", required=True, help="parameter JSON file")
    ap.add_argument("--port", type=int, required=True, help="0 takes a free port")
    ap.add_argument("--bind", default="0.0.0.0")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the partition's cache (default cuda)")
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--silent", action="store_true")
    args = ap.parse_args(argv)

    from apsu_tpu_torch.cli.receiver_cli import log_device_report
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.device import resolve
    from apsu_tpu_torch.mpc.duplex import SocketListener
    from apsu_tpu_torch.parallel.multihost import db_worker
    from apsu_tpu_torch.utils.log import configure

    device = resolve(args.device)
    log = configure(args.log_level, None, args.silent)
    params = PSUParams.load_file(args.params)
    with SocketListener(args.port, args.bind) as lst:
        # logged once bound, so a coordinator that waits for this line can connect
        log.info("worker listening on %s:%d", args.bind, lst.port)
        ch = lst.accept()
    try:
        db_worker(ch, params, device=device)
    finally:
        ch.close()
    log.info("worker done (sent %d bytes, received %d)", ch.bytes_sent, ch.bytes_received)
    log_device_report(log, device)


if __name__ == "__main__":
    main()
