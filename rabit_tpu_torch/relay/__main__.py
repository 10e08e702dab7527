"""A relay node of its own: ``python -m rabit_tpu_torch.relay --tracker H:P``.

Point a share of the workers' ``DMLC_TRACKER_URI`` / ``DMLC_TRACKER_PORT``
at the address it prints; the relay terminates their liveness and metrics
RPCs and batches the rest to the tracker over one channel.  ``--tracker``
takes a failover list, ``H:P,H:P`` (the primary first).  The launcher
(``rabit_tpu_torch.tracker.launcher --relays R``) hosts its relays in its
own process; this entry point is for a relay on another host.
"""

from __future__ import annotations

import argparse
import sys
import time

from rabit_tpu_torch.relay import Relay
from rabit_tpu_torch.tracker import protocol as P


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracker", required=True, metavar="HOST:PORT",
                    help="the tracker's address, or a failover list HOST:PORT,HOST:PORT")
    ap.add_argument("--id", default="r0", help="the relay's id (its telemetry name)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="the port the children dial (0: any free port)")
    ap.add_argument("--flush-sec", type=float, default=0.25, help="the upstream batch cadence")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    addrs = P.parse_addrs(args.tracker)
    if not addrs:
        ap.error(f"--tracker wants HOST:PORT, got {args.tracker!r}")
    relay = Relay(addrs, relay_id=args.id, host=args.host, port=args.port,
                  flush_sec=args.flush_sec, quiet=args.quiet).start()
    # the address line a launcher parses, out before the relay serves
    print(f"[relay {args.id}] listening on {relay.host}:{relay.port}", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        relay.stop()
        return 0


if __name__ == "__main__":
    sys.exit(main())
