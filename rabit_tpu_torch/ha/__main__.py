"""A warm standby on its own.

    python -m rabit_tpu_torch.ha --primary HOST:PORT [--host H] [--port P] \\
        [--journal PATH] [--takeover-sec S] [--id standby0]

Runs a :class:`~rabit_tpu_torch.ha.standby.Standby` until it is promoted
and its tracker's job ends (or it is interrupted).  The defaults come from
the config keys ``rabit_ha_journal`` and ``rabit_ha_takeover_sec``.  A job
launched by ``rabit_tpu_torch.tracker.launcher --standby`` gets the same in
its launcher's process.
"""

from __future__ import annotations

import argparse
import sys

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.ha.standby import Standby


def main(argv: list[str] | None = None) -> int:
    cfg = Config()
    ap = argparse.ArgumentParser(prog="rabit_tpu_torch.ha", description=__doc__)
    ap.add_argument("--primary", required=True, metavar="HOST:PORT",
                    help="the primary tracker to tail over CMD_JOURNAL")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="the standby's advertised port (the second rabit_tracker_addrs "
                         "entry); 0 picks one")
    ap.add_argument("--journal", default=cfg.get("rabit_ha_journal", "") or None,
                    help="journal file the promoted tracker writes (default: "
                         "rabit_ha_journal)")
    ap.add_argument("--takeover-sec", type=float,
                    default=float(cfg.get("rabit_ha_takeover_sec", "1.0") or "1.0"))
    ap.add_argument("--id", default="standby0")
    args = ap.parse_args(argv)
    host, _, port_s = args.primary.rpartition(":")
    standby = Standby(primary=(host, int(port_s)), host=args.host, port=args.port,
                      standby_id=args.id, takeover_sec=args.takeover_sec,
                      journal=args.journal, quiet=False).start()
    print(f"[standby {args.id}] advertising {standby.host}:{standby.port} "
          "(add it to rabit_tracker_addrs)", flush=True)
    try:
        standby.wait_promoted()
        if standby.tracker is not None:
            standby.tracker.wait()
    except KeyboardInterrupt:
        pass
    finally:
        standby.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
