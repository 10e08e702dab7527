"""Repeat chip_smoke.py's chaos failover runs and report how close each
live lease came to expiring.

    python3 tools/torch_failover_slack.py                      # this checkout, the card
    python3 tools/torch_failover_slack.py --tree _tree/parent --runs 10
    python3 tools/torch_failover_slack.py --device cpu --runs 2

Runs ``chaos.run_elastic_schedule`` with the ``chaos`` phase's "tracker
death" (seed 9301) and "relay bounce" (seed 7101) arguments ``--runs``
times each, from the checkout at ``--tree`` (default: the repository this
file is in), after one warm-up call of the kernel.  Every tracker's lease
renewal is timed against the lease it renews: the slack is the lease's
deadline less the renewal's time, so a slack near 0 is a renewal that
nearly came too late.  Prints the card's name and power limit
(``nvidia-smi``) and one ``[slack] <tree> {...}`` line: a run's failures
(the schedule's own asserts, a spurious ``lease_expired`` among them) and
the smallest slack of each run, sorted.  Exits 1 when a run failed.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose port runs (default: this one)")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np

    from rabit_tpu_torch import chaos
    from rabit_tpu_torch.tracker import tracker as tracker_mod

    slack: list[float] = []
    renew = tracker_mod.Tracker._renew_lease

    def timed_renew(self, task_id, rank, payload):
        with self._lock:
            lease = self._leases.get(task_id)
        if lease is not None:
            slack.append(lease.expires - time.monotonic())
        return renew(self, task_id, rank, payload)

    tracker_mod.Tracker._renew_lease = timed_renew
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "no nvidia-smi"
    print(card, flush=True)
    # the kernel is built and loaded before the first timed run
    chaos._shard_counter(np.arange(8), 8, args.device)(slice(0, 8))
    runs = {
        "tracker death": (9301, dict(world=3, niter=5, iter_sleep=0.1,
                                     failover=chaos.FaultSpec(tracker_death=0.05))),
        "relay bounce": (7101, dict(world=3, relays=2, heartbeat_sec=0.3, niter=8,
                                    iter_sleep=0.15, deadline_sec=60.0,
                                    relay_fault=chaos.FaultSpec(relay_death=(0.8, 0.4)))),
    }
    out, failed = {}, 0
    for what, (seed, kw) in runs.items():
        fails, mins = [], []
        for _ in range(args.runs):
            slack.clear()
            try:
                chaos.run_elastic_schedule(seed, device=args.device, **kw)
            except AssertionError as exc:
                fails.append(str(exc)[:200])
            if slack:
                mins.append(round(min(slack), 4))
        failed += len(fails)
        out[what] = {"seed": seed, "runs": args.runs, "failed": len(fails), "fails": fails[:3],
                     "min_slack_s": sorted(mins)}
    print(f"[slack] {args.tree} {json.dumps(out)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
