#!/usr/bin/env python
"""Chaos fuzz bench on the PyTorch/CUDA port (the counterpart of
tools/chaos_bench.py): drive N fuzzed bootstrap/recovery schedules through
the port's chaos proxy (``rabit_tpu_torch.chaos.run_schedule``) and report
convergence statistics.

Each schedule points a world of protocol-level workers at a freshly
scripted ChaosProxy in front of a real Tracker, injects
refuse/delay/truncate/blackhole faults for a few rounds, heals the
network, and requires convergence: all workers agree on one epoch with
stable distinct ranks, or the schedule fails.  A hang anywhere (a thread
alive past its bounded RPC budget) is a hard failure — the property the
liveness layer exists to guarantee.

Usage:
    python tools/torch_chaos_bench.py --schedules 200 [--seed-base 0]
        [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rabit_tpu_torch.chaos import run_schedule  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--schedules", type=int, default=200)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--faulty-rounds", type=int, default=2)
    ap.add_argument("--json", type=str, default="",
                    help="write per-schedule results to this JSON file")
    args = ap.parse_args(argv)

    t0 = time.time()
    results = []
    n_completed = n_failed = 0
    rounds_total = 0
    worst = 0.0
    for i in range(args.schedules):
        seed = args.seed_base + i
        try:
            r = run_schedule(seed, faulty_rounds=args.faulty_rounds)
        except (TimeoutError, AssertionError) as exc:
            n_failed += 1
            print(f"FAIL seed={seed}: {exc}", flush=True)
            results.append({"seed": seed, "outcome": "FAILED",
                            "error": str(exc)})
            continue
        n_completed += r.completed
        rounds_total += r.rounds
        worst = max(worst, r.elapsed)
        results.append({
            "seed": r.seed, "world": r.world, "rounds": r.rounds,
            "outcome": r.outcome, "epoch": r.epoch,
            "elapsed_sec": round(r.elapsed, 3),
            "faults": {
                "connections": r.stats.connections,
                "refused": r.stats.refused,
                "truncated": r.stats.truncated,
                "blackholed": r.stats.blackholed,
            },
        })
        if (i + 1) % 25 == 0:
            print(f"  {i + 1}/{args.schedules} schedules "
                  f"({time.time() - t0:.1f}s)", flush=True)

    elapsed = time.time() - t0
    print(f"torch_chaos_bench: {args.schedules} schedules in {elapsed:.1f}s — "
          f"{n_completed} completed, {n_failed} FAILED, "
          f"{rounds_total / max(args.schedules, 1):.2f} rounds/schedule, "
          f"worst {worst:.2f}s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schedules": args.schedules, "completed": n_completed,
                       "failed": n_failed, "elapsed_sec": round(elapsed, 2),
                       "results": results}, f, indent=1)
        print(f"wrote {args.json}")
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
