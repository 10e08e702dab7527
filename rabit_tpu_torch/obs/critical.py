"""Per-round critical path: which fault bounded each collective round.

The port's own copy of ``rabit_tpu/obs/critical.py``.
``trace.straggler_report`` ranks ranks by lateness, but a lateness table
cannot say what kind of fault bounded a round: a compute straggler and a
degraded planned-ring link both stretch the wall time, with opposite
signatures.  Every round of the merged span timeline
(``trace.collective_arrivals``) is classified by two terms:

* **entry skew**, the last-entering rank's begin minus the median begin.
  A compute straggler enters late every round, so its rounds show entry
  skew about its delay and a drain near the baseline;
* **excess drain**, the round's drain (last end minus last begin: the
  time in the collective once everyone has arrived) minus the job's
  median drain.  A degraded link costs nothing at entry but stretches the
  collective by about (W - 1) hop delays.

The larger term names the gate: ``compute`` rounds indict the last
entering rank, ``link`` rounds the incoming planned-ring link of the rank
that drains last (a slow link's dst drains last, the asymmetry
``sched/repair.py`` uses).  Rounds where both terms sit under the noise
margin are ``balanced``; rounds overlapping a recovery wave are costed
apart, as in ``straggler_report``.

The report joins the streamed ``link_wait_seconds{src,dst}`` rollup of
``telemetry.json``, so each gating link carries its streamed wait beside
its drain: two independent witnesses of one fault.
:func:`fold_critical_path` writes the report into the telemetry file under
``critical_path``; ``tools/torch_trace_tool.py diagnose`` is the CLI.
"""

from __future__ import annotations

import json
import os
import time

from rabit_tpu_torch.obs.trace import (JobTrace, TraceError, collective_arrivals,
                                 recovery_windows, telemetry_name)

#: Critical-path report schema (bump on incompatible change).
CRITICAL_SCHEMA = 1

#: Below this, neither entry skew nor excess drain indicts anyone — the
#: round is "balanced".  Generous vs scheduler jitter on a loopback CI
#: box; chaos-injected faults sit well above it.
DEFAULT_MARGIN_SEC = 0.02


def _median(values: list[float]) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0


def ring_prev(rank: int, ring: list[int]) -> int:
    """The planned-ring predecessor of ``rank`` among the round's
    participants (the schedule orders the ring by rank, so the cyclic
    predecessor in sorted order is the rank whose frames ``rank`` waits
    on — see sched/ring planning)."""
    order = sorted(ring)
    return order[order.index(rank) - 1]


def critical_path_report(job: JobTrace, margin_sec: float = DEFAULT_MARGIN_SEC,
                         top_k: int = 3) -> dict:
    """Classify every seqno-stamped collective round and aggregate the
    gating tables.  Pure function of an already-loaded :class:`JobTrace`;
    raises nothing on thin data (an empty job yields an empty report)."""
    arrivals = collective_arrivals(job)
    windows = recovery_windows(job)
    err = job.max_clock_err()

    rounds: list[dict] = []
    drains: list[float] = []
    affected = 0
    for key in sorted(arrivals, key=lambda k: (k[0] or 0, k[1] or 0)):
        ranks = arrivals[key]
        if len(ranks) < 2:
            continue
        begins = {r: s.begin for r, s in ranks.items()}
        ends = {r: s.end for r, s in ranks.items() if s.end is not None}
        if not ends:
            continue
        lo = min(begins.values()) - margin_sec - err
        hi = max(ends.values()) + margin_sec + err
        if any(s <= hi and e >= lo for s, e in windows):
            affected += 1
            continue
        last_rank = max(begins, key=begins.get)
        entry_skew = begins[last_rank] - _median(list(begins.values()))
        drain = max(ends.values()) - max(begins.values())
        drains.append(drain)
        rounds.append({
            "key": key, "ranks": ranks, "begins": begins, "ends": ends,
            "last_rank": last_rank, "entry_skew": max(entry_skew, 0.0),
            "drain": max(drain, 0.0),
            "latency": max(ends.values()) - min(begins.values()),
        })

    base_drain = _median(drains)
    by_class = {"compute": 0, "link": 0, "balanced": 0}
    rank_gates: dict[int, dict] = {}
    link_gates: dict[tuple[int, int], dict] = {}
    breakdown: list[dict] = []
    for rnd in rounds:
        excess = max(rnd["drain"] - base_drain, 0.0)
        skew = rnd["entry_skew"]
        entry = {"op": rnd["key"][2], "version": rnd["key"][0],
                 "seqno": rnd["key"][1],
                 "latency_s": round(rnd["latency"], 6),
                 "entry_skew_s": round(skew, 6),
                 "excess_drain_s": round(excess, 6)}
        if max(skew, excess) < margin_sec:
            by_class["balanced"] += 1
            entry["gate"] = "balanced"
        elif skew >= excess:
            by_class["compute"] += 1
            rank = rnd["last_rank"]
            entry.update(gate="compute", rank=rank)
            agg = rank_gates.setdefault(rank, {"rounds": 0, "cost_s": 0.0})
            agg["rounds"] += 1
            agg["cost_s"] += skew
        else:
            by_class["link"] += 1
            # the slowest in-collective rank is the dst of the gating link
            spans = rnd["ranks"]
            dst = max(rnd["ends"],
                      key=lambda r: rnd["ends"][r] - spans[r].begin)
            src = ring_prev(dst, list(spans))
            entry.update(gate="link", src=src, dst=dst)
            agg = link_gates.setdefault((src, dst),
                                        {"rounds": 0, "cost_s": 0.0})
            agg["rounds"] += 1
            agg["cost_s"] += excess
        breakdown.append(entry)

    # join the streamed link_wait_seconds rollup: an independent witness
    stream = ((job.telemetry or {}).get("stream") or {})
    stream_wait: dict[tuple, float] = {}
    for row in stream.get("links", ()):
        try:
            stream_wait[(int(row["src"]), int(row["dst"]))] = float(
                row.get("sum", 0.0))
        except (KeyError, TypeError, ValueError):
            continue

    def link_rows():
        out = []
        for (src, dst), agg in sorted(link_gates.items(),
                                      key=lambda kv: -kv[1]["cost_s"]):
            row = {"src": src, "dst": dst, "rounds": agg["rounds"],
                   "cost_s": round(agg["cost_s"], 6)}
            if (src, dst) in stream_wait:
                row["streamed_wait_s"] = round(stream_wait[(src, dst)], 6)
            out.append(row)
        return out

    rank_rows = [{"rank": r, "rounds": agg["rounds"],
                  "cost_s": round(agg["cost_s"], 6)}
                 for r, agg in sorted(rank_gates.items(),
                                      key=lambda kv: -kv[1]["cost_s"])]
    breakdown.sort(key=lambda e: -e["latency_s"])
    waves = [{"start_s": round(s, 6), "end_s": round(e, 6),
              "cost_s": round(e - s, 6)} for s, e in windows]
    return {
        "schema": CRITICAL_SCHEMA,
        "margin_s": margin_sec,
        "clock_max_err_s": round(err, 6),
        "rounds_total": len(arrivals),
        "rounds_analyzed": len(rounds),
        "rounds_recovery_affected": affected,
        "rounds_by_gate": by_class,
        "base_drain_s": round(base_drain, 6),
        "latency_total_s": round(sum(r["latency"] for r in rounds), 6),
        "entry_skew_total_s": round(sum(r["entry_skew"] for r in rounds), 6),
        "top_gating_ranks": rank_rows[:max(top_k, 0)],
        "top_gating_links": link_rows()[:max(top_k, 0)],
        "worst_rounds": breakdown[:max(top_k, 0)],
        "recovery_waves": waves,
        "recovery_cost_s": round(sum(w["cost_s"] for w in waves), 6),
    }


def fold_critical_path(obs_dir: str, report: dict,
                       job_key: str = "") -> str | None:
    """Write the report back into the (job's) telemetry file under
    ``critical_path`` and stamp a ``critical_path_folded`` event into its
    event log (atomic rewrite, mirroring ``trace.fold_into_telemetry``).
    Returns the path, or None when there is no telemetry file."""
    path = os.path.join(obs_dir, telemetry_name(job_key))
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as exc:
        raise TraceError(f"cannot fold critical path into "
                         f"{os.path.basename(path)}: {exc!r}") from exc
    doc["critical_path"] = report
    events = doc.setdefault("events", [])
    if isinstance(events, list):
        events.append({"ts": time.time(), "kind": "critical_path_folded",
                       "rounds": report.get("rounds_analyzed", 0),
                       "links": len(report.get("top_gating_links", ())),
                       "ranks": len(report.get("top_gating_ranks", ()))})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path
