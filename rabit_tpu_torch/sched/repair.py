"""Degraded-link flagging: telemetry in, the planner's avoid set out.

The port's own copy of ``rabit_tpu/sched/repair.py``.  The planner
(:mod:`rabit_tpu_torch.sched.planner`) routes around whatever links it is
told to avoid; this module decides what to avoid, from two surfaces:

* **worker reports**: an ``ElasticWorker`` that waits on its incoming ring
  link past ``slow_report_share`` of its epoch prints a ``slow_link src=A
  dst=B ...`` line, which the tracker's stats-line bridge turns into a
  ``link_degraded`` event.  The delayed frame cascades downstream, but the
  slow link's dst waits on every one of the W - 1 delayed hops, so a
  worker's report of its own incoming link is the right attribution;
* **offline straggler analytics**: ``obs.trace.straggler_report``'s
  per-rank lateness shares: the top straggler's incoming ring link is the
  prime suspect when its share dominates.

Both give ``(src_rank, dst_rank)`` pairs.  Ranks mean something only
within one epoch, so the tracker keeps flags as task-id pairs and turns
them back into rank pairs under each new epoch's rank map: a shrink or
grow between flag and repair cannot aim the avoid set at the wrong worker.
"""

from __future__ import annotations

from typing import Iterable, Mapping


def links_from_events(events: Iterable[Mapping],
                      min_reports: int = 1) -> set[tuple[int, int]]:
    """Degraded ``(src, dst)`` rank pairs from ``link_degraded`` events
    (tracker event dicts or anything mapping-shaped with ``kind``/
    ``src``/``dst``).  ``min_reports`` requires repeated evidence before
    a link is flagged (1 = first report wins — the chaos default)."""
    counts: dict[tuple[int, int], int] = {}
    for ev in events:
        if ev.get("kind") != "link_degraded":
            continue
        try:
            src, dst = int(ev["src"]), int(ev["dst"])
        except (KeyError, TypeError, ValueError):
            continue
        if src == dst or src < 0 or dst < 0:
            continue
        counts[(src, dst)] = counts.get((src, dst), 0) + 1
    return {link for link, n in counts.items() if n >= max(min_reports, 1)}


def links_from_stragglers(report: Mapping,
                          ring_order: Iterable[int],
                          wait_share: float = 0.5) -> set[tuple[int, int]]:
    """Degraded links implied by a straggler report
    (:func:`rabit_tpu_torch.obs.trace.straggler_report`): for each rank whose
    lateness share exceeds ``wait_share``, flag its INCOMING ring link
    under ``ring_order`` — the link whose slowness makes that rank enter
    every collective last."""
    order = [int(r) for r in ring_order]
    if len(order) < 2:
        return set()
    pos = {r: i for i, r in enumerate(order)}
    flagged: set[tuple[int, int]] = set()
    per_rank = report.get("per_rank") or {}
    for rank_s, stats in per_rank.items():
        try:
            rank = int(rank_s)
            share = float(stats.get("lateness_share", 0.0))
        except (TypeError, ValueError):
            continue
        if rank in pos and share >= wait_share:
            prev = order[(pos[rank] - 1) % len(order)]
            flagged.add((prev, rank))
    return flagged


def flags_to_tasks(links: Iterable[tuple[int, int]],
                   rank_map: Mapping[str, int]) -> set[tuple[str, str]]:
    """Rank pairs -> task-id pairs under one epoch's rank map (flags
    survive resizes as task pairs; pairs whose rank left the map drop)."""
    by_rank = {r: t for t, r in rank_map.items()}
    out: set[tuple[str, str]] = set()
    for src, dst in links:
        if src in by_rank and dst in by_rank:
            out.add((by_rank[src], by_rank[dst]))
    return out


def tasks_to_flags(task_links: Iterable[tuple[str, str]],
                   rank_map: Mapping[str, int]) -> set[tuple[int, int]]:
    """Task-id pairs -> rank pairs under a (possibly different) epoch's
    rank map; pairs with a departed task silently drop — a dead worker's
    links no longer exist to avoid."""
    out: set[tuple[int, int]] = set()
    for src_t, dst_t in task_links:
        if src_t in rank_map and dst_t in rank_map:
            out.add((rank_map[src_t], rank_map[dst_t]))
    return out
