"""rabit-top: a live job, rank and link view over the ``CMD_OBS`` scrape.

The port's own copy of ``rabit_tpu/obs/top.py``: a curses-free poller
(``python -m rabit_tpu_torch.obs.top HOST:PORT``).  Every ``--interval``
seconds it takes one ``CMD_OBS`` scrape, compares it with the previous
poll, and prints one plain-text frame:

* the header: uptime, the serving counters, the open incidents;
* a row a job: epoch, world, leases, pending check-ins, restarts, and the
  poll-to-poll rates (delta folds and wire bytes a second, by codec);
* the straggler watch: ranks by their share of the cumulative link wait;
* the link health: the per-planned-link wait table (src -> dst, p50/p99).

Nothing here talks to a worker: one RPC to the tracker, which answers from
its rollups.  ``--json`` prints the raw scrape document once a poll;
``--once`` polls once.  Either package's ``top`` reads either package's
tracker (the documents share ``rabit_tpu``'s schema).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from rabit_tpu_torch.obs import stream as obs_stream
from rabit_tpu_torch.tracker import protocol as P


def scrape(host: str, port: int, task_id: str = "obs", job: str = "",
           registry: bool = False, timeout: float = 5.0) -> dict:
    """One ``CMD_OBS`` round trip: the tracker's whole view.  ``job`` (a
    multi-job service's partition) is refused: job keys are not ported
    (ROADMAP.md Queue 1 item 10g)."""
    if job:
        raise NotImplementedError(
            "scrape(job=) is not ported yet (ROADMAP.md Queue 1 item 10g)")
    doc = P.tracker_rpc(host, port, P.CMD_OBS, task_id,
                        message=json.dumps({"registry": bool(registry)}),
                        timeout=timeout, retries=1)
    if not isinstance(doc, dict):
        raise P.TrackerUnreachable(f"CMD_OBS returned {doc!r}, not a scrape")
    return doc


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TiB"


def _fmt_age(sec: float) -> str:
    sec = max(sec, 0.0)
    if sec < 90:
        return f"{sec:.0f}s"
    if sec < 5400:
        return f"{sec / 60:.1f}m"
    return f"{sec / 3600:.1f}h"


def _job_rows(doc: dict) -> list[tuple[str, str, dict]]:
    """Flatten a scrape into (tenant, job_key, job_state) rows — the
    service exposition nests jobs under tenants; the base tracker has a
    single anonymous tenant."""
    tenants = doc.get("tenants")
    if isinstance(tenants, dict) and tenants:
        return [(tenant, key, jstate)
                for tenant, tdoc in sorted(tenants.items())
                for key, jstate in sorted(tdoc.get("jobs", {}).items())]
    return [("-", key, jstate)
            for key, jstate in sorted(doc.get("jobs", {}).items())]


def _wire_total(jstate: dict) -> int:
    split = obs_stream.wire_bytes_by_codec(
        jstate.get("stream", {}).get("total", {}))
    return sum(split.values())


def _straggler_rows(jstate: dict, top: int = 4) -> list[dict]:
    """Ranks ordered by cumulative link-wait share (from the per-rank
    ``link_wait_seconds{...}`` histogram sums in the rollup)."""
    per_rank = jstate.get("stream", {}).get("per_rank", {})
    waits: dict[str, float] = {}
    for rank, state in per_rank.items():
        total = 0.0
        for name, h in state.get("histograms", {}).items():
            base, _labels = obs_stream.parse_series(name)
            if base == "link_wait_seconds":
                total += float(h.get("sum", 0.0))
        if total > 0:
            waits[rank] = total
    whole = sum(waits.values())
    rows = [{"rank": r, "wait_s": w,
             "share": (w / whole) if whole > 0 else 0.0}
            for r, w in sorted(waits.items(), key=lambda kv: -kv[1])]
    return rows[:top]


def render(doc: dict, prev: dict | None = None, top_links: int = 6) -> str:
    """One plain-text frame from a scrape document (+ the previous poll
    for cadence).  Pure function of its inputs — the unit under test."""
    now = float(doc.get("ts", 0.0))
    dt = (now - float(prev.get("ts", now))) if prev else 0.0
    serving = doc.get("serving", {})
    lines = [
        f"rabit-top  schema={doc.get('schema')}  "
        f"up {_fmt_age(now - float(doc.get('started_at', now)))}  "
        f"reactor={'on' if serving.get('reactor') else 'off'}  "
        f"accepts={serving.get('accepts', 0)}  rpcs={serving.get('rpcs', 0)}  "
        f"scrapes={serving.get('obs_scrapes', 0)}"
    ]
    svc = doc.get("service")
    if isinstance(svc, dict):
        lines.append(
            f"service: live={svc.get('live')} admitted={svc.get('admitted')} "
            f"completed={svc.get('completed')} "
            f"pool_parked={svc.get('pool_parked')} "
            f"auto_world={svc.get('auto_world')}")
    # incidents pane (the diagnosis plane): every open
    # incident across the jobs, newest-evidence fields inline
    incidents = doc.get("incidents")
    if isinstance(incidents, dict) and incidents.get("open"):
        lines.append(f"incidents: {incidents.get('n_open', 0)} open")
        for inc in incidents["open"]:
            subject = " ".join(f"{k}={v}" for k, v in
                               sorted((inc.get("subject") or {}).items()))
            lines.append(f"  [{inc.get('class')}] {inc.get('id')} "
                         f"job={inc.get('job') or '-'} {subject} "
                         f"({inc.get('windows', 0)}w)")

    prev_jobs = {key: j for _t, key, j in _job_rows(prev)} if prev else {}
    lines.append(f"{'tenant':<10} {'job':<12} {'ep':>3} {'world':>5} "
                 f"{'lease':>5} {'pend':>4} {'rst':>3} {'folds/s':>8} "
                 f"{'wire/s':>10} {'wire total':>11}")
    for tenant, key, jstate in _job_rows(doc):
        stream = jstate.get("stream", {})
        wire = _wire_total(jstate)
        folds = int(stream.get("n_folds", 0))
        rate = folds_s = 0.0
        if dt > 0 and key in prev_jobs:
            pstream = prev_jobs[key].get("stream", {})
            rate = max(wire - _wire_total(prev_jobs[key]), 0) / dt
            folds_s = max(folds - int(pstream.get("n_folds", 0)), 0) / dt
        lines.append(
            f"{tenant:<10.10} {(key or '-'): <12.12} "
            f"{jstate.get('epoch', 0):>3} {jstate.get('world', 0):>5} "
            f"{jstate.get('leases', 0):>5} {jstate.get('pending', 0):>4} "
            f"{jstate.get('restarts', 0):>3} {folds_s:>8.2f} "
            f"{_fmt_bytes(rate) + '/s':>10} {_fmt_bytes(wire):>11}")
        split = obs_stream.wire_bytes_by_codec(stream.get("total", {}))
        if split:
            per = "  ".join(f"{c}={_fmt_bytes(b)}"
                            for c, b in sorted(split.items()))
            lines.append(f"{'':<10} {'':<12} codecs: {per}")
        # delivery pane (rabit_tpu's delivery plane): the published version line and
        # the content-addressed store behind it, when the job has one
        delivery = jstate.get("delivery")
        if isinstance(delivery, dict) and (delivery.get("line")
                                           or delivery.get("subscribers")):
            dline = delivery.get("line") or {}
            lines.append(
                f"{'':<10} {'':<12} delivery: "
                f"v{dline.get('version', 0)} "
                f"digest={str(dline.get('digest', ''))[:12] or '-'} "
                f"size={_fmt_bytes(float(dline.get('size', 0)))} "
                f"snaps={delivery.get('snaps', 0)}"
                f"({_fmt_bytes(float(delivery.get('snap_bytes', 0)))}) "
                f"subs={delivery.get('subscribers', 0)}")
        stragglers = _straggler_rows(jstate)
        if stragglers:
            per = "  ".join(
                f"r{s['rank']}={s['wait_s'] * 1e3:.0f}ms"
                f"({s['share'] * 100:.0f}%)" for s in stragglers)
            lines.append(f"{'':<10} {'':<12} straggler-watch: {per}")
        links = stream.get("links", [])
        for row in sorted(links, key=lambda r: -float(r.get("p99", 0.0))
                          )[:top_links]:
            lines.append(
                f"{'':<10} {'':<12} link {row.get('src')}->{row.get('dst')}: "
                f"n={row.get('count', 0)} "
                f"p50={float(row.get('p50', 0.0)) * 1e3:.2f}ms "
                f"p99={float(row.get('p99', 0.0)) * 1e3:.2f}ms")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rabit_tpu_torch.obs.top",
        description="poll a live tracker's CMD_OBS scrape and render a "
                    "top-style job/rank/link view")
    ap.add_argument("addr", metavar="HOST:PORT",
                    help="tracker (or service) control address")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--task-id", default="obs",
                    help="scrape identity shown in the tracker's obs_scrape event")
    ap.add_argument("--once", action="store_true", help="one poll, no loop")
    ap.add_argument("--rounds", type=int, default=None,
                    help="stop after N polls (default: until ^C)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw scrape JSON per poll (no rendering)")
    ap.add_argument("--registry", action="store_true",
                    help="include the full metrics registry in the scrape")
    args = ap.parse_args(argv)
    host, _, port_s = args.addr.rpartition(":")
    if not host:
        ap.error(f"addr wants HOST:PORT, got {args.addr!r}")

    prev: dict | None = None
    polls = 0
    clear = sys.stdout.isatty() and not args.json
    try:
        while True:
            t0 = time.perf_counter()
            doc = scrape(host, int(port_s), task_id=args.task_id,
                         registry=args.registry)
            rtt_ms = (time.perf_counter() - t0) * 1e3
            polls += 1
            if doc.get("schema") != obs_stream.STREAM_SCHEMA:
                # the exposition schema is the contract downstream
                # pollers gate on — refuse to mis-render a foreign one
                # (--json consumers read the stamp from the doc itself)
                print(f"unsupported scrape schema {doc.get('schema')!r} "
                      f"(want {obs_stream.STREAM_SCHEMA})", file=sys.stderr)
                return 3
            if args.json:
                print(json.dumps(doc, sort_keys=True), flush=True)
            else:
                frame = render(doc, prev)
                if clear:
                    sys.stdout.write("\x1b[2J\x1b[H")
                print(f"{frame}\n[poll {polls}, rtt {rtt_ms:.1f}ms]",
                      flush=True)
            prev = doc
            if args.once or (args.rounds is not None
                             and polls >= args.rounds):
                return 0
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return 0
    except P.TrackerUnreachable as exc:
        print(f"scrape failed: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
