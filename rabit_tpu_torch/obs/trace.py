"""Cross-rank collective tracing: one job-wide timeline from the ranks'
flight dumps.

The port's own copy of ``rabit_tpu/obs/trace.py``.  Three pieces:

* **clock alignment**: :class:`ClockSync` keeps the best NTP-style offset
  estimate of this worker's clock against the tracker's from every
  timestamped metrics and heartbeat reply; it rides in each shipped
  snapshot, so telemetry.json's ``clocks`` can project each rank's
  ``time.time()`` stamps onto the tracker's timeline with a known error;
* **merge and export**: :func:`load_job` joins every ``flight-*.jsonl`` of
  an obs dir with ``telemetry.json``; :func:`build_chrome_trace` emits
  Chrome/Perfetto ``trace_event`` JSON (a track a rank with collective and
  bootstrap spans, a tracker track with recovery-wave spans and the
  control plane's instants), which :func:`validate_chrome_trace` checks;
* **straggler analytics**: :func:`straggler_report` computes each
  collective's arrival skew (first enter to last enter), each rank's
  lateness and wait, and a top-K table.  Collectives whose window
  overlaps a recovery wave are tallied apart, so restart latency does not
  pass for a straggler.

Collectives are identified across ranks by ``(version, seqno)``: ``obs.
collective`` stamps each ``op_begin`` / ``op_end`` with the checkpoint
version and a sequence number that restarts at every version change, so a
restarted worker numbers its collectives where the survivors' replay
serves them.  The documents are ``rabit_tpu``'s byte for byte (its
generator string included), so either package reads what the other wrote.

CLI: ``tools/torch_trace_tool.py export|report|diagnose|validate``.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from dataclasses import dataclass, field

from rabit_tpu_torch.obs.events import Event, load_dump

#: pid of the tracker's track in the exported trace (rank pids are the small
#: non-negative ranks; this one sorts last and collides with no rank).
TRACKER_PID = 1_000_000

#: Recovery windows widen by this much when collectives are classified, so
#: a begin stamped just outside the window (clock error, scan cadence) is
#: still the recovery's, not a straggler's.
RECOVERY_MARGIN_SEC = 0.25

_DUMP_RE = re.compile(
    r"flight-rank(?P<rank>-?\d+)-pid(?P<pid>\d+)(?:-n(?P<seq>\d+))?"
    r"-(?P<reason>[A-Za-z_]+)\.jsonl$"
)


class TraceError(RuntimeError):
    """A dump or telemetry file could not be merged (malformed JSON, no
    usable header...).  An empty obs dir is not an error: it merges to an
    empty trace."""


# -- clock alignment ---------------------------------------------------------

class ClockSync:
    """NTP-style offset estimator for one worker against the tracker clock.

    Each timestamped tracker RPC yields ``offset = server_ts - midpoint``
    with error bound ``rtt / 2``; the estimator keeps the lowest-error
    sample (late samples win ties, so a long-running worker tracks drift
    at equal quality).  ``offset`` maps this process's ``time.time()``
    onto the tracker's: ``tracker_ts = worker_ts + offset``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._offset = 0.0
        self._err = math.inf
        self._samples = 0

    def update(self, offset: float, err: float) -> None:
        with self._lock:
            self._samples += 1
            if err <= self._err:
                self._offset, self._err = float(offset), float(err)

    def reset(self) -> None:
        with self._lock:
            self._offset, self._err, self._samples = 0.0, math.inf, 0

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def estimate(self) -> tuple[float, float] | None:
        """(offset_s, err_s), or None before the first sample."""
        with self._lock:
            if self._samples == 0:
                return None
            return self._offset, self._err

    def snapshot(self) -> dict | None:
        """JSON-able record shipped inside metric snapshots."""
        est = self.estimate()
        if est is None:
            return None
        return {"offset_s": round(est[0], 6), "err_s": round(est[1], 6),
                "samples": self.samples}


#: Process-wide clock estimate against this job's tracker (updated by
#: ``obs.ship`` on every timestamped RPC; shipped in snapshots).
GLOBAL_CLOCK = ClockSync()


# -- job loading -------------------------------------------------------------

@dataclass
class JobTrace:
    """Everything known about one job: per-rank merged event streams (each
    sorted by ts, exact duplicates across overlapping dumps removed),
    the tracker's telemetry document, and per-rank clock offsets."""

    ranks: dict[int, list[Event]] = field(default_factory=dict)
    telemetry: dict | None = None
    #: rank -> {"offset_s", "err_s", "samples"}
    clocks: dict[int, dict] = field(default_factory=dict)
    dump_paths: list[str] = field(default_factory=list)

    def offset(self, rank: int) -> float:
        return self.clocks.get(rank, {}).get("offset_s", 0.0)

    def max_clock_err(self) -> float:
        errs = [c.get("err_s", 0.0) for c in self.clocks.values()]
        return max(errs) if errs else 0.0

    def project(self, rank: int, ts: float) -> float:
        """Worker-clock ts -> tracker-clock ts."""
        return ts + self.offset(rank)


def parse_dump_name(path: str) -> dict | None:
    """rank/pid/dump-seq/reason from a flight dump filename (the header
    line is authoritative; this is the fallback for truncated dumps)."""
    m = _DUMP_RE.search(os.path.basename(path))
    if m is None:
        return None
    return {"rank": int(m.group("rank")), "pid": int(m.group("pid")),
            "dump_seq": int(m.group("seq") or 0),
            "reason": m.group("reason")}


def discover_dumps(obs_dir: str) -> list[str]:
    try:
        names = sorted(os.listdir(obs_dir))
    except OSError:
        return []
    return [os.path.join(obs_dir, n) for n in names
            if n.startswith("flight-") and n.endswith(".jsonl")]


def telemetry_name(job_key: str = "") -> str:
    """The telemetry filename for one job of a shared obs dir:
    ``telemetry-<job>.json`` under ``rabit_tpu``'s multi-job service, the
    bare name for a single job (the port's tracker writes that one)."""
    return f"telemetry-{job_key}.json" if job_key else "telemetry.json"


_TELE_RE = re.compile(r"^telemetry-(?P<job>.+)\.json$")


def discover_telemetry_jobs(obs_dir: str) -> list[str]:
    """The job keys whose per-job telemetry files exist under a shared
    multi-tenant obs dir (``telemetry-<job>.json``), sorted.  The bare
    legacy ``telemetry.json`` is NOT a job — callers check it first."""
    try:
        names = sorted(os.listdir(obs_dir))
    except OSError:
        return []
    out = []
    for name in names:
        m = _TELE_RE.match(name)
        if m:
            out.append(m.group("job"))
    return out


def load_job(obs_dir: str, job_key: str = "",
             tolerant: bool = False) -> JobTrace:
    """Join every flight dump + telemetry.json under ``obs_dir``.
    ``job_key`` selects one job's telemetry file of a shared multi-job
    obs dir (:func:`telemetry_name`).

    Multiple dumps per rank (several lives, or hang-then-exit in one life)
    are merged: events are pooled, exact duplicates (same ts/kind/fields —
    the overlap between a hang dump and the later exit dump of the same
    ring) removed, and the stream re-sorted by ts.  Raises
    :class:`TraceError` on malformed inputs; an empty dir is fine.

    ``tolerant=True`` skips unreadable inputs instead of raising — the
    follow-mode contract, where a spill dump may be mid-write or freshly
    evicted (rabit_obs_max_files) when the exporter lists the dir."""
    job = JobTrace()
    pools: dict[int, dict[str, Event]] = {}
    for path in discover_dumps(obs_dir):
        try:
            events = load_dump(path)
        except (OSError, ValueError, KeyError) as exc:
            if tolerant:
                continue
            raise TraceError(f"unreadable flight dump {path}: {exc!r}") from exc
        rank = None
        if events and events[0].kind == "flight_dump":
            rank = events[0].fields.get("rank")
            events = events[1:]
        if rank is None:
            ident = parse_dump_name(path)
            if ident is None:
                if tolerant:
                    continue
                raise TraceError(f"flight dump {path} has neither a header "
                                 f"rank nor a parseable filename")
            rank = ident["rank"]
        rank = int(rank)
        pool = pools.setdefault(rank, {})
        for ev in events:
            key = f"{ev.ts:.6f}|{ev.kind}|" + json.dumps(ev.fields,
                                                         sort_keys=True)
            pool.setdefault(key, ev)
        job.dump_paths.append(path)
    for rank, pool in pools.items():
        job.ranks[rank] = sorted(pool.values(), key=lambda e: e.ts)

    tele_path = os.path.join(obs_dir, telemetry_name(job_key))
    if os.path.exists(tele_path):
        try:
            with open(tele_path) as f:
                job.telemetry = json.load(f)
        except (OSError, ValueError) as exc:
            if tolerant:
                return job
            raise TraceError(f"unreadable {os.path.basename(tele_path)}: "
                             f"{exc!r}") from exc
        clocks = dict(job.telemetry.get("clocks") or {})
        for r, snap in (job.telemetry.get("ranks") or {}).items():
            if isinstance(snap, dict) and snap.get("clock"):
                clocks.setdefault(r, snap["clock"])
        for r, clock in clocks.items():
            try:
                job.clocks[int(r)] = dict(clock)
            except (TypeError, ValueError):
                continue
    return job


# -- span pairing ------------------------------------------------------------

@dataclass
class OpSpan:
    op: str
    version: int | None
    seqno: int | None
    begin: float              # worker clock
    end: float | None = None  # None: still in flight at dump time
    nbytes: int = 0
    cache_key: str | None = None
    # engine/fused.py ran this op as one fused in-graph device collective
    # (the op_begin/op_end events carry fused=1); host-path ops stay False
    fused: bool = False

    @property
    def keyed(self) -> bool:
        return self.version is not None and self.seqno is not None

    @property
    def key(self) -> tuple:
        return (self.version, self.seqno, self.op)


def pair_ops(events: list[Event]) -> list[OpSpan]:
    """Match one rank's op_begin/op_end stream into spans.  Seqno-stamped
    events pair by (version, seqno, op); legacy events (pre-seqno dumps)
    fall back to per-op FIFO order.  A begin without an end (the op in
    flight when the dump was written) yields an open span."""
    spans: list[OpSpan] = []
    open_keyed: dict[tuple, OpSpan] = {}
    open_fifo: dict[str, list[OpSpan]] = {}
    for ev in events:
        if ev.kind == "op_begin":
            span = OpSpan(
                op=str(ev.fields.get("op", "?")),
                version=ev.fields.get("version"),
                seqno=ev.fields.get("seqno"),
                begin=ev.ts,
                nbytes=int(ev.fields.get("nbytes") or 0),
                cache_key=ev.fields.get("cache_key"),
                fused=bool(ev.fields.get("fused")),
            )
            spans.append(span)
            if span.keyed:
                open_keyed[span.key] = span
            else:
                open_fifo.setdefault(span.op, []).append(span)
        elif ev.kind == "op_end":
            op = str(ev.fields.get("op", "?"))
            version, seqno = ev.fields.get("version"), ev.fields.get("seqno")
            span = None
            if version is not None and seqno is not None:
                span = open_keyed.pop((version, seqno, op), None)
            elif open_fifo.get(op):
                span = open_fifo[op].pop(0)
            if span is not None:
                span.end = ev.ts
                span.nbytes = int(ev.fields.get("nbytes") or span.nbytes)
    return spans


# -- Chrome/Perfetto export --------------------------------------------------

def _us(ts: float, t_base: float) -> float:
    return round((ts - t_base) * 1e6, 3)


def _instant(name: str, ts_us: float, pid: int, scope: str = "t",
             args: dict | None = None) -> dict:
    ev = {"name": name, "cat": "rabit", "ph": "i", "ts": ts_us,
          "pid": pid, "tid": 0, "s": scope}
    if args:
        ev["args"] = args
    return ev


#: Worker-side event kinds rendered as instants on the rank's track (the
#: op_begin/op_end pairs become spans instead and are excluded here).
_RANK_INSTANTS = {
    "hang_detected", "hang_recovered", "hang_abort", "op_inflight",
    "engine_error", "checkpoint_commit", "load_checkpoint",
    "checkpoint_loaded", "version_bump", "init_after_exception",
    "engine_finalize", "engine_shutdown", "engine_ready",
    "epoch_changed", "shard_rebalanced", "obs_evicted",
}

#: Tracker-side event kinds rendered as instants on the tracker track —
#: including the world-epoch boundaries of an elastic job (spare
#: promotions, shrinks, grows), so a Perfetto timeline shows resizes
#: alongside the recovery waves that caused them.
_TRACKER_INSTANTS = {
    "lease_expired", "wave_purged", "failure_detected", "recover_stats",
    "recover_stats_final", "snapshot_rejected", "worker_recovered",
    "disk_resume", "metrics_snapshot",
    "spare_parked", "spare_dropped", "spare_promoted",
    "world_shrunk", "world_grown", "bootstrap_blob",
    "schedule_planned", "schedule_repaired", "link_degraded",
    "quorum_met", "contribution_late", "correction_folded",
    "correction_dropped",
    "relay_up", "relay_lost", "batch_folded", "messages_dropped",
    "journal_snapshot", "journal_gap", "standby_synced",
    "tracker_failover",
    "job_admitted", "admission_refused", "worker_leased",
    "job_completed",
    "obs_scrape", "metrics_delta_folded",
    "incident_opened", "incident_resolved", "critical_path_folded",
    "snapshot_published", "snapshot_fetched", "blob_cache_evicted",
}


def recovery_windows(job: JobTrace) -> list[tuple[float, float]]:
    """(start, end) tracker-clock windows of each recovery wave: end is the
    wave's assignment broadcast; start is the latest preceding failure
    evidence (failure_detected / lease_expired / wave_purged), or the wave
    instant itself when none was recorded."""
    if not job.telemetry:
        return []
    events = job.telemetry.get("events") or []
    failures = sorted(e["ts"] for e in events
                      if e.get("kind") in ("failure_detected",
                                           "lease_expired", "wave_purged"))
    windows = []
    for w in (job.telemetry.get("waves") or []):
        if w.get("epoch", 0) <= 0:
            continue
        end = float(w["ts"])
        start = end
        for ts in failures:
            if ts < end:
                start = min(start, ts) if start != end else ts
            else:
                break
        # keep only evidence reasonably tied to THIS wave
        preceding = [ts for ts in failures if ts < end]
        start = preceding[-1] if preceding else end
        windows.append((min(start, end), end))
    return windows


def build_chrome_trace(job: JobTrace) -> dict:
    """One Chrome ``trace_event`` document: a track per rank (collective +
    bootstrap spans, lifecycle instants, all clock-projected onto the
    tracker timeline) plus a tracker track (wave spans, lease expiries,
    converted engine stats events)."""
    all_ts: list[float] = []
    for rank, events in job.ranks.items():
        all_ts.extend(job.project(rank, e.ts) for e in events)
    if job.telemetry:
        all_ts.extend(float(e["ts"]) for e in
                      (job.telemetry.get("events") or []) if "ts" in e)
        if job.telemetry.get("started_at"):
            all_ts.append(float(job.telemetry["started_at"]))
    t_base = min(all_ts) if all_ts else 0.0

    out: list[dict] = []
    for rank in sorted(job.ranks):
        out.append({"name": "process_name", "ph": "M", "ts": 0.0,
                    "pid": rank, "tid": 0,
                    "args": {"name": f"rank {rank}"}})
        out.append({"name": "process_sort_index", "ph": "M", "ts": 0.0,
                    "pid": rank, "tid": 0, "args": {"sort_index": rank}})

    unpaired = 0
    for rank, events in sorted(job.ranks.items()):
        off = job.offset(rank)
        for span in pair_ops(events):
            if span.end is None:
                unpaired += 1
                continue
            args = {"nbytes": span.nbytes, "rank": rank}
            if span.keyed:
                args.update(version=span.version, seqno=span.seqno)
            if span.cache_key:
                args["cache_key"] = span.cache_key
            if span.fused:
                args["fused"] = 1
            out.append({
                "name": span.op, "cat": "collective", "ph": "X",
                "ts": _us(span.begin + off, t_base),
                "dur": round(max(span.end - span.begin, 0.0) * 1e6, 3),
                "pid": rank, "tid": 0, "args": args,
            })
        # bootstrap spans: engine_init -> bootstrap_done, sequential per life
        init_ts: float | None = None
        for ev in events:
            if ev.kind == "engine_init":
                init_ts = ev.ts
            elif ev.kind == "bootstrap_done" and init_ts is not None:
                out.append({
                    "name": "bootstrap", "cat": "lifecycle", "ph": "X",
                    "ts": _us(init_ts + off, t_base),
                    "dur": round(max(ev.ts - init_ts, 0.0) * 1e6, 3),
                    "pid": rank, "tid": 0,
                    "args": {k: v for k, v in ev.fields.items()
                             if k != "engine"},
                })
                init_ts = None
            elif ev.kind in _RANK_INSTANTS:
                out.append(_instant(ev.kind, _us(ev.ts + off, t_base), rank,
                                    args=dict(ev.fields)))

    if job.telemetry:
        out.append({"name": "process_name", "ph": "M", "ts": 0.0,
                    "pid": TRACKER_PID, "tid": 0,
                    "args": {"name": "tracker"}})
        out.append({"name": "process_sort_index", "ph": "M", "ts": 0.0,
                    "pid": TRACKER_PID, "tid": 0,
                    "args": {"sort_index": TRACKER_PID}})
        for start, end in recovery_windows(job):
            out.append({
                "name": "recovery wave", "cat": "recovery", "ph": "X",
                "ts": _us(start, t_base),
                "dur": round(max(end - start, 0.0) * 1e6, 3),
                "pid": TRACKER_PID, "tid": 0, "args": {},
            })
        for ev in (job.telemetry.get("events") or []):
            kind, ts = ev.get("kind"), ev.get("ts")
            if ts is None:
                continue
            if kind == "wave":
                out.append(_instant(
                    f"wave {ev.get('epoch')}", _us(float(ts), t_base),
                    TRACKER_PID, scope="p",
                    args={k: v for k, v in ev.items()
                          if k not in ("ts", "kind")}))
            elif kind in _TRACKER_INSTANTS:
                out.append(_instant(
                    kind, _us(float(ts), t_base), TRACKER_PID, scope="p",
                    args={k: v for k, v in ev.items()
                          if k not in ("ts", "kind")}))

    out.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "t_base_epoch_s": round(t_base, 6),
            "ranks": sorted(job.ranks),
            "dumps_merged": len(job.dump_paths),
            "spans_inflight_at_dump": unpaired,
            "clock_max_err_s": round(job.max_clock_err(), 6),
            # rabit_tpu's stamp: the two packages' documents compare equal
            "generator": "rabit_tpu tools/trace_tool.py",
        },
    }


#: Phase types this exporter emits; the validator is deliberately strict —
#: a new phase type must be added here AND given rules below.
_ALLOWED_PH = {"X", "i", "M"}


def validate_chrome_trace(doc: object) -> list[str]:
    """Structural check against the Chrome ``trace_event`` format (the
    subset this exporter emits).  Returns a list of problems — empty means
    the document loads in ui.perfetto.dev / chrome://tracing."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errs.append(f"{where}: {key} must be an int")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            errs.append(f"{where}: ts must be a number")
        elif ph != "M" and ts < 0:
            errs.append(f"{where}: negative ts {ts}")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float)) or isinstance(dur, bool)
                    or dur < 0):
                errs.append(f"{where}: X event needs dur >= 0")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            errs.append(f"{where}: instant scope must be t|p|g")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"{where}: args must be an object")
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as exc:
        errs.append(f"document is not JSON-serializable: {exc!r}")
    return errs


# -- straggler analytics -----------------------------------------------------

def collective_arrivals(job: JobTrace) -> dict[tuple, dict[int, OpSpan]]:
    """(version, seqno, op) -> {rank: span} with clock-projected begin/end
    (spans are rewritten onto the tracker timeline in place of the worker
    clock).  Only seqno-stamped spans participate — legacy dumps have no
    cross-rank identity."""
    table: dict[tuple, dict[int, OpSpan]] = {}
    for rank, events in job.ranks.items():
        off = job.offset(rank)
        for span in pair_ops(events):
            if not span.keyed:
                continue
            span.begin += off
            if span.end is not None:
                span.end += off
            table.setdefault(span.key, {})[rank] = span
    return table


def straggler_report(job: JobTrace, top_k: int = 3) -> dict:
    """Per-seqno arrival-skew analytics.

    For every collective observed by >= 2 ranks: ``skew`` is last-enter
    minus first-enter; each rank's ``lateness`` is its own enter minus the
    first enter (the straggler's signature), and its ``wait`` is the last
    enter minus its own (the cost stragglers impose on it).  Collectives
    whose [first-begin, last-end] window intersects a recovery wave are
    tallied separately (``collectives_recovery_affected``) so restart
    latency doesn't crown a restarted rank as the straggler."""
    arrivals = collective_arrivals(job)
    windows = recovery_windows(job)
    margin = RECOVERY_MARGIN_SEC + job.max_clock_err()

    def recovery_affected(begins: list[float], ends: list[float]) -> bool:
        lo = min(begins) - margin
        hi = max(ends if ends else begins) + margin
        return any(s <= hi and e >= lo for s, e in windows)

    per_rank: dict[int, dict] = {
        r: {"arrivals": 0, "last_arriver_count": 0,
            "lateness_total_s": 0.0, "wait_total_s": 0.0}
        for r in job.ranks
    }
    analyzed = affected = 0
    worst: list[dict] = []
    for key in sorted(arrivals, key=lambda k: (k[0] or 0, k[1] or 0)):
        ranks = arrivals[key]
        if len(ranks) < 2:
            continue
        begins = [s.begin for s in ranks.values()]
        ends = [s.end for s in ranks.values() if s.end is not None]
        if recovery_affected(begins, ends):
            affected += 1
            continue
        analyzed += 1
        first, last = min(begins), max(begins)
        last_rank = max(ranks, key=lambda r: ranks[r].begin)
        version, seqno, op = key
        entry = {"op": op, "version": version, "seqno": seqno,
                 "skew_s": round(last - first, 6),
                 "first_enter_s": round(first, 6),
                 "last_enter_s": round(last, 6),
                 "last_rank": last_rank}
        if any(s.fused for s in ranks.values()):
            # fused-path skew is device-graph scheduling, not host encode
            # latency — keep the two data planes separable in the report
            entry["fused"] = 1
        worst.append(entry)
        for rank, span in ranks.items():
            stats = per_rank[rank]
            stats["arrivals"] += 1
            stats["lateness_total_s"] += span.begin - first
            stats["wait_total_s"] += last - span.begin
            if rank == last_rank:
                stats["last_arriver_count"] += 1

    total_lateness = sum(s["lateness_total_s"] for s in per_rank.values())
    for stats in per_rank.values():
        n = max(stats["arrivals"], 1)
        stats["lateness_mean_s"] = round(stats["lateness_total_s"] / n, 6)
        stats["lateness_share"] = round(
            stats["lateness_total_s"] / total_lateness, 4
        ) if total_lateness > 0 else 0.0
        stats["lateness_total_s"] = round(stats["lateness_total_s"], 6)
        stats["wait_total_s"] = round(stats["wait_total_s"], 6)
    order = sorted(per_rank, key=lambda r: per_rank[r]["lateness_total_s"],
                   reverse=True)
    worst.sort(key=lambda w: w["skew_s"], reverse=True)
    return {
        "collectives_total": len(arrivals),
        "collectives_analyzed": analyzed,
        "collectives_recovery_affected": affected,
        "recovery_windows": [[round(s, 6), round(e, 6)] for s, e in windows],
        "clock_max_err_s": round(job.max_clock_err(), 6),
        "per_rank": {str(r): per_rank[r] for r in sorted(per_rank)},
        "top_stragglers": [
            {"rank": r, **per_rank[r]} for r in order[:max(top_k, 0)]
        ],
        "worst_skews": worst[:max(top_k, 0)],
    }


# -- persistence -------------------------------------------------------------

def fold_into_telemetry(obs_dir: str, report: dict,
                        job_key: str = "") -> str | None:
    """Write the straggler aggregates back into the (job's) telemetry
    file under a ``stragglers`` key (atomic rewrite).  Returns the path,
    or None when there is no telemetry file to fold into."""
    path = os.path.join(obs_dir, telemetry_name(job_key))
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as exc:
        raise TraceError(f"cannot fold into "
                         f"{os.path.basename(path)}: {exc!r}") from exc
    doc["stragglers"] = report
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def export_job(obs_dir: str, out_path: str | None = None,
               fold: bool = True, top_k: int = 3,
               job_key: str = "") -> tuple[dict, str, dict]:
    """The one-call export path (``torch_trace_tool.py export``): load, merge, build, self-validate, write, and fold the
    straggler aggregates back into the (job's) telemetry file.  Returns
    ``(trace_doc, written_path, straggler_report)``."""
    job = load_job(obs_dir, job_key=job_key)
    doc = build_chrome_trace(job)
    errs = validate_chrome_trace(doc)
    if errs:
        raise TraceError("export produced an invalid trace: "
                         + "; ".join(errs[:5]))
    out_path = out_path or os.path.join(
        obs_dir, f"trace-{job_key}.json" if job_key else "trace.json")
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
    os.replace(tmp, out_path)
    report = straggler_report(job, top_k=top_k)
    if fold:
        fold_into_telemetry(obs_dir, report, job_key=job_key)
    return doc, out_path, report


def export_follow(obs_dir: str, out_path: str | None = None,
                  interval: float = 1.0, fold: bool = True, top_k: int = 3,
                  job_key: str = "", max_rounds: int | None = None,
                  should_stop=None,
                  on_round=None) -> tuple[dict, str, dict, int]:
    """Tail mode: re-export the trace every ``interval`` seconds while the
    job is still running (``torch_trace_tool.py export --follow``).

    Each round merges whatever spill dumps exist so far
    (``rabit_obs_spill_sec`` makes the flight rings land on disk mid-run)
    and atomically rewrites ``out_path`` — so at EVERY instant the output
    is a complete, validated Perfetto document that simply grows between
    rounds; a reader never sees a torn file.  Dumps that are mid-write or
    just evicted are skipped (``tolerant`` load), not fatal.

    Stops when the job's telemetry file appears (the tracker writes it at
    shutdown) — then runs one final *strict* :func:`export_job` so the
    finished artifact gets the full validation + straggler fold — or after
    ``max_rounds`` rounds (final pass stays tolerant and unfolded, the job
    is still live).  ``should_stop()`` and ``on_round(round, doc)`` are
    hooks for tests and callers.  Returns ``(doc, out_path, report, rounds)``."""
    out_path = out_path or os.path.join(
        obs_dir, f"trace-{job_key}.json" if job_key else "trace.json")
    tele_path = os.path.join(obs_dir, telemetry_name(job_key))
    rounds = 0
    while True:
        final_key = job_key
        finished = os.path.exists(tele_path)
        if not finished and not job_key:
            # Multi-tenant dirs never produce the bare legacy name: a
            # service job lands as telemetry-<job>.json, so a bare-key
            # follow adopts the first finished job's key and finalizes
            # against it (as ``export --job`` would).
            jobs = discover_telemetry_jobs(obs_dir)
            if jobs:
                final_key, finished = jobs[0], True
        if finished:
            doc, out_path, report = export_job(
                obs_dir, out_path, fold=fold, top_k=top_k,
                job_key=final_key)
            return doc, out_path, report, rounds + 1
        job = load_job(obs_dir, job_key=job_key, tolerant=True)
        doc = build_chrome_trace(job)
        errs = validate_chrome_trace(doc)
        if errs:
            raise TraceError("follow export produced an invalid trace: "
                             + "; ".join(errs[:5]))
        tmp = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, out_path)
        rounds += 1
        if on_round is not None:
            on_round(rounds, doc)
        if max_rounds is not None and rounds >= max_rounds:
            return doc, out_path, straggler_report(job, top_k=top_k), rounds
        if should_stop is not None and should_stop():
            return doc, out_path, straggler_report(job, top_k=top_k), rounds
        time.sleep(max(interval, 0.05))
