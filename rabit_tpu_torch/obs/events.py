"""Flight recorder: a bounded ring buffer of structured events.

The port's own copy of ``rabit_tpu/obs/events.py``.  Every rank keeps its
last N events (collective begin and end with cache key and bytes, engine
lifecycle, checkpoint commits, recovery phases) in memory and dumps them
as JSONL when something goes wrong: a hang, a SIGTERM, an explicit
request.  The dump format is the JAX package's, line for line, so a dump
written by either package loads in the other.

Events are flat JSON objects, ``{"ts": ..., "kind": ..., <fields>}``, one
a line in a dump.  ``ts`` is ``time.time()``, the clock of the launcher's
death stamps and the robust engine's ``failure_detected at=`` prints.
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable

#: Default ring capacity (events); override with rabit_obs_capacity.
DEFAULT_CAPACITY = 2048

#: Keys reserved by the envelope — event fields must not collide.
_RESERVED = ("ts", "kind")


#: The event-kind registry: every ``kind`` of ``rabit_tpu``'s registry
#: (``rabit_tpu/obs/events.py`` ``KINDS``) that a plane of the port can
#: record, with the same one-line meaning (the service plane's kinds wait
#: for its port).  A kind is added here in the change that adds its
#: producer.
KINDS: dict[str, str] = {
    # envelope / ring
    "flight_dump": "dump header line: pid, rank, reason, n_events, dropped",
    # collective spans (obs.collective; paired into trace spans)
    "op_begin": "collective entered: op, nbytes, cache_key, version, seqno",
    "op_end": "collective completed: adds seconds; pairs with op_begin",
    "op_inflight": "dump-time marker: op stuck in flight, stuck_seconds",
    # engine lifecycle (api.py / engine bridge)
    "engine_ready": "init() complete: engine class, rank, world",
    "engine_init": "native bridge entering RabitInit",
    "bootstrap_done": "(re)bootstrap complete: rank, world, attempt, seconds",
    "engine_shutdown": "native bridge entering RabitFinalize",
    "engine_finalize": "rabit_tpu.finalize() reached (pre-shutdown)",
    "engine_error": "native call failed: what, error (pre-exception)",
    "init_after_exception": "robust re-init after a caught exception",
    # compression (compress)
    "compress_policy": "codec policy resolved at init: allreduce codec, "
                       "min_bytes, checkpoint codec, deflate stage",
    "recovery_blob_compressed": "disk-resume blob served over the wire "
                                "zlib-compressed: raw, wire, version",
    # checkpoint line (api.py / native bridge)
    "checkpoint_commit": "version bump committed: version, nbytes",
    "checkpoint_loaded": "bridge served a peer-recovered blob: version",
    "load_checkpoint": "api load_checkpoint returned: version, recovered",
    "version_bump": "native checkpoint committed: version",
    # hang watchdog (obs.__init__)
    "hang_detected": "collective stuck past rabit_obs_hang_sec",
    "hang_recovered": "declared-hung op completed; lease renewals resume",
    "hang_abort": "dump-then-die escalation firing (exit 11)",
    # the stats-line bridge (event_from_stats_line) and the tracker
    "recover_stats": "robust engine per-recovery counters (from prints)",
    "recover_stats_final": "robust engine shutdown-time counters",
    "failure_detected": "robust engine noticed a dead peer: at=",
    "worker_recovered": "workload's recovered_at= stamp (in-job recovery)",
    "disk_resume": "workload resumed from durable spill: version",
    # tracker telemetry (tracker.py)
    "wave": "bootstrap/recovery wave assigned: epoch, assignments",
    "wave_purged": "dead pending connections dropped at wave fill",
    "lease_expired": "heartbeat lease lapsed: task_id, rank, overdue",
    "snapshot_rejected": "CMD_METRICS snapshot with out-of-range rank",
    "metrics_snapshot": "CMD_METRICS snapshot accepted: rank, task_id",
    # the live telemetry plane (obs.stream)
    "obs_scrape": "first CMD_OBS scrape served this tracker lifetime "
                  "(per-scrape counts live in serve_stats.obs_scrapes)",
    "metrics_delta_folded": "first streamed metric delta folded for a "
                            "rank: rank (per-delta counts live in the "
                            "rollup's n_folds)",
    "obs_evicted": "flight-dump retention removed oldest dumps: n, "
                   "max_files (rabit_obs_max_files)",
    # elastic worlds (elastic)
    "spare_parked": "hot spare checked in and parked: task_id, blob_version",
    "spare_dropped": "parked spare hung up; removed from the pool",
    "spare_promoted": "spare filled a dead rank's slot: task_id, rank, epoch",
    "world_shrunk": "wave closed below the previous world: from, to, lost",
    "world_grown": "wave closed above the previous world: from, to, joined",
    "bootstrap_blob": "tracker cached a spare bootstrap blob: version, nbytes",
    "epoch_changed": "worker adopted a new world epoch: epoch, world",
    "shard_rebalanced": "shard-rebalance callbacks ran for a resize",
    # quorum rounds (quorum)
    "quorum_policy": "quorum policy resolved at init: spec, wait_sec, "
                     "flag_after",
    "quorum_met": "round decided with exclusions: epoch, version, k, "
                  "world, n_have, excluded",
    "contribution_late": "an excluded round's block was delivered: "
                         "src_version, rank",
    "correction_folded": "a late block folded into a later round: "
                         "version, src_version, rank",
    "correction_dropped": "epoch boundary dropped an undelivered "
                          "correction: src_version, rank, world",
    # the bounded print log
    "messages_dropped": "the bounded worker-print log overflowed: cap "
                        "(total drops in telemetry.json)",
    # the HA control plane (ha)
    "journal_snapshot": "journal compacted to one snapshot record: n, "
                        "nbytes",
    "journal_gap": "journal replay hit a torn/divergent stretch "
                   "(truncated or healed from a snapshot): error",
    "standby_synced": "standby replayed to a consistent state: epoch, "
                      "world",
    "tracker_failover": "standby promoted itself over the dead primary: "
                        "standby, epoch, world, synced",
    # serving at scale (the tracker's reactor and the relay tier)
    "relay_up": "a relay's persistent CMD_BATCH channel registered: "
                "relay, host",
    "relay_lost": "a relay channel died (stateless fan-in: children "
                  "reconnect): relay",
    "batch_folded": "one coalesced relay envelope folded: relay, n "
                    "sub-messages",
    "blob_cache_evicted": "a relay's digest-keyed snapshot cache dropped "
                          "an entry: digest, nbytes, reason "
                          "(lru|superseded|job_retired)",
    # the delivery plane (delivery)
    "snapshot_published": "a checkpoint commit registered as a "
                          "content-addressed snapshot: version, epoch, "
                          "digest, size (journaled so a standby restores "
                          "the version line)",
    "snapshot_fetched": "first CMD_SNAP fetch of a digest served: "
                        "digest, nbytes (per-fetch byte counts stream as "
                        "delivery_bytes_served)",
    # collective schedules (sched)
    "schedule_planned": "tracker planned a wave's schedule: epoch, algo, "
                        "ring_order, n_avoided",
    "schedule_repaired": "plan rewritten around degraded links: epoch, "
                         "avoided, residual",
    "link_degraded": "worker slow_link report (from prints): src, dst, "
                     "wait, share",
    # the diagnosis plane (obs.diagnose)
    "incident_opened": "HealthMonitor opened an incident: incident, "
                       "class, + the subject fields (src/dst, rank, "
                       "relay...)",
    "incident_resolved": "an open incident went quiet past the "
                         "hysteresis bar: incident, class, + subject",
    "critical_path_folded": "trace_tool diagnose folded a critical-path "
                            "report into telemetry.json: rounds, links, "
                            "ranks",
}


@dataclass(frozen=True)
class Event:
    ts: float
    kind: str
    fields: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"ts": round(self.ts, 6), "kind": self.kind,
                           **self.fields}, sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "Event":
        obj = json.loads(line)
        ts = float(obj.pop("ts"))
        kind = str(obj.pop("kind"))
        return cls(ts, kind, obj)


class FlightRecorder:
    """Thread-safe bounded event ring.  ``record`` is cheap enough to call
    on every collective (a dict build + deque append under a lock); old
    events are evicted silently but counted (``dropped``)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._buf: deque[Event] = deque(maxlen=max(int(capacity), 1))
        self._dropped = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    @property
    def dropped(self) -> int:
        """Events evicted from the ring so far."""
        with self._lock:
            return self._dropped

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring, keeping the newest events."""
        capacity = max(int(capacity), 1)
        with self._lock:
            if capacity == self._buf.maxlen:
                return
            old = list(self._buf)
            self._dropped += max(len(old) - capacity, 0)
            self._buf = deque(old[-capacity:], maxlen=capacity)

    def record(self, kind: str, /, **fields) -> Event:
        for key in _RESERVED:
            if key in fields:
                raise ValueError(f"event field {key!r} is reserved")
        ev = Event(time.time(), kind, fields)
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(ev)
        return ev

    def snapshot(self) -> list[Event]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def dump(self, path: str | os.PathLike, header: dict | None = None) -> str:
        """Write the ring as JSONL (oldest first).  ``header`` fields land in
        a first ``kind="flight_dump"`` line (pid, rank, reason, ...)."""
        events = self.snapshot()
        meta = dict(header or {})
        meta.setdefault("pid", os.getpid())
        meta["n_events"] = len(events)
        meta["dropped"] = self.dropped
        buf = io.StringIO()
        buf.write(Event(time.time(), "flight_dump", meta).to_json() + "\n")
        for ev in events:
            buf.write(ev.to_json() + "\n")
        path = os.fspath(path)
        with open(path, "w") as f:
            f.write(buf.getvalue())
        return path


def load_dump(path: str | os.PathLike) -> list[Event]:
    """Read a JSONL dump back into events (header line included)."""
    with open(path) as f:
        return [Event.from_json(line) for line in f if line.strip()]


# -- stdout-line bridge ------------------------------------------------------
#
# The native robust engine's observability prints (``recover_stats``,
# ``recover_stats_final``, ``failure_detected``) reach the tracker as plain
# CMD_PRINT lines.  These converters are the bridge from that legacy line
# format into structured events: the tracker applies them on every print,
# so telemetry.json carries them and no consumer scrapes stdout.

def parse_stats_line(line: str) -> dict[str, str]:
    """Parse a ``key=value``-style line into a dict (one point of truth for
    the robust engine's stats-line format)."""
    return dict(p.split("=", 1) for p in line.split() if "=" in p)


def _line_rank(line: str) -> int:
    """Rank from the conventional ``[N] ...`` print prefix, -1 if absent."""
    line = line.lstrip()
    if line.startswith("["):
        head = line[1:line.find("]")] if "]" in line else ""
        try:
            return int(head)
        except ValueError:
            pass
    return -1


def event_from_stats_line(line: str, ts: float | None = None) -> Event | None:
    """Convert one worker observability print into a structured event, or
    None for ordinary prints.  Numeric fields are parsed to int/float; the
    emitting rank comes from the ``[N]`` prefix.

    Recognized: the robust engine's ``recover_stats`` /
    ``recover_stats_final`` / ``failure_detected`` lines, plus the recovery
    workloads' ``recovered_at=`` (in-job peer recovery complete) and
    ``resumed from disk`` (durable whole-job resume) stamps — so tools read
    ``LocalCluster.events`` / ``telemetry.json`` instead of scraping
    stdout."""
    if "recover_stats_final" in line:
        kind = "recover_stats_final"
    elif "recover_stats " in line:
        kind = "recover_stats"
    elif "failure_detected" in line:
        kind = "failure_detected"
    elif "recovered_at=" in line:
        kind = "worker_recovered"
    elif "resumed from disk" in line:
        kind = "disk_resume"
    elif "slow_link " in line:
        # an executor indicting its incoming ring link: src=/dst= ranks,
        # wait=/share= evidence
        kind = "link_degraded"
    else:
        return None
    fields: dict = {"rank": _line_rank(line)}
    for key, raw in parse_stats_line(line).items():
        if key in _RESERVED:
            # a printed ts= stamp must not shadow the envelope's ts
            key = "at"
        try:
            fields[key] = int(raw)
        except ValueError:
            try:
                fields[key] = float(raw)
            except ValueError:
                fields[key] = raw
    if kind == "disk_resume" and "version" not in fields:
        m = re.search(r"at version (\d+)", line)
        if m:
            fields["version"] = int(m.group(1))
    return Event(time.time() if ts is None else ts, kind, fields)


def events_from_lines(lines: Iterable[str]) -> list[Event]:
    """Batch form of :func:`event_from_stats_line` (skips ordinary lines)."""
    out = []
    for line in lines:
        ev = event_from_stats_line(line)
        if ev is not None:
            out.append(ev)
    return out
