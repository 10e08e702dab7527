"""The diagnosis plane: live incident detection over the streamed telemetry.

The port's own copy of ``rabit_tpu/obs/diagnose.py``.  A
:class:`HealthMonitor` hangs off the tracker and, once a detection window,
evaluates a fixed rule set over the :class:`~rabit_tpu_torch.obs.stream.
StreamRollup`'s per-link ``link_wait_seconds{src,dst}`` histograms and the
control plane's events, and opens and resolves :class:`IncidentReport` s
with the evidence that fired them.

Two wait-shape rules tell a degraded link from a compute straggler; both
show as ring wait, with opposite shapes:

* a **degraded link** (src, dst) delays every frame crossing it.  In the
  first rounds its dst takes by far the most wait, so a window's wait
  concentrates on one link; in steady state the delay circulates (the late
  dst asks late next round, and charges the wait to its own downstream
  link), so the cumulative link waits even out around the ring.  The
  worker's own in-round report (its ``slow_link`` print, a
  ``link_degraded`` event, measured against its own round before the
  rotation smears anything) is then the attribution, and the sustained
  window wait the evidence the hysteresis counts;
* a **compute straggler** r delays at the same rank every round, so every
  other rank waits about once a round on its own incoming link while r's
  incoming frames are long queued: the wait spreads evenly with a
  near-zero hole at r's incoming link, and the hole names the rank.

Hysteresis: a rule must fire ``rabit_diag_open_windows`` windows in a row
before an incident opens, and stay quiet ``rabit_diag_resolve_windows``
windows before it resolves.  A confirmed ``degraded-link`` incident feeds
the tracker's avoid-set repair (``Tracker.flag_link``).  The lost-relay
rule reads the tracker's ``relay_lost`` / ``relay_up`` events: a relay
whose channel stays down opens an incident, and its reconnect resolves it.
Everything here is dict math over state the caller assembled: no IO, no
sockets.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from rabit_tpu_torch.config import Config

#: Incident exposition schema (bump on incompatible change).
DIAG_SCHEMA = 1

#: Every incident class this engine can open, with the rule in one line.
INCIDENT_CLASSES: dict[str, str] = {
    "degraded-link": "one planned-ring link holds a dominant share of the "
                     "window's link wait (concentration shape), or a "
                     "worker self-report attributes the sustained wait "
                     "to its incoming link (steady-state rotation shape)",
    "compute-straggler": "window link wait is spread across the ring with "
                         "a near-zero hole at one rank's incoming link "
                         "(the hole names the late-entering rank)",
    "lost-relay": "a relay's persistent batch channel died and stayed "
                  "down (relay_lost without a matching relay_up)",
    "tracker-saturation": "the bounded worker-print log is actively "
                          "dropping messages (messages_dropped growing)",
    "preemption-storm": "several heartbeat leases expired within the "
                        "recent windows (mass preemption, not one death)",
}

#: The degraded-link rule's second gate: the top link must also dominate
#: the runner-up by this factor, so a 2-link world's naturally ~50/50
#: clean split can never cross the share threshold alone.
DOMINANCE = 2.0

#: Evidence entries kept per incident / resolved incidents kept.
EVIDENCE_CAP = 8
HISTORY_CAP = 16


@dataclass
class IncidentReport:
    """One open (or resolved) incident: class, the subject it names, and
    the capped evidence chain of window observations that fired it."""

    incident_id: str
    cls: str
    subject: dict
    opened_ts: float
    windows: int = 0                 # windows of supporting evidence seen
    resolved_ts: float | None = None
    evidence: list[dict] = field(default_factory=list)

    def add_evidence(self, obs: dict) -> None:
        self.windows += 1
        self.evidence.append(obs)
        if len(self.evidence) > EVIDENCE_CAP:
            del self.evidence[0]

    def to_doc(self) -> dict:
        doc = {
            "id": self.incident_id,
            "class": self.cls,
            "subject": dict(self.subject),
            "opened_ts": round(self.opened_ts, 6),
            "windows": self.windows,
            "evidence": [dict(e) for e in self.evidence],
        }
        if self.resolved_ts is not None:
            doc["resolved_ts"] = round(self.resolved_ts, 6)
        return doc


def _rank_of(label: str | int):
    """Rollup link labels are strings; incidents name integer ranks when
    they can (a non-numeric label passes through verbatim)."""
    try:
        return int(label)
    except (TypeError, ValueError):
        return label


class HealthMonitor:
    """The detection-rule engine.  One per tracker/partition; the owner
    calls :meth:`observe` once per detection window from its monitor
    thread and :meth:`render` from scrape/telemetry assembly.  All state
    lives behind one leaf lock (nothing is called while it is held)."""

    def __init__(self, cfg: Config | None = None):
        cfg = cfg or Config()
        self.enabled = cfg.get_bool("rabit_diag_enable", True)
        self.window_sec = float(cfg.get("rabit_diag_window_sec", "0.5")
                                or "0.5")
        self.open_windows = max(cfg.get_int("rabit_diag_open_windows", 2), 1)
        self.resolve_windows = max(
            cfg.get_int("rabit_diag_resolve_windows", 4), 1)
        self.min_wait_sec = float(cfg.get("rabit_diag_min_wait_sec", "0.05")
                                  or "0.05")
        self.link_share = float(cfg.get("rabit_diag_link_share", "0.5")
                                or "0.5")
        self.hole_ratio = float(cfg.get("rabit_diag_hole_ratio", "0.25")
                                or "0.25")
        self.storm_leases = max(cfg.get_int("rabit_diag_storm_leases", 3), 1)
        self._lock = threading.Lock()
        # previous window's cumulative link table / fold count / drops
        self._prev_links: dict[tuple, tuple[int, float]] = {}
        self._prev_folds = 0
        self._prev_dropped = 0
        # rolling per-window severities for the burst-shaped rules
        self._expiry_windows: list[int] = []
        self._drop_windows: list[int] = []
        self._relays_down: set[str] = set()
        # worker self-report attribution: (src, dst) -> the strongest
        # link_degraded report seen while the wait symptom persists
        self._attributed: dict[tuple[str, str], dict] = {}
        # hysteresis state, keyed by (class, subject-key)
        self._streak: dict[tuple, int] = {}
        self._quiet: dict[tuple, int] = {}
        self._open: dict[tuple, IncidentReport] = {}
        self._history: list[IncidentReport] = []
        self._seq = 0
        self.n_opened = 0
        self.n_resolved = 0

    # -- rule evaluation (pure dict math) ---------------------------------

    @staticmethod
    def _link_table(stream_doc: dict) -> dict[tuple, tuple[int, float]]:
        """Cumulative (count, wait-sum) per (src, dst) from a rendered
        rollup's ``links`` rows."""
        table: dict[tuple, tuple[int, float]] = {}
        for row in stream_doc.get("links", ()):
            key = (str(row.get("src")), str(row.get("dst")))
            table[key] = (int(row.get("count", 0)),
                          float(row.get("sum", 0.0)))
        return table

    def _wait_candidates(self, ts: float, links: dict) -> list[tuple]:
        """The two wait-shape rules over one window's link-wait deltas.
        Returns at most one ``(class, subject_key, subject, evidence)``
        candidate — concentration beats the hole check, so a fault that
        produces both shapes is one incident, not two."""
        window: dict[tuple, tuple[int, float]] = {}
        for key, (count, wsum) in links.items():
            pc, ps = self._prev_links.get(key, (0, 0.0))
            dc, dw = count - pc, wsum - ps
            if dc > 0:
                window[key] = (dc, max(dw, 0.0))
        total = sum(dw for _dc, dw in window.values())
        if not window or total < self.min_wait_sec:
            # The wait symptom is gone: any standing self-report
            # attribution is stale (the link healed or was repaired).
            self._attributed.clear()
            return []
        rows = sorted(window.items(), key=lambda kv: -kv[1][1])
        (top_key, (top_n, top_w)) = rows[0]
        second_w = rows[1][1][1] if len(rows) > 1 else 0.0
        share = top_w / total
        if share >= self.link_share and top_w >= DOMINANCE * second_w:
            src, dst = top_key
            ev = {"ts": round(ts, 6), "rule": "link-wait-concentration",
                  "window_wait_s": round(total, 6),
                  "link_wait_s": round(top_w, 6),
                  "share": round(share, 4), "n_links": len(window),
                  "n_waits": top_n}
            subject = {"src": _rank_of(src), "dst": _rank_of(dst)}
            return [("degraded-link", ("link", src, dst), subject, ev)]
        if len(window) >= 3:
            (low_key, (_low_n, low_w)) = rows[-1]
            mean = total / len(window)
            if low_w <= self.hole_ratio * mean:
                rank = low_key[1]  # dst of the hole link entered late
                ev = {"ts": round(ts, 6), "rule": "link-wait-hole",
                      "window_wait_s": round(total, 6),
                      "hole_link": [_rank_of(low_key[0]), _rank_of(rank)],
                      "hole_wait_s": round(low_w, 6),
                      "mean_link_wait_s": round(mean, 6),
                      "n_links": len(window)}
                subject = {"rank": _rank_of(rank)}
                return [("compute-straggler", ("rank", rank), subject, ev)]
        if self._attributed:
            # Steady-state degraded link: the delay bubble circulates and
            # the cumulative sums equalize (see module docstring), so the
            # worker's in-round self-report names the link and the
            # sustained window wait carries the streak.  The strongest
            # report wins, so one fault is one incident.
            (src, dst), rep = max(self._attributed.items(),
                                  key=lambda kv: kv[1]["share"])
            ev = {"ts": round(ts, 6), "rule": "link-wait-attributed",
                  "window_wait_s": round(total, 6),
                  "reported_share": round(rep["share"], 4),
                  "reported_wait_s": round(rep["wait"], 6),
                  "n_links": len(window)}
            subject = {"src": _rank_of(src), "dst": _rank_of(dst)}
            return [("degraded-link", ("link", src, dst), subject, ev)]
        return []

    def _state_candidates(self, ts: float, state: dict) -> list[tuple]:
        """Control-plane rules over the tracker-assembled window state:
        relay losses, print-log drops, lease-expiry bursts."""
        out: list[tuple] = []
        for ev in state.get("events_delta", ()):
            kind = ev.get("kind")
            if kind == "relay_lost" and "relay" in ev:
                self._relays_down.add(str(ev["relay"]))
            elif kind == "relay_up" and "relay" in ev:
                self._relays_down.discard(str(ev["relay"]))
        for relay in sorted(self._relays_down):
            out.append(("lost-relay", ("relay", relay), {"relay": relay},
                        {"ts": round(ts, 6), "rule": "relay-channel-down",
                         "relay": relay}))
        dropped = int(state.get("messages_dropped", 0))
        self._drop_windows.append(max(dropped - self._prev_dropped, 0))
        self._prev_dropped = dropped
        del self._drop_windows[:-max(self.open_windows, 2)]
        drops = sum(self._drop_windows)
        if drops > 0:
            out.append(("tracker-saturation", ("saturation",),
                        {"dropped": dropped},
                        {"ts": round(ts, 6), "rule": "print-log-dropping",
                         "recent_drops": drops, "total_dropped": dropped}))
        expired = [ev for ev in state.get("events_delta", ())
                   if ev.get("kind") == "lease_expired"]
        self._expiry_windows.append(len(expired))
        del self._expiry_windows[:-max(self.open_windows, 2)]
        burst = sum(self._expiry_windows)
        if burst >= self.storm_leases:
            out.append(("preemption-storm", ("storm",),
                        {"n_expired": burst},
                        {"ts": round(ts, 6), "rule": "lease-expiry-burst",
                         "n_expired": burst,
                         "tasks": sorted(str(ev.get("task_id", "?"))
                                         for ev in expired)}))
        return out

    # -- the window tick ---------------------------------------------------

    def observe(self, now: float, stream_doc: dict,
                state: dict) -> tuple[list[IncidentReport],
                                      list[IncidentReport]]:
        """Evaluate one detection window.  ``stream_doc`` is a rendered
        rollup (:meth:`StreamRollup.render`), ``state`` the owner's small
        window-state dict (``events_delta``, ``messages_dropped``, ...).
        Returns ``(opened, resolved)`` incident lists; the caller emits
        the events and feeds the repair hook."""
        if not self.enabled:
            return [], []
        ts = time.time()
        with self._lock:
            for ev in state.get("events_delta", ()):
                # Worker degraded-link self-reports attribute the wait
                # shape (quorum-sourced flags name a straggler RANK and
                # already carry their own round-count hysteresis, and
                # origin-stamped reports are operator decisions that
                # flag the link directly with synthetic evidence — they
                # are not link-fault attribution).
                if ev.get("kind") == "link_degraded" \
                        and ev.get("via") != "quorum" \
                        and not ev.get("origin") \
                        and "src" in ev and "dst" in ev:
                    key = (str(ev["src"]), str(ev["dst"]))
                    rep = {"share": float(ev.get("share", 0.0) or 0.0),
                           "wait": float(ev.get("wait", 0.0) or 0.0)}
                    old = self._attributed.get(key)
                    if old is None or rep["share"] >= old["share"]:
                        self._attributed[key] = rep
            folds = int(stream_doc.get("n_folds", 0))
            links = self._link_table(stream_doc)
            fresh_folds = folds != self._prev_folds
            candidates: list[tuple] = []
            if fresh_folds:
                # No new folds means no wait evidence either way: the
                # wait-shape streaks freeze instead of decaying, so a
                # heartbeat hiccup cannot flap an open incident.
                candidates += self._wait_candidates(ts, links)
                self._prev_links = links
                self._prev_folds = folds
            candidates += self._state_candidates(ts, state)
            fired = {key: (cls, subject, ev)
                     for cls, key, subject, ev in candidates}
            opened: list[IncidentReport] = []
            resolved: list[IncidentReport] = []
            for key, (cls, subject, ev) in fired.items():
                self._streak[key] = self._streak.get(key, 0) + 1
                self._quiet.pop(key, None)
                inc = self._open.get(key)
                if inc is not None:
                    inc.add_evidence(ev)
                elif self._streak[key] >= self.open_windows:
                    self._seq += 1
                    inc = IncidentReport(
                        incident_id=f"{cls}#{self._seq}", cls=cls,
                        subject=subject, opened_ts=ts)
                    inc.windows = self._streak[key] - 1
                    inc.add_evidence(ev)
                    self._open[key] = inc
                    self.n_opened += 1
                    opened.append(inc)
            wait_frozen = not fresh_folds
            for key in list(self._streak):
                if key in fired:
                    continue
                if wait_frozen and key[0] in ("link", "rank"):
                    continue  # no evidence either way this window
                if key in self._open:
                    self._quiet[key] = self._quiet.get(key, 0) + 1
                    if self._quiet[key] >= self.resolve_windows:
                        inc = self._open.pop(key)
                        inc.resolved_ts = ts
                        self._history.append(inc)
                        del self._history[:-HISTORY_CAP]
                        self._streak.pop(key, None)
                        self._quiet.pop(key, None)
                        self.n_resolved += 1
                        resolved.append(inc)
                else:
                    self._streak.pop(key, None)
            return opened, resolved

    # -- exposition --------------------------------------------------------

    def open_incidents(self) -> list[IncidentReport]:
        with self._lock:
            return sorted(self._open.values(), key=lambda i: i.opened_ts)

    def render(self) -> dict:
        """The ``incidents`` section a scrape/telemetry document embeds:
        open incidents (oldest first), a capped resolved history, and the
        lifetime counters."""
        with self._lock:
            return {
                "schema": DIAG_SCHEMA,
                "enabled": self.enabled,
                "window_sec": self.window_sec,
                "n_opened": self.n_opened,
                "n_resolved": self.n_resolved,
                "open": [i.to_doc() for i in sorted(
                    self._open.values(), key=lambda i: i.opened_ts)],
                "recent": [i.to_doc() for i in self._history],
            }
